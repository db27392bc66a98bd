// A throughput probe for Hopper's halfword DPX instructions, the ones K5's
// packed route runs (fandom_search_tpu_torch/csrc/smith_waterman_lane.cu).
// scripts/torch_sw_i16_ab.py builds it alone and prints the rate the card
// shows beside the 64 results a clock an SM at which chip_smoke.py prices
// the route; nothing in the engine calls it.
//
// Every thread runs kChains independent chains of `iters` DPX operations
// on 32-bit registers of two halfwords, so the SM's pipes, and not a
// chain's latency, set the pace; the result is folded into out[] so that
// the compiler keeps the work.  op 0 times __viaddmax_s16x2_relu (the
// packed cell's add, max and clamp), op 1 __vimax3_s16x2 (its running
// best).  Operations per launch: blocks * threads * iters * kChains.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;
constexpr int kThreads = 256;

template <int OP>
__global__ void __launch_bounds__(kThreads) dpx_probe_kernel(uint32_t* __restrict__ out, int iters,
                                                             uint32_t x, uint32_t y) {
  uint32_t acc[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) acc[k] = x + static_cast<uint32_t>(threadIdx.x + k);
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      if (OP == 0) {
        acc[k] = __viaddmax_s16x2_relu(acc[k], x, y);
      } else {
        acc[k] = __vimax3_s16x2(acc[k], x, y);
      }
    }
  }
  uint32_t r = 0;
#pragma unroll
  for (int k = 0; k < kChains; ++k) r ^= acc[k];
  out[static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x] = r;
}

}  // namespace

// out uint32 [blocks * 256]; op 0 or 1 (see above).
extern "C" int fs_dpx_probe(void* out, int blocks, int iters, int op, void* stream) {
  if (blocks <= 0 || iters <= 0 || (op != 0 && op != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* po = static_cast<uint32_t*>(out);
  if (op == 0) {
    dpx_probe_kernel<0><<<blocks, kThreads, 0, st>>>(po, iters, 0x00010001u, 0x00020003u);
  } else {
    dpx_probe_kernel<1><<<blocks, kThreads, 0, st>>>(po, iters, 0x00010001u, 0x00020003u);
  }
  return static_cast<int>(cudaGetLastError());
}
