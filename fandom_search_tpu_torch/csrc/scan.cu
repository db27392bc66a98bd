// K3 — inclusive int32 prefix scan ("add" = cumsum, "max" = cummax),
// written for Hopper (sm_90a).
//
// Replaces: fandom_search_tpu/ops/scan.py, _scan_kernel (launched by
// _scan_padded / scan1d_i32).  out[i] = x[0] op ... op x[i]; the add
// wraps mod 2^32 like an int32 cumsum.
//
// Bound on this card: the bytes moved, 4 B read and 4 B written per
// element on each of the two passes over the data (the engine scans
// 2^20-element masks and smaller).
//
// Design: the TPU kernel carries its running total from one sequential
// grid step to the next; CUDA blocks run in no order, so this is the
// three-launch scan: (1) each block scans a 1024-element chunk (4 per
// thread, warp shuffles, then one warp over the warp totals) and records
// the chunk total; (2) one block scans the chunk totals in place,
// carrying across 1024-total slices; (3) every chunk but the first
// combines its predecessor's inclusive total into its elements.  No
// size gate: the engine uses it at every size.  Decoupled look-back
// (one pass) is later work.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kChunk = kThreads * kItems;
constexpr int kWarps = kThreads / 32;

template <int OP>
__device__ __forceinline__ int ident() {
  return OP == 0 ? 0 : INT_MIN;
}

template <int OP>
__device__ __forceinline__ int combine(int a, int b) {
  if (OP == 0) {
    return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
  }
  return max(a, b);
}

// Scans in[base, min(base + kChunk, n)) into out with `carry` combined
// in front; returns carry op (chunk total) in every thread.  Called by
// all threads of the block.
template <int OP>
__device__ int scan_chunk(const int* in, int* out, long long base, long long n,
                          int carry) {
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long i0 = base + static_cast<long long>(threadIdx.x) * kItems;

  int v[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) v[i] = (i0 + i < n) ? in[i0 + i] : ident<OP>();
#pragma unroll
  for (int i = 1; i < kItems; ++i) v[i] = combine<OP>(v[i - 1], v[i]);

  int t = v[kItems - 1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, t, o);
    if (lane >= o) t = combine<OP>(u, t);
  }
  if (lane == 31) s_warp[warp] = t;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? s_warp[lane] : ident<OP>();
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = combine<OP>(u, w);
    }
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  const int incl = warp > 0 ? combine<OP>(s_warp[warp - 1], t) : t;
  int excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = warp > 0 ? s_warp[warp - 1] : ident<OP>();
  const int prefix = combine<OP>(carry, excl);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (i0 + i < n) out[i0 + i] = combine<OP>(prefix, v[i]);
  }
  const int total = combine<OP>(carry, s_warp[kWarps - 1]);
  __syncthreads();  // s_warp is reused by the next call
  return total;
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
scan_chunks(const int* __restrict__ x, int* __restrict__ out,
            int* __restrict__ totals, long long n) {
  const int total = scan_chunk<OP>(x, out, static_cast<long long>(blockIdx.x) * kChunk,
                                   n, ident<OP>());
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
scan_totals(int* totals, long long nb) {
  int carry = ident<OP>();
  for (long long base = 0; base < nb; base += kChunk) {
    carry = scan_chunk<OP>(totals, totals, base, nb, carry);
  }
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
add_offsets(int* __restrict__ out, const int* __restrict__ totals, long long n) {
  const long long b = static_cast<long long>(blockIdx.x) + 1;  // chunk 0 is final
  const int off = totals[b - 1];
  const long long i0 = b * kChunk + static_cast<long long>(threadIdx.x) * kItems;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (i0 + i < n) out[i0 + i] = combine<OP>(off, out[i0 + i]);
  }
}

template <int OP>
void launch(const int* x, int* out, int* totals, long long n, cudaStream_t st) {
  const long long nb = (n + kChunk - 1) / kChunk;
  scan_chunks<OP><<<static_cast<unsigned>(nb), kThreads, 0, st>>>(x, out, totals, n);
  if (nb > 1) {
    scan_totals<OP><<<1, kThreads, 0, st>>>(totals, nb);
    add_offsets<OP><<<static_cast<unsigned>(nb - 1), kThreads, 0, st>>>(out, totals, n);
  }
}

}  // namespace

// x, out int32 [n] (n >= 1), totals int32 scratch [ceil(n / 1024)];
// op 0 = add, 1 = max.
extern "C" int fs_scan(const void* x, void* out, void* totals, long long n, int op,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* xi = static_cast<const int*>(x);
  int* oi = static_cast<int*>(out);
  int* ti = static_cast<int*>(totals);
  if (op == 0) {
    launch<0>(xi, oi, ti, n, st);
  } else if (op == 1) {
    launch<1>(xi, oi, ti, n, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
