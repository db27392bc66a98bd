// K1 — shingle embedding, written for Hopper (sm_90a).
//
// Replaces: fandom_search_tpu/ops/embed.py, _embed_kernel_t (launched by
// embed_shingles_pallas_t).  Computes, bit-exactly,
//   e[m, l] = sum_{p<n} (1 - 2 * bit31(tok[m+p] * mult[p, l] mod 2^32))
// as int8 [M, dim], M = T - n + 1 — the row-major layout of the host
// oracle (data/shingler.py embed_shingles_np) and K2's query operand.
//
// Bound on this card: the bytes written, M * dim int8 (128 MB for 2^20
// shingles at dim 128).  The reads are 4 B per token and every token is
// reused by n rows, so they are served from L1/L2.
//
// Design: one thread per (row, 16-lane group) accumulates 16 lanes in
// registers and writes them with one 16-byte store, so a warp writes
// 512 contiguous bytes.  The multiplier table (n * dim * 4 B) is staged
// once per block in shared memory.  The TPU kernel's lane-major
// [dim, M] layout and its (1, TM) stream views are not carried over.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 16;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t pack4(const int* v) {
  return (static_cast<uint32_t>(static_cast<uint8_t>(v[0]))) |
         (static_cast<uint32_t>(static_cast<uint8_t>(v[1])) << 8) |
         (static_cast<uint32_t>(static_cast<uint8_t>(v[2])) << 16) |
         (static_cast<uint32_t>(static_cast<uint8_t>(v[3])) << 24);
}

__global__ void __launch_bounds__(kThreads)
embed_kernel(const uint32_t* __restrict__ tokens,
             const uint32_t* __restrict__ mults,  // [n, dim]
             int8_t* __restrict__ out,            // [m, dim]
             long long m, int n, int dim) {
  extern __shared__ uint32_t smult[];  // [n * dim]
  for (int i = threadIdx.x; i < n * dim; i += blockDim.x) smult[i] = mults[i];
  __syncthreads();

  const int groups = dim / kLanes;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= m * groups) return;
  const long long row = t / groups;
  const int g = static_cast<int>(t - row * groups);

  int acc[kLanes];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) acc[l] = 0;
  for (int p = 0; p < n; ++p) {
    const uint32_t tok = __ldg(tokens + row + p);
    const uint32_t* mp = smult + p * dim + g * kLanes;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      const uint32_t prod = tok * mp[l];  // wraps mod 2^32
      acc[l] += (prod >> 31) ? -1 : 1;
    }
  }
  uint4 w;
  w.x = pack4(acc + 0);
  w.y = pack4(acc + 4);
  w.z = pack4(acc + 8);
  w.w = pack4(acc + 12);
  reinterpret_cast<uint4*>(out + row * dim)[g] = w;
}

}  // namespace

// tokens uint32 [m + n - 1], mults uint32 [n, dim], out int8 [m, dim]
// (16-byte aligned).  dim % 16 == 0 and n * dim * 4 <= 48 KB are checked
// by the Python wrapper.
extern "C" int fs_embed(const void* tokens, const void* mults, void* out,
                        long long m, int n, int dim, void* stream) {
  const long long threads = m * (dim / kLanes);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(n) * dim * sizeof(uint32_t);
  embed_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tokens), static_cast<const uint32_t*>(mults),
      static_cast<int8_t*>(out), m, n, dim);
  return static_cast<int>(cudaGetLastError());
}
