// K4 — word-level Smith-Waterman with a linear gap, normalized, written
// for Hopper (sm_90a).
//
// Replaces: fandom_search_tpu/ops/smith_waterman.py, _sw_kernel_wide
// (variant "wide", launched by _sw_pallas_call / sw_normalized_pallas).
// For each pair it computes
//   H[i][j] = max(0, H[i-1][j-1] + (a_i == b_j ? match : mismatch),
//                 max(H[i-1][j], H[i][j-1]) + gap)
// over i < len_a, j < len_b (H = 0 outside) and returns
// max H / (match * max(1, min(len_a, len_b))) in f32.  Every cell uses
// the same f32 operations as _sw_best_jnp, so the result is bit-exact
// whatever the traversal order.
//
// Bound on this card: the dependent chain of DP cells, len_a * len_b
// per pair (at most 64 x 64), about 6 instructions each; the bytes read
// (512 B per pair) are small beside it.
//
// Design: one thread per pair walks the rows i in order and keeps the
// DP row (up to 64 cells) in registers — the j loop is unrolled so the
// array never leaves them.  The block's b tokens are staged in shared
// memory, one padded column per thread (conflict-free reads).  The
// engine length-sorts the pairs before the call, so the threads of a
// warp stop at similar len_a and len_b.  The TPU kernel's anti-diagonal
// wavefront and its batch-on-lanes transpose are not carried over.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLB = 64;       // widest b segment held in registers
constexpr int kThreads = 64;  // pairs per block

__global__ void __launch_bounds__(kThreads)
sw_kernel(const uint32_t* __restrict__ a,    // [bsz, la]
          const uint32_t* __restrict__ b,    // [bsz, lb], lb <= kLB
          const int* __restrict__ len_a,     // [bsz]
          const int* __restrict__ len_b,     // [bsz]
          float* __restrict__ out,           // [bsz]
          long long bsz, int la, int lb, float match, float mismatch, float gap) {
  __shared__ uint32_t sb[kLB][kThreads + 1];
  const long long pair0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int npairs = static_cast<int>(min(static_cast<long long>(kThreads), bsz - pair0));
  for (int e = threadIdx.x; e < npairs * lb; e += kThreads) {
    const int p = e / lb;
    const int j = e - p * lb;
    sb[j][p] = b[(pair0 + p) * lb + j];
  }
  __syncthreads();
  if (threadIdx.x >= npairs) return;

  const long long pair = pair0 + threadIdx.x;
  const int raw_a = len_a[pair];
  const int raw_b = len_b[pair];
  const int na = max(0, min(raw_a, la));
  const int nb = max(0, min(raw_b, lb));
  const uint32_t* arow = a + pair * la;

  float h[kLB];
#pragma unroll
  for (int j = 0; j < kLB; ++j) h[j] = 0.f;
  float best = 0.f;
  for (int i = 0; i < na; ++i) {
    const uint32_t ai = __ldg(arow + i);
    float diag = 0.f;  // H[i-1][j-1]
    float left = 0.f;  // H[i][j-1]
#pragma unroll
    for (int j = 0; j < kLB; ++j) {
      if (j >= nb) break;
      const float up = h[j];  // H[i-1][j]
      const float sub = (ai == sb[j][threadIdx.x]) ? match : mismatch;
      const float v = fmaxf(fmaxf(diag + sub, fmaxf(left, up) + gap), 0.f);
      diag = up;
      h[j] = v;
      left = v;
      best = fmaxf(best, v);
    }
  }
  const float denom = match * static_cast<float>(max(1, min(raw_a, raw_b)));
  out[pair] = best / denom;
}

}  // namespace

// a uint32 [bsz, la], b uint32 [bsz, lb] with lb <= 64, len_a/len_b
// int32 [bsz], out f32 [bsz].
extern "C" int fs_sw(const void* a, const void* b, const void* len_a,
                     const void* len_b, void* out, long long bsz, int la, int lb,
                     float match, float mismatch, float gap, void* stream) {
  if (lb > kLB || lb < 0 || la < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (bsz + kThreads - 1) / kThreads;
  sw_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const int*>(len_a), static_cast<const int*>(len_b),
      static_cast<float*>(out), bsz, la, lb, match, mismatch, gap);
  return static_cast<int>(cudaGetLastError());
}
