// K5 — word-level Smith-Waterman with a linear gap, normalized, one warp
// per pair along the anti-diagonals, written for Hopper (sm_90a).
//
// Replaces: fandom_search_tpu/ops/smith_waterman.py, _sw_kernel (the
// lane-major variants "fast", "r2" and "dyn", launched by _sw_pallas_call /
// sw_normalized_pallas).  It computes the same function as K4
// (csrc/smith_waterman.cu): per pair,
//   H[i][j] = max(0, H[i-1][j-1] + (a_i == b_j ? match : mismatch),
//                 max(H[i-1][j], H[i][j-1]) + gap)
// over i < len_a, j < len_b (H = 0 outside), and returns
// max H / (match * max(1, min(len_a, len_b))) in f32.  Each cell takes
// _sw_best_jnp's f32 operations in its order, so the result is bit-exact
// with the plain version and with K4.
//
// Bound on this card: the dependent chain of len_a + len_b - 1
// anti-diagonals per pair, each a few shuffles and f32 operations deep;
// the bytes read (512 B per pair) are small beside it.
//
// Design: the TPU kernel lays one pair per row with j along the lanes and
// walks the anti-diagonals d; here one warp holds one pair, lane l owning
// cells j = 2l and 2l + 1 (b_j in registers, LB <= 64).  Cell (i = d - j,
// j) needs H_{d-1}[j-1], H_{d-1}[j] and H_{d-2}[j-1]: for j = 2l + 1 they
// sit in the same lane, for j = 2l two __shfl_up_sync bring them from lane
// l - 1.  a[d - j] is read directly (no rolling buffer), and each warp
// stops after its own pair's len_a + len_b - 1 diagonals.  Against K4's
// one thread per pair, this puts 32 times more threads in flight.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLB = 64;      // widest b segment: two cells per lane
constexpr int kWarps = 8;    // pairs per block, one warp each
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
sw_lane_kernel(const uint32_t* __restrict__ a,    // [bsz, la]
               const uint32_t* __restrict__ b,    // [bsz, lb], lb <= kLB
               const int* __restrict__ len_a,     // [bsz]
               const int* __restrict__ len_b,     // [bsz]
               float* __restrict__ out,           // [bsz]
               long long bsz, int la, int lb, float match, float mismatch, float gap) {
  const long long pair = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (pair >= bsz) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int raw_a = len_a[pair];
  const int raw_b = len_b[pair];
  const int na = max(0, min(raw_a, la));
  const int nb = max(0, min(raw_b, lb));
  const uint32_t* arow = a + pair * la;
  const int j0 = 2 * lane;
  const int j1 = j0 + 1;
  const uint32_t b0 = j0 < nb ? b[pair * lb + j0] : 0u;
  const uint32_t b1 = j1 < nb ? b[pair * lb + j1] : 0u;

  float p0 = 0.f, p1 = 0.f;    // H_{d-1}[j0], H_{d-1}[j1]
  float pp0 = 0.f, pp1 = 0.f;  // H_{d-2}[j0], H_{d-2}[j1]
  float best = 0.f;
  const int nd = (na > 0 && nb > 0) ? na + nb - 1 : 0;
  for (int d = 0; d < nd; ++d) {
    float left_p = __shfl_up_sync(kFull, p1, 1);    // H_{d-1}[j0 - 1]
    float left_pp = __shfl_up_sync(kFull, pp1, 1);  // H_{d-2}[j0 - 1]
    if (lane == 0) {
      left_p = 0.f;
      left_pp = 0.f;
    }
    const int i0 = d - j0;
    const int i1 = i0 - 1;
    const bool v0 = i0 >= 0 && i0 < na && j0 < nb;
    const bool v1 = i1 >= 0 && i1 < na && j1 < nb;
    const float s0 = (v0 && __ldg(arow + i0) == b0) ? match : mismatch;
    const float s1 = (v1 && __ldg(arow + i1) == b1) ? match : mismatch;
    float h0 = fmaxf(left_pp + s0, fmaxf(left_p, p0) + gap);
    float h1 = fmaxf(pp0 + s1, fmaxf(p0, p1) + gap);
    h0 = v0 ? fmaxf(h0, 0.f) : 0.f;
    h1 = v1 ? fmaxf(h1, 0.f) : 0.f;
    best = fmaxf(best, fmaxf(h0, h1));
    pp0 = p0;
    pp1 = p1;
    p0 = h0;
    p1 = h1;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) best = fmaxf(best, __shfl_xor_sync(kFull, best, o));
  if (lane == 0) {
    const float denom = match * static_cast<float>(max(1, min(raw_a, raw_b)));
    out[pair] = best / denom;
  }
}

}  // namespace

// a uint32 [bsz, la], b uint32 [bsz, lb] with lb <= 64, len_a/len_b
// int32 [bsz], out f32 [bsz].
extern "C" int fs_sw_lane(const void* a, const void* b, const void* len_a,
                          const void* len_b, void* out, long long bsz, int la, int lb,
                          float match, float mismatch, float gap, void* stream) {
  if (lb > kLB || lb < 0 || la < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (bsz + kWarps - 1) / kWarps;
  sw_lane_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const int*>(len_a), static_cast<const int*>(len_b),
      static_cast<float*>(out), bsz, la, lb, match, mismatch, gap);
  return static_cast<int>(cudaGetLastError());
}
