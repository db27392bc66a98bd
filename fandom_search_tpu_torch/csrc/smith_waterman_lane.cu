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
// cells j = 2l and 2l + 1 of a strip of 64 columns (b_j in registers).
// Cell (i = d - j, j) needs H_{d-1}[j-1], H_{d-1}[j] and H_{d-2}[j-1]: for
// j = 2l + 1 they sit in the same lane, for j = 2l two __shfl_up_sync bring
// them from lane l - 1.  a[d - j] is read directly (no rolling buffer), and
// each warp stops after its own pair's len_a + len_b - 1 diagonals.
// Against K4's first design (one thread per pair), this put 32 times more
// threads in flight.  Segments wider than 64 columns (LB > 64) run as
// strips of 64 in turn: lane 31 writes the strip's last column H[i][64 s +
// 63] to a scratch column in device memory, and lane 0 of the next strip
// reads H[i][64 s - 1] and H[i-1][64 s - 1] from it (two buffers,
// alternating by strip).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStrip = 64;   // columns a pass: two cells per lane
constexpr int kWarps = 8;    // pairs per block, one warp each
constexpr unsigned kFull = 0xffffffffu;

// STRIPS: lb > kStrip (strip passes); else one pass, with no scratch.
template <bool STRIPS>
__global__ void __launch_bounds__(kWarps * 32)
sw_lane_kernel(const uint32_t* __restrict__ a,    // [bsz, la]
               const uint32_t* __restrict__ b,    // [bsz, lb]
               const int* __restrict__ len_a,     // [bsz]
               const int* __restrict__ len_b,     // [bsz]
               float* __restrict__ out,           // [bsz]
               float* __restrict__ bnd,           // [bsz, 2, lmax] when STRIPS
               long long bsz, int la, int lb, int lmax, float match, float mismatch,
               float gap) {
  const long long pair = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (pair >= bsz) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int raw_a = len_a[pair];
  const int raw_b = len_b[pair];
  const int na = max(0, min(raw_a, la));
  const int nb = max(0, min(raw_b, lb));
  const uint32_t* arow = a + pair * la;
  const int nstrips = (na > 0 && nb > 0) ? (STRIPS ? (nb + kStrip - 1) / kStrip : 1) : 0;
  const int j0 = 2 * lane;  // local columns of this lane in a strip
  const int j1 = j0 + 1;

  float best = 0.f;
  for (int s = 0; s < nstrips; ++s) {
    const int sb = min(kStrip, nb - s * kStrip);  // columns of this strip
    const uint32_t* brow = b + pair * lb + s * kStrip;
    const uint32_t b0 = j0 < sb ? brow[j0] : 0u;
    const uint32_t b1 = j1 < sb ? brow[j1] : 0u;
    const float* rd = bnd + pair * 2 * lmax + ((s + 1) & 1) * lmax;  // strip s - 1's last column
    float* wr = bnd + pair * 2 * lmax + (s & 1) * lmax;
    const bool read_left = STRIPS && s > 0;
    const bool write_end = STRIPS && lane == 31 && s + 1 < nstrips;

    float p0 = 0.f, p1 = 0.f;    // H_{d-1}[j0], H_{d-1}[j1]
    float pp0 = 0.f, pp1 = 0.f;  // H_{d-2}[j0], H_{d-2}[j1]
    const int nd = na + sb - 1;
    for (int d = 0; d < nd; ++d) {
      float left_p = __shfl_up_sync(kFull, p1, 1);    // H_{d-1}[j0 - 1]
      float left_pp = __shfl_up_sync(kFull, pp1, 1);  // H_{d-2}[j0 - 1]
      if (lane == 0) {
        // column 64 s - 1: row d (H_{d-1}) and row d - 1 (H_{d-2})
        left_p = (read_left && d < na) ? rd[d] : 0.f;
        left_pp = (read_left && d >= 1 && d - 1 < na) ? rd[d - 1] : 0.f;
      }
      const int i0 = d - j0;
      const int i1 = i0 - 1;
      const bool v0 = i0 >= 0 && i0 < na && j0 < sb;
      const bool v1 = i1 >= 0 && i1 < na && j1 < sb;
      const float s0 = (v0 && __ldg(arow + i0) == b0) ? match : mismatch;
      const float s1 = (v1 && __ldg(arow + i1) == b1) ? match : mismatch;
      float h0 = fmaxf(left_pp + s0, fmaxf(left_p, p0) + gap);
      float h1 = fmaxf(pp0 + s1, fmaxf(p0, p1) + gap);
      h0 = v0 ? fmaxf(h0, 0.f) : 0.f;
      h1 = v1 ? fmaxf(h1, 0.f) : 0.f;
      best = fmaxf(best, fmaxf(h0, h1));
      if (write_end && v1) wr[i1] = h1;
      pp0 = p0;
      pp1 = p1;
      p0 = h0;
      p1 = h1;
    }
    if (STRIPS) __syncwarp();  // this strip's last column is written before the next reads it
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) best = fmaxf(best, __shfl_xor_sync(kFull, best, o));
  if (lane == 0) {
    const float denom = match * static_cast<float>(max(1, min(raw_a, raw_b)));
    out[pair] = best / denom;
  }
}

}  // namespace

// a uint32 [bsz, la], b uint32 [bsz, lb], len_a/len_b int32 [bsz], out f32
// [bsz]; scratch f32 [bsz, 2, max(la, lb)] when lb > 64 (else unused, may
// be null).
extern "C" int fs_sw_lane(const void* a, const void* b, const void* len_a, const void* len_b,
                          void* out, void* scratch, long long bsz, int la, int lb,
                          float match, float mismatch, float gap, void* stream) {
  if (lb < 0 || la < 0 || (lb > kStrip && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bsz == 0) return 0;
  const long long blocks = (bsz + kWarps - 1) / kWarps;
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const uint32_t*>(a);
  const auto* pb = static_cast<const uint32_t*>(b);
  const auto* pla = static_cast<const int*>(len_a);
  const auto* plb = static_cast<const int*>(len_b);
  auto* po = static_cast<float*>(out);
  auto* ps = static_cast<float*>(scratch);
  const int lmax = la > lb ? la : lb;
  if (lb > kStrip) {
    sw_lane_kernel<true><<<grid, kWarps * 32, 0, st>>>(pa, pb, pla, plb, po, ps, bsz, la, lb,
                                                       lmax, match, mismatch, gap);
  } else {
    sw_lane_kernel<false><<<grid, kWarps * 32, 0, st>>>(pa, pb, pla, plb, po, ps, bsz, la, lb,
                                                        lmax, match, mismatch, gap);
  }
  return static_cast<int>(cudaGetLastError());
}
