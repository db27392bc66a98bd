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
// Bound on this card: the dependent chain of DP cells.  Within a row each
// cell waits for its left neighbour (about four dependent f32 operations),
// so a pair is a chain of len_a * len_b / (lanes on it) cells at best; the
// bytes read (512 B per pair at 64 x 64) are small beside it.
//
// Design: a group of kG = 8 lanes holds one pair (4 pairs a warp).  The
// pair's shorter sequence runs along the rows and the longer along the
// columns: the transposed DP has the same cells (max(left, up) and the
// match test are symmetric), so the same scores, and the rows are what a
// pair pays for one after another.  Lane g owns a strip of kC = 8
// columns, j in [64 s + 8 g, 64 s + 8 g + 8), their tokens and its part
// of the DP row in registers.  The rows are skewed over the group: at
// step i lane g computes row i - g, so a pair takes rows + 7 steps of 8
// cells.  A step needs H[i][8 g - 1], the left neighbour's strip end of
// the same row, which that lane computed one step earlier: one
// __shfl_up_sync within the group gives it, and the value it gave one
// step before is H[i-1][8 g - 1], the first cell's diagonal.  Each lane
// reads its row's token itself, a step ahead.  Against the first design's
// one thread per pair (8,192 pairs: 2 warps an SM) this puts 8 lanes on a
// pair and 16 warps on an SM at the engine's pair counts; the engine
// length-sorts the pairs, so the groups of a warp stop together.  (On an
// H100, groups of 4 and 16 lanes measured within 10% of 8; the swap took 5% off
// the unswapped walk on pairs of random lengths and 26% on 64-token
// windows against 6-14-token lines.)
// Sequences longer than 64 along the columns run as strips of 64 in turn:
// the last lane writes its strip end H[i][64 s + 63] for every row to a
// scratch column in device memory, and lane 0 of the next strip reads it
// as its left (two buffers, alternating by strip).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStrip = 64;  // columns a pass
constexpr int kG = 8;        // lanes a pair
constexpr int kC = kStrip / kG;  // columns a lane
constexpr int kWarps = 4;
constexpr int kPairsBlock = kWarps * 32 / kG;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
sw_kernel(const uint32_t* __restrict__ a,    // [bsz, la]
          const uint32_t* __restrict__ b,    // [bsz, lb]
          const int* __restrict__ len_a,     // [bsz]
          const int* __restrict__ len_b,     // [bsz]
          float* __restrict__ out,           // [bsz]
          float* __restrict__ bnd,           // [bsz, 2, lmax] when a strip pass can follow
          long long bsz, int la, int lb, int lmax, float match, float mismatch, float gap) {
  const int lane = threadIdx.x & 31;
  const int g = lane % kG;
  const long long pair = static_cast<long long>(blockIdx.x) * kPairsBlock + threadIdx.x / kG;
  const bool live = pair < bsz;
  const int raw_a = live ? len_a[pair] : 0;
  const int raw_b = live ? len_b[pair] : 0;
  const int na = max(0, min(raw_a, la));
  const int nb = max(0, min(raw_b, lb));
  const long long p0 = live ? pair : 0;
  // rows: the nr tokens at rseq, the shorter sequence; columns: nc at cseq
  const bool swap = nb < na;
  const uint32_t* rseq = swap ? b + p0 * lb : a + p0 * la;
  const uint32_t* cseq = swap ? a + p0 * la : b + p0 * lb;
  const int nr = swap ? nb : na;
  const int nc = swap ? na : nb;
  const int nstrips = (nr > 0 && nc > 0) ? (nc + kStrip - 1) / kStrip : 0;
  // the warp walks as many strips and steps as its longest pair
  const int wstrips = __reduce_max_sync(kFull, nstrips);
  const int wsteps = __reduce_max_sync(kFull, nstrips > 0 ? nr + kG - 1 : 0);

  float best = 0.f;
  for (int s = 0; s < wstrips; ++s) {
    const int j0 = s * kStrip + g * kC;
    uint32_t bj[kC];
    float h[kC];  // H[row - 1][j0 + c]
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      bj[c] = j0 + c < nc ? cseq[j0 + c] : 0u;
      h[c] = 0.f;
    }
    const float* rd = bnd + p0 * 2 * lmax + ((s + 1) & 1) * lmax;  // strip s - 1's ends
    float* wr = bnd + p0 * 2 * lmax + (s & 1) * lmax;
    const bool write_end = g == kG - 1 && s + 1 < nstrips;
    float e = 0.f;          // this lane's last strip end
    float left_prev = 0.f;  // the left it took a step earlier
    uint32_t a_next = (g == 0 && s < nstrips) ? __ldg(rseq) : 0u;
#pragma unroll 1
    for (int i = 0; i < wsteps; ++i) {
      float left = __shfl_up_sync(kFull, e, 1, kG);  // H[r][j0 - 1]
      const int r = i - g;
      const bool row_ok = s < nstrips && r >= 0 && r < nr;
      const uint32_t ai = a_next;
      if (s < nstrips && r + 1 >= 0 && r + 1 < nr) a_next = __ldg(rseq + r + 1);
      if (g == 0) left = (s > 0 && row_ok) ? rd[r] : 0.f;
      if (row_ok) {
        float diag = r == 0 ? 0.f : left_prev;  // H[r-1][j0 - 1]
        float lft = left;
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const float up = h[c];
          const float sub = (ai == bj[c]) ? match : mismatch;
          float v = fmaxf(fmaxf(diag + sub, fmaxf(lft, up) + gap), 0.f);
          v = j0 + c < nc ? v : 0.f;
          diag = up;
          h[c] = v;
          lft = v;
          best = fmaxf(best, v);
        }
        e = h[kC - 1];
        if (write_end) wr[r] = e;
      }
      left_prev = left;
    }
    __syncwarp();  // this strip's ends are written before the next reads them
  }
#pragma unroll
  for (int o = kG / 2; o > 0; o >>= 1) best = fmaxf(best, __shfl_xor_sync(kFull, best, o));
  if (live && g == 0) {
    const float denom = match * static_cast<float>(max(1, min(raw_a, raw_b)));
    out[pair] = best / denom;
  }
}

}  // namespace

// a uint32 [bsz, la], b uint32 [bsz, lb], len_a/len_b int32 [bsz], out f32
// [bsz]; scratch f32 [bsz, 2, max(la, lb)] when max(la, lb) > 64 (else
// unused, may be null).
extern "C" int fs_sw(const void* a, const void* b, const void* len_a, const void* len_b,
                     void* out, void* scratch, long long bsz, int la, int lb, float match,
                     float mismatch, float gap, void* stream) {
  if (lb < 0 || la < 0 || (max(la, lb) > kStrip && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bsz == 0) return 0;
  const long long blocks = (bsz + kPairsBlock - 1) / kPairsBlock;
  sw_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const int*>(len_a), static_cast<const int*>(len_b),
      static_cast<float*>(out), static_cast<float*>(scratch), bsz, la, lb, max(la, lb), match,
      mismatch, gap);
  return static_cast<int>(cudaGetLastError());
}
