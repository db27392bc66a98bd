// K5 — word-level Smith-Waterman with a linear gap, normalized, written
// for Hopper (sm_90a), in two routes that give the same bits.
//
// Replaces: fandom_search_tpu/ops/smith_waterman.py, _sw_kernel (the
// lane-major variants "fast", "r2" and "dyn", launched by _sw_pallas_call /
// sw_normalized_pallas), with its two DP states: state="f32" and
// state="i16".  It computes the same function as K4
// (csrc/smith_waterman.cu): per pair,
//   H[i][j] = max(0, H[i-1][j-1] + (a_i == b_j ? match : mismatch),
//                 max(H[i-1][j], H[i][j-1]) + gap)
// over i < len_a, j < len_b (H = 0 outside), and returns
// max H / (match * max(1, min(len_a, len_b))) in f32.
//
// fs_sw_lane_i16, the packed route (the JAX kernel's state="i16", which the
// TPU could not run: it has no int16 vector compare).  Taken when the three
// parameters are integers and max(|match|, |mismatch|, |gap|) * (LA + LB +
// 1) <= 32767 (ops/smith_waterman.py, i16_route): then every H and every
// sum before a max lies in [-32768, 32767], the f32 DP's values are those
// integers exactly, and computing them in 16-bit halfwords gives the same
// bits.  Two pairs share each 32-bit register: pair 2q in the low halfwords,
// pair 2q + 1 in the high ones, so one Hopper DPX instruction advances the
// same cell of both.  A row of a lane's cells takes two passes: first
//   d = diag + sub                      __viaddmax_s16x2(diag, sub, NEG)
//   p = max(up + gap, d)                __viaddmax_s16x2(up, gap, d)
// for every cell from the row above, then along the row
//   H = max(left + gap, p, 0)           __viaddmax_s16x2_relu(left, gap, p)
// so the chain from the left neighbour is one instruction a cell, and the
// row above is dead before the new one overwrites it (one pass would keep
// each old H alive as the next cell's diagonal and move registers every
// step).  sub takes two 32-bit token compares (the uint32 hashes are never
// narrowed), two selects and a byte permute.  Validity needs no per-cell
// mask: a column past a half's own length gets sub = gap = -32768 in that
// half, and with every input in [0, 32767] its cell computes max(x -
// 32768, 0) = 0, whatever the signs of the parameters; a row past a half's
// length is left out of the running best by a row mask (the rows after it
// are past it too, so nothing valid reads it).  These per-column constants
// are pinned in registers (ptxas otherwise recomputes them inside the row
// loop).  The layout is K4's: a group of kI16G = 4 lanes holds one
// register of two pairs, lane g owns kI16C = 16 columns of a strip of 64,
// the rows are skewed over the lanes with one __shfl_up_sync a step, and
// each half puts its own shorter sequence on the rows.  Odd B leaves the
// last register's high half empty: it reads nothing, scores nothing and
// writes nothing.  Sequences longer than 64 run in strips, the strip-end
// column (both halves in one word) in a uint32 [ceil(B / 2), 2, max(LA,
// LB)] scratch.  Four lanes a register fit the pairs the engine verifies:
// on the LSH path every window is 64 tokens and every script segment 6-13
// (the rows), so a register walks rows + 3 skew steps.  On an H100, over
// the 20 batches of 16,384 pairs that the LSH path hands this kernel in
// chip_smoke.py's world (scripts/torch_sw_i16_ab.py), 4 lanes took 0.173
// ms, 2 lanes 0.219, 8 lanes 0.182 and 16 lanes 0.283, and unrolling the
// row loop twice moved neither 4 nor 8 lanes by more than 1%.  On 8,192
// pairs of uniform lengths up to 64 x 64, 8 lanes take 0.0143 ms and 4
// lanes 0.0166 (long rows then cost more than the skew).  A column mask
// on the running best in place of the -32768 constants was slower.
//
// fs_sw_lane, the f32 route, for every other parameter set (the JAX
// state="f32"): one warp per pair along the anti-diagonals.  Each cell
// takes _sw_best_jnp's f32 operations in its order, so the result is
// bit-exact with the plain version and with K4.
//
// Bound on this card: the cells' instructions.  The f32 cell takes about
// eight (adds, maxes, a compare and a select), most of them at the 64
// results a clock an SM of the "compare, minimum, maximum" row of the CUDA
// C++ Programming Guide's throughput table (compute capability 9.0); the
// packed route takes about 8.6 for two cells (three DPX, two compares, two
// selects, a byte permute, 0.6 for the running best).  The bytes read (512
// B per 64 x 64 pair) are small beside them.
//
// The f32 route's design: the TPU kernel lays one pair per row with j along
// the lanes and walks the anti-diagonals d; here one warp holds one pair,
// lane l owning cells j = 2l and 2l + 1 of a strip of 64 columns (b_j in
// registers).  Cell (i = d - j, j) needs H_{d-1}[j-1], H_{d-1}[j] and
// H_{d-2}[j-1]: for j = 2l + 1 they sit in the same lane, for j = 2l two
// __shfl_up_sync bring them from lane l - 1.  a[d - j] is read directly (no
// rolling buffer), and each warp stops after its own pair's len_a + len_b -
// 1 diagonals.  Segments wider than 64 columns (LB > 64) run as strips of
// 64 in turn: lane 31 writes the strip's last column H[i][64 s + 63] to a
// scratch column in device memory, and lane 0 of the next strip reads
// H[i][64 s - 1] and H[i-1][64 s - 1] from it (two buffers, alternating by
// strip).
#include <cstdint>
#include <cstdlib>
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

// ---- the packed route: two pairs a register, int16 halves, DPX ----

// lanes a register of two pairs, and steps a pass of the row loop (the
// widths and unrolls timed on an H100 by scripts/torch_sw_i16_ab.py, which
// builds each variant by rewriting these two lines)
constexpr int kI16G = 4;
constexpr int kI16Unroll = 1;
constexpr int kI16C = kStrip / kI16G;     // columns a lane
constexpr int kI16Warps = 4;
constexpr int kI16Regs = kI16Warps * 32 / kI16G;  // registers of two pairs a block
constexpr int kNeg = -32768;
constexpr uint32_t kNeg2 = 0x80008000u;   // -32768 in both halves
static_assert(kStrip % kI16G == 0 && 32 % kI16G == 0, "a group divides the strip and the warp");

__device__ __forceinline__ uint32_t pack2(int lo, int hi) {
  return (static_cast<uint32_t>(lo) & 0xffffu) | (static_cast<uint32_t>(hi) << 16);
}

// Keeps a loop-invariant value in its register: without it ptxas
// recomputes the packed constants from the kernel's parameters inside the
// row loop, several instructions a cell.
__device__ __forceinline__ uint32_t pinned(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// One half of a register: a pair's rows (the shorter sequence) and columns.
struct Half {
  const uint32_t* rseq;
  const uint32_t* cseq;
  int nr, nc, raw_a, raw_b;
};

__device__ __forceinline__ Half half_of(const uint32_t* a, const uint32_t* b, const int* len_a,
                                        const int* len_b, long long pair, long long bsz, int la,
                                        int lb) {
  Half h;
  const bool ok = pair < bsz;
  const long long p = ok ? pair : 0;  // an empty half reads nothing past the arrays
  h.raw_a = ok ? len_a[p] : 0;
  h.raw_b = ok ? len_b[p] : 0;
  const int na = max(0, min(h.raw_a, la));
  const int nb = max(0, min(h.raw_b, lb));
  const bool swap = nb < na;
  h.rseq = swap ? b + p * lb : a + p * la;
  h.cseq = swap ? a + p * la : b + p * lb;
  h.nr = swap ? nb : na;  // min: no rows when either side is empty
  h.nc = swap ? na : nb;
  return h;
}

// STRIPS: max(la, lb) > kStrip, a strip pass can follow; else one pass.
template <bool STRIPS>
__global__ void __launch_bounds__(kI16Warps * 32)
sw_lane_i16_kernel(const uint32_t* __restrict__ a,  // [bsz, la]
                   const uint32_t* __restrict__ b,  // [bsz, lb]
                   const int* __restrict__ len_a,   // [bsz]
                   const int* __restrict__ len_b,   // [bsz]
                   float* __restrict__ out,         // [bsz]
                   uint32_t* __restrict__ bnd,      // [ceil(bsz / 2), 2, lmax] when STRIPS
                   long long bsz, int la, int lb, int lmax, int match, int mismatch, int gap) {
  const int lane = threadIdx.x & 31;
  const int g = lane % kI16G;
  const long long reg = static_cast<long long>(blockIdx.x) * kI16Regs + threadIdx.x / kI16G;
  const long long nregs = (bsz + 1) / 2;
  const long long r0 = reg < nregs ? reg : 0;
  const Half h0 = half_of(a, b, len_a, len_b, reg < nregs ? 2 * reg : bsz, bsz, la, lb);
  const Half h1 = half_of(a, b, len_a, len_b, reg < nregs ? 2 * reg + 1 : bsz, bsz, la, lb);
  const int nrows = max(h0.nr, h1.nr);
  const int ncols = max(h0.nr > 0 ? h0.nc : 0, h1.nr > 0 ? h1.nc : 0);
  const int nstrips = nrows > 0 ? (ncols + kStrip - 1) / kStrip : 0;
  // the warp walks as many strips and steps as its longest register
  const int wstrips = __reduce_max_sync(kFull, nstrips);
  const int wsteps = __reduce_max_sync(kFull, nstrips > 0 ? nrows + kI16G - 1 : 0);

  uint32_t best = 0;
  for (int s = 0; s < wstrips; ++s) {
    const int j0 = s * kStrip + g * kI16C;
    uint32_t b0[kI16C], b1[kI16C];    // column tokens, low and high pair
    uint32_t mm[kI16C], xx[kI16C];    // sub on a match / a mismatch
    uint32_t gg[kI16C], hc[kI16C];    // gap; H[row - 1][j0 + c]
#pragma unroll
    for (int c = 0; c < kI16C; ++c) {
      const int j = j0 + c;
      const bool v0 = j < h0.nc && h0.nr > 0;
      const bool v1 = j < h1.nc && h1.nr > 0;
      b0[c] = v0 ? h0.cseq[j] : 0u;
      b1[c] = v1 ? h1.cseq[j] : 0u;
      // a column past a half's length: sub = gap = -32768 there, so H = 0
      mm[c] = pinned(pack2(v0 ? match : kNeg, v1 ? match : kNeg));
      xx[c] = pinned(pack2(v0 ? mismatch : kNeg, v1 ? mismatch : kNeg));
      gg[c] = pinned(pack2(v0 ? gap : kNeg, v1 ? gap : kNeg));
      hc[c] = 0u;
    }
    const uint32_t* rd = bnd + r0 * 2 * lmax + ((s + 1) & 1) * lmax;  // strip s - 1's ends
    uint32_t* wr = bnd + r0 * 2 * lmax + (s & 1) * lmax;
    const bool write_end = STRIPS && g == kI16G - 1 && s + 1 < nstrips;
    uint32_t e = 0u;          // this lane's last strip end
    uint32_t left_prev = 0u;  // the left it took a step earlier
    const bool first = g == 0 && s < nstrips;
    uint32_t an0 = (first && h0.nr > 0) ? __ldg(h0.rseq) : 0u;
    uint32_t an1 = (first && h1.nr > 0) ? __ldg(h1.rseq) : 0u;
#pragma unroll kI16Unroll
    for (int i = 0; i < wsteps; ++i) {
      uint32_t left = __shfl_up_sync(kFull, e, 1, kI16G);  // H[r][j0 - 1]
      const int r = i - g;
      const bool row_ok = s < nstrips && r >= 0 && r < nrows;
      const uint32_t ai0 = an0;
      const uint32_t ai1 = an1;
      const int rn = r + 1;
      if (s < nstrips && rn >= 0) {
        an0 = rn < h0.nr ? __ldg(h0.rseq + rn) : 0u;
        an1 = rn < h1.nr ? __ldg(h1.rseq + rn) : 0u;
      }
      if (g == 0) left = (STRIPS && s > 0 && row_ok) ? rd[r] : 0u;
      if (row_ok) {
        uint32_t diag = r == 0 ? 0u : left_prev;  // H[r-1][j0 - 1]
        uint32_t lft = left;
        uint32_t m = 0u;      // the row's max over this lane's cells
        uint32_t vprev = 0u;
        // first what the previous row gives each cell, then the chain
        // along the row: the old row is dead before the new one is written
        uint32_t pc[kI16C];
#pragma unroll
        for (int c = 0; c < kI16C; ++c) {
          const uint32_t up = hc[c];
          const uint32_t s0 = ai0 == b0[c] ? mm[c] : xx[c];
          const uint32_t s1 = ai1 == b1[c] ? mm[c] : xx[c];
          const uint32_t sub = __byte_perm(s0, s1, 0x7610);  // low half of s0, high of s1
          const uint32_t d = __viaddmax_s16x2(diag, sub, kNeg2);  // diag + sub
          pc[c] = __viaddmax_s16x2(up, gg[c], d);                  // max(up + gap, d)
          diag = up;
        }
#pragma unroll
        for (int c = 0; c < kI16C; ++c) {
          const uint32_t v = __viaddmax_s16x2_relu(lft, gg[c], pc[c]);  // max(left + gap, p, 0)
          hc[c] = v;
          lft = v;
          if (c & 1) {
            m = __vimax3_s16x2(m, vprev, v);
          } else if (c == kI16C - 1) {
            m = __vmaxs2(m, v);
          }
          vprev = v;
        }
        // rows past a half's own length stay out of its best
        const uint32_t rmask = (r < h0.nr ? 0x0000ffffu : 0u) | (r < h1.nr ? 0xffff0000u : 0u);
        best = __vmaxs2(best, m & rmask);
        e = hc[kI16C - 1];
        if (write_end) wr[r] = e;
      }
      left_prev = left;
    }
    if (STRIPS) __syncwarp();  // this strip's ends are written before the next reads them
  }
#pragma unroll
  for (int o = kI16G / 2; o > 0; o >>= 1) best = __vmaxs2(best, __shfl_xor_sync(kFull, best, o, kI16G));
  if (reg < nregs && g == 0) {
    const float fm = static_cast<float>(match);
    out[2 * reg] = static_cast<float>(best & 0xffffu) /
                   (fm * static_cast<float>(max(1, min(h0.raw_a, h0.raw_b))));
    if (2 * reg + 1 < bsz) {
      out[2 * reg + 1] = static_cast<float>(best >> 16) /
                         (fm * static_cast<float>(max(1, min(h1.raw_a, h1.raw_b))));
    }
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

// The packed route: a uint32 [bsz, la], b uint32 [bsz, lb], len_a/len_b
// int32 [bsz], out f32 [bsz]; scratch uint32 [ceil(bsz / 2), 2, max(la,
// lb)] when max(la, lb) > 64 (else unused, may be null).  match, mismatch
// and gap are the f32 parameters as integers; the caller has checked that
// max(|match|, |mismatch|, |gap|) * (la + lb + 1) <= 32767.
extern "C" int fs_sw_lane_i16(const void* a, const void* b, const void* len_a,
                              const void* len_b, void* out, void* scratch, long long bsz, int la,
                              int lb, int match, int mismatch, int gap, void* stream) {
  const int lmax = la > lb ? la : lb;
  const int pmax = max(abs(match), max(abs(mismatch), abs(gap)));
  if (lb < 0 || la < 0 || (lmax > kStrip && scratch == nullptr) ||
      static_cast<long long>(pmax) * (la + lb + 1) > 32767) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bsz == 0) return 0;
  const long long nregs = (bsz + 1) / 2;
  const dim3 grid(static_cast<unsigned>((nregs + kI16Regs - 1) / kI16Regs));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const uint32_t*>(a);
  const auto* pb = static_cast<const uint32_t*>(b);
  const auto* pla = static_cast<const int*>(len_a);
  const auto* plb = static_cast<const int*>(len_b);
  auto* po = static_cast<float*>(out);
  auto* ps = static_cast<uint32_t*>(scratch);
  if (lmax > kStrip) {
    sw_lane_i16_kernel<true><<<grid, kI16Warps * 32, 0, st>>>(pa, pb, pla, plb, po, ps, bsz, la,
                                                             lb, lmax, match, mismatch, gap);
  } else {
    sw_lane_i16_kernel<false><<<grid, kI16Warps * 32, 0, st>>>(pa, pb, pla, plb, po, ps, bsz, la,
                                                              lb, lmax, match, mismatch, gap);
  }
  return static_cast<int>(cudaGetLastError());
}
