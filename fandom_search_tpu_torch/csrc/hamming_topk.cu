// K6 — Hamming-similarity top-R over packed sign codes, written for
// Hopper (sm_90a), its scores on the int8 tensor cores.
//
// Replaces: fandom_search_tpu/ops/lsh.py, _hamming_topk_kernel (launched
// by hamming_topk_pallas).  For each query row q of W = bits/32 code words
// it scores every script column c < ns_valid by
//   sim = bits - 2 * hamming(q, s_c)
// and returns the R best, sim descending and then column ascending, as
// vals (f32 sim) and idx (int32 column).  Only columns with hamming <=
// h_max enter (h_max = (bits - min_keep_sim) / 2, or bits for the exact
// top-R); an empty slot is (-FLT_MAX, 0).
//
// Bound on this card: the scores are a dot product over `bits` positions
// per (row, column) pair, so the least time is that of an int8 product on
// the tensor cores, 2 * NQ * ns * bits operations at 1,979 TOP/s (20.65
// ms at the engine's 2^20 x 19,033 x 1,024).  The bytes (the codes in,
// NQ * R * 8 out) are small beside it.
//
// Design.  hamming = popc(q) + popc(s) - 2 * dot01(q, s), where dot01 is
// the codes' product as 0/1 vectors on the tensor cores, on one of two
// routes with the same outputs:
// - "b1" (the engine's, bits a multiple of 256): mma.sync m16n8k256
//   .b1.and.popc on the packed words as they are, 256 positions per step;
// - "s8" (every bits): codes expanded to 0/1 bytes, mma.sync m16n8k32
//   s8 x s8 -> s32 (exact: sums of at most 2,048 ones).
// A block takes BM query rows (64, 32 or 16, the largest whose shared
// memory fits; the per-row histogram grows with h_max) and 8 warps:
// - A (queries): staged once per block in shared memory (packed for b1,
//   0/1 bytes for s8), rows padded by 16 bytes so ldmatrix reads are free
//   of bank conflicts, and reused by every column tile.
// - B (script): tiles of BN = 128 columns of the packed, transposed codes
//   (codes_t [W, stride]) stream through a ring of up to 4 shared-memory
//   slots, filled by 16-byte cp.async copies issued stages - 1 tiles ahead,
//   with one barrier per tile; a lane reads its B fragment as code words
//   (b1), or expands one word's nibbles into 0/1 bytes in registers (s8,
//   a multiply each), so B costs 1/8 of the bytes of an int8 copy and no
//   extra device memory.  The columns' popcounts come from one more mma
//   per n8 tile against an all-ones A fragment.
// - Pass 1 scores every tile.  Its epilogue turns each dot into a hamming
//   distance; only entries with hamming <= h_max touch the row: its bin
//   histogram in shared memory, and its list of up to 32 (hamming, column)
//   keys (sharing its room with pass 2's hamming tile).  A tile with any
//   such entry sets one bit of the block's tile flags.  Columns past
//   ns_valid and rows past nq carry a popcount of 2^20, so they never
//   enter, whatever their codes.
// - When every row's entries fit its list, a warp per row sorts the list
//   (bitonic over the lanes) and writes the first min(count, R): no second
//   pass.  The engine's gate keeps 5.5 entries a row on average on noise
//   rows of real text (not ~0, as random codes would: shingles that share
//   words have correlated codes), and 90% of tiles hold one, so a rescore
//   of the flagged tiles would cost almost a second pass.
// - Otherwise (the ungated top-R, or a row with more than 32 entries) the
//   exclusive prefix over a row's bins gives each bin its first output
//   slot and the threshold bin h_t, the last bin whose first slot is below
//   R, and pass 2 rescores only the flagged tiles, writes each tile's
//   hamming values to shared memory, and one warp per row emits every
//   column with hamming <= h_t straight to its slot, in ascending column
//   order (ballot and __match_any_sync rank the lanes of one bin).  Tiles
//   ascend, so the output is sorted, lowest column first on ties, with no
//   sort.
// Wide codes (bits > 2048, up to 8,192): the row histogram (h_max + 1
// bins, up to 8,193) no longer fits beside the ring, so it lives in a
// device-memory scratch of the block's rows (the wrapper allocates it for
// kScratchRows rows and the launch walks the rows in chunks of that size);
// the same atomics, prefix and emit run on it.  A tile is scored in chunks
// of kWideWords code words, each loaded and scored in turn (one slot, no
// ring).  R has no upper limit: pass 2 writes slots below R by their bin's
// first slot, whatever R is.
// wgmma (m64nNk32 s8) would reach further toward the int8 bound: it is
// asynchronous and reads B from shared memory, which needs the tile
// expanded to bytes there first (128 KB for 128 columns of 1,024 bits);
// Hopper has no 1-bit wgmma.
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "int8_tiles.cuh"  // ldsm_x4, mma_s8, cp_async16, cp_commit, cp_wait

namespace {

constexpr int kBN = 128;          // script columns per tile
constexpr int kBNP = kBN + 8;     // word pitch of a staged tile row (b1 reads: no bank conflicts)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxWords = 256;   // bits <= 8192
constexpr int kWideWords = 64;   // wider codes: histogram in device memory, tiles in chunks
constexpr int kOut = 1 << 20;     // popcount of a row or column that must not enter
constexpr unsigned kFull = 0xffffffffu;
constexpr int kHPitch = kBN + 2;  // uint16 pitch of the hamming tile (odd word count)
constexpr int kList = 32;         // gate-passing entries a row keeps in pass 1 (one per lane)

__device__ __forceinline__ uint32_t spread4(uint32_t nib) {
  // bit i of a nibble -> byte i (0 or 1); the four shifted copies do not overlap
  return (nib * 0x00204081u) & 0x01010101u;
}

// the same product on 1-bit operands: popc(a AND b) over k = 256
__device__ __forceinline__ void mma_b1(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__host__ __device__ __forceinline__ size_t up16(size_t x) { return (x + 15) & ~size_t(15); }

// Shared-memory layout of one block (byte offsets).
struct Layout {
  size_t a, b, ht, hist, pa, thr, cnt, lc, flags, total;
  // arow: bytes of one query row in shared memory
  __host__ __device__ Layout(int bm, int arow, int stages, int words, int nbins, int fwords) {
    a = 0;
    b = a + up16(static_cast<size_t>(bm) * arow);
    ht = b + static_cast<size_t>(stages) * words * kBNP * 4;
    // the hamming tile of pass 2 shares its room with pass 1's row lists
    const size_t htile = static_cast<size_t>(bm) * kHPitch * 2;
    const size_t lists = static_cast<size_t>(bm) * kList * 8;
    hist = ht + up16(htile > lists ? htile : lists);
    pa = hist + up16(static_cast<size_t>(bm) * nbins * 4);
    thr = pa + static_cast<size_t>(bm) * 4;
    cnt = thr + static_cast<size_t>(bm) * 4;
    lc = cnt + static_cast<size_t>(bm) * 4;
    flags = lc + static_cast<size_t>(bm) * 4;
    total = flags + static_cast<size_t>(fwords) * 4;
  }
};

template <int BM>
struct Tiling {
  static constexpr int WARPS_M = BM >= 32 ? 2 : 1;
  static constexpr int WARPS_N = kWarps / WARPS_M;
  static constexpr int MT = BM / WARPS_M / 16;  // m16 tiles per warp
  static constexpr int WN = kBN / WARPS_N;
  static constexpr int NT = WN / 8;             // n8 tiles per warp
};

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(int (&acc)[MT][NT][4], int (&acc1)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc1[nt][e] = 0;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) acc[mt][nt][e] = 0;
    }
  }
}

// Stage tile t's codes (W x kBN words) with cp.async; columns >= ns read 0.
// vec: 16-byte copies (codes_t 16-byte aligned and stride % 4 == 0).
__device__ __forceinline__ void load_tile(uint32_t* bs, const uint32_t* __restrict__ st,
                                          int words, long long stride, int ns, int t,
                                          bool vec) {
  const int c0 = t * kBN;
  if (vec) {
    for (int e = threadIdx.x; e < words * (kBN / 4); e += kThreads) {
      const int w = e / (kBN / 4);
      const int c = 4 * (e - w * (kBN / 4));
      const int col = c0 + c;
      const int n = min(max(ns - col, 0), 4);  // valid columns; the rest read as 0
      cp_async16(bs + w * kBNP + c, n > 0 ? st + static_cast<long long>(w) * stride + col : st,
                 4 * n);
    }
    return;
  }
  for (int e = threadIdx.x; e < words * kBN; e += kThreads) {
    const int w = e / kBN;
    const int c = e - w * kBN;
    const int col = c0 + c;
    const bool ok = col < ns;
    cp_async4(bs + w * kBNP + c, ok ? st + static_cast<long long>(w) * stride + col : st, ok);
  }
}

// The next tile of a pass after t: every tile (pass 1) or the flagged ones.
__device__ __forceinline__ int next_tile(const uint32_t* flags, int t, int ntiles, bool all) {
  ++t;
  if (all) return t;
  while (t < ntiles) {
    const uint32_t w = flags[t >> 5] >> (t & 31);
    if (w != 0u) return t + __ffs(w) - 1;
    t = (t | 31) + 1;
  }
  return ntiles;
}

// BIN: false scores on s8 m16n8k32 (0/1 bytes), true on b1 m16n8k256
// (the packed words as they are; words % 8 == 0).
// WIDE (words > kWideWords): the histogram in ghist, the [gridDim.x * BM,
// h_max + 1] scratch, and tiles staged kWideWords words at a time; else
// the histogram in shared memory and whole tiles through the ring.
template <int BM, bool BIN, bool WIDE>
__global__ void __launch_bounds__(kThreads, 1)
hamming_topk_tc(const uint32_t* __restrict__ q,   // [nq, words]
                const uint32_t* __restrict__ st,  // [words, stride]
                float* __restrict__ vals,         // [nq, r]
                int* __restrict__ idx,            // [nq, r]
                int* __restrict__ ghist,
                long long nq, int words, long long stride, int ns, int r, int bits,
                int h_max, int stages, int fwords, int vec) {
  using T = Tiling<BM>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nbins = h_max + 1;
  const int astride = BIN ? 4 * words + 16 : 32 * words + 16;
  const int cw = WIDE ? kWideWords : words;  // words a staged tile holds
  const Layout L(BM, astride, stages, cw, WIDE ? 0 : nbins, fwords);
  uint8_t* a_s = smem + L.a;
  uint32_t* b_s = reinterpret_cast<uint32_t*>(smem + L.b);
  uint16_t* h_s = reinterpret_cast<uint16_t*>(smem + L.ht);
  unsigned long long* list = reinterpret_cast<unsigned long long*>(smem + L.ht);
  int* hist = WIDE ? ghist + static_cast<long long>(blockIdx.x) * BM * nbins
                   : reinterpret_cast<int*>(smem + L.hist);
  int* pa_s = reinterpret_cast<int*>(smem + L.pa);
  int* thr_s = reinterpret_cast<int*>(smem + L.thr);
  int* cnt_s = reinterpret_cast<int*>(smem + L.cnt);
  int* lc_s = reinterpret_cast<int*>(smem + L.lc);
  uint32_t* flags = reinterpret_cast<uint32_t*>(smem + L.flags);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / T::WARPS_N;
  const int wn = warp - wm * T::WARPS_N;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int ntiles = (ns + kBN - 1) / kBN;

  if (h_max >= 0 && ntiles > 0) {
    // ---- set-up: histograms and flags to 0; A expanded to 0/1 bytes
    for (int e = tid; e < BM * nbins; e += kThreads) hist[e] = 0;
    for (int e = tid; e < fwords; e += kThreads) flags[e] = 0u;
    for (int e = tid; e < BM; e += kThreads) lc_s[e] = 0;
    for (int e = tid; e < BM * words; e += kThreads) {
      const int rl = e / words;
      const int w = e - rl * words;
      const uint32_t c = row0 + rl < nq ? q[(row0 + rl) * words + w] : 0u;
      if (BIN) {
        *reinterpret_cast<uint32_t*>(a_s + rl * astride + w * 4) = c;
        continue;
      }
      uint4* dst = reinterpret_cast<uint4*>(a_s + rl * astride + w * 32);
      dst[0] = make_uint4(spread4(c & 15u), spread4((c >> 4) & 15u), spread4((c >> 8) & 15u),
                          spread4((c >> 12) & 15u));
      dst[1] = make_uint4(spread4((c >> 16) & 15u), spread4((c >> 20) & 15u),
                          spread4((c >> 24) & 15u), spread4(c >> 28));
    }
    for (int rl = tid; rl < BM; rl += kThreads) {
      int p = 0;
      if (row0 + rl < nq) {
        for (int w = 0; w < words; ++w) p += __popc(q[(row0 + rl) * words + w]);
      } else {
        p = kOut;
      }
      pa_s[rl] = p;
    }
    __syncthreads();

    // per-lane constants: the A rows this lane's fragments hold
    int pa_r[T::MT][2];
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
      const int rl = wm * (T::MT * 16) + mt * 16 + (lane >> 2);
      pa_r[mt][0] = pa_s[rl];
      pa_r[mt][1] = pa_s[rl + 8];
    }
    const uint8_t* a_lane = a_s + (wm * (T::MT * 16) + (lane & 15)) * astride + (lane >> 4) * 16;
    const int nib_sh = 4 * (lane & 3);

    // all-ones A: its product with a column is the column's popcount
    const uint32_t one = BIN ? 0xffffffffu : 0x01010101u;
    const uint32_t a_one[4] = {one, one, one, one};
    const int slot_words = cw * kBNP;

#pragma unroll 1
    for (int pass = 1; pass <= 2; ++pass) {
      const bool all = pass == 1;
      // a ring of `stages` tile slots: the k-th tile of the pass goes to
      // slot k % stages and is issued stages - 1 tiles ahead
      int tp = -1;  // the last tile issued
      for (int k = 0; k + 1 < stages; ++k) {
        tp = next_tile(flags, tp, ntiles, all);
        if (tp < ntiles) load_tile(b_s + k * slot_words, st, words, stride, ns, tp, vec);
        cp_commit();
      }
      int t = next_tile(flags, -1, ntiles, all);
      for (int i = 0; t < ntiles; ++i) {
        // ---- scores: acc = dot01 over all words; one = the columns' popcounts
        int acc[T::MT][T::NT][4];
        int acc1[T::NT][4];
        // acc += words [w0, w0 + nw) of the tile staged at bs
        auto score = [&](const uint32_t* bs, int w0, int nw) {
          const uint32_t* b_lane = bs + wn * T::WN + (lane >> 2);
          if (BIN) {
            // k-step of 256 bits: A words tq and tq+4 of each row (ldmatrix),
            // B words tq and tq+4 of column g
            const uint32_t* b_q = b_lane + (lane & 3) * kBNP;
#pragma unroll 2
            for (int c8 = 0; c8 < nw; c8 += 8) {
              uint32_t af[T::MT][4];
#pragma unroll
              for (int mt = 0; mt < T::MT; ++mt)
                ldsm_x4(af[mt], a_lane + mt * 16 * astride + (w0 + c8) * 4);
#pragma unroll
              for (int nt = 0; nt < T::NT; ++nt) {
                const uint32_t b0 = b_q[c8 * kBNP + nt * 8];
                const uint32_t b1 = b_q[(c8 + 4) * kBNP + nt * 8];
#pragma unroll
                for (int mt = 0; mt < T::MT; ++mt) mma_b1(acc[mt][nt], af[mt], b0, b1);
                mma_b1(acc1[nt], a_one, b0, b1);
              }
            }
          } else {
#pragma unroll 2
            for (int w = 0; w < nw; ++w) {
              uint32_t af[T::MT][4];
#pragma unroll
              for (int mt = 0; mt < T::MT; ++mt)
                ldsm_x4(af[mt], a_lane + mt * 16 * astride + (w0 + w) * 32);
#pragma unroll
              for (int nt = 0; nt < T::NT; ++nt) {
                const uint32_t x = b_lane[w * kBNP + nt * 8] >> nib_sh;
                const uint32_t b0 = spread4(x & 15u);
                const uint32_t b1 = spread4((x >> 16) & 15u);
#pragma unroll
                for (int mt = 0; mt < T::MT; ++mt) mma_s8(acc[mt][nt], af[mt], b0, b1);
                mma_s8(acc1[nt], a_one, b0, b1);
              }
            }
          }
        };
        if constexpr (WIDE) {
          zero_acc<T::MT, T::NT>(acc, acc1);
          // wide codes: the tile in chunks of cw words, each loaded and scored in turn
          for (int w0 = 0; w0 < words; w0 += cw) {
            const int nw = min(cw, words - w0);
            __syncthreads();  // every thread is done with the slot
            load_tile(b_s, st + static_cast<long long>(w0) * stride, nw, stride, ns, t, vec);
            cp_commit();
            cp_wait(0);
            __syncthreads();
            score(b_s, w0, nw);
          }
        } else {
          const uint32_t* bs = b_s + (i % stages) * slot_words;
          if (stages == 1) {
            __syncthreads();  // every thread is done with the slot
            load_tile(b_s, st, words, stride, ns, t, vec);
            cp_commit();
            cp_wait(0);
            __syncthreads();
          } else {
            cp_wait(stages - 2);  // tile t has landed for this thread...
            __syncthreads();      // ...and every thread, and the last tile's slot is free
            tp = next_tile(flags, tp, ntiles, all);
            if (tp < ntiles) {
              load_tile(b_s + ((i + stages - 1) % stages) * slot_words, st, words, stride, ns,
                        tp, vec);
            }
            cp_commit();
          }
          // zeroed after the ring's barrier, so they are not live across it
          zero_acc<T::MT, T::NT>(acc, acc1);
          score(bs, 0, words);
        }
        // popcounts of this lane's two columns per n8 tile; a column past
        // ns_valid never enters
        int pb[T::NT][2];
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt) {
          const int col = t * kBN + wn * T::WN + nt * 8 + 2 * (lane & 3);
          pb[nt][0] = col < ns ? acc1[nt][0] : kOut;
          pb[nt][1] = col + 1 < ns ? acc1[nt][1] : kOut;
        }

        if (pass == 1) {
          // ---- histogram and lists of the entries that may enter; flag the tile
          bool any = false;
#pragma unroll
          for (int mt = 0; mt < T::MT; ++mt) {
            const int rl = wm * (T::MT * 16) + mt * 16 + (lane >> 2);
#pragma unroll
            for (int nt = 0; nt < T::NT; ++nt) {
              const int cl = wn * T::WN + nt * 8 + 2 * (lane & 3);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int h = pa_r[mt][e >> 1] + pb[nt][e & 1] - 2 * acc[mt][nt][e];
                if (h <= h_max) {
                  const int rr = rl + 8 * (e >> 1);
                  atomicAdd(&hist[rr * nbins + h], 1);
                  const int p = atomicAdd(&lc_s[rr], 1);
                  if (p < kList) {
                    list[rr * kList + p] =
                        (static_cast<unsigned long long>(h) << 32) |
                        static_cast<unsigned>(t * kBN + cl + (e & 1));
                  }
                  any = true;
                }
              }
            }
          }
          if (__any_sync(kFull, any) && lane == 0) atomicOr(&flags[t >> 5], 1u << (t & 31));
        } else {
          // ---- the tile's hamming values to shared memory, then emit (the
          // next tile's barrier keeps the tile until every row is emitted)
#pragma unroll
          for (int mt = 0; mt < T::MT; ++mt) {
            const int rl = wm * (T::MT * 16) + mt * 16 + (lane >> 2);
#pragma unroll
            for (int nt = 0; nt < T::NT; ++nt) {
              const int cl = wn * T::WN + nt * 8 + 2 * (lane & 3);
#pragma unroll
              for (int hi = 0; hi < 2; ++hi) {
                const int h0 = pa_r[mt][hi] + pb[nt][0] - 2 * acc[mt][nt][2 * hi];
                const int h1 = pa_r[mt][hi] + pb[nt][1] - 2 * acc[mt][nt][2 * hi + 1];
                const uint32_t v = static_cast<uint32_t>(min(h0, 0xffff)) |
                                   (static_cast<uint32_t>(min(h1, 0xffff)) << 16);
                *reinterpret_cast<uint32_t*>(h_s + (rl + 8 * hi) * kHPitch + cl) = v;
              }
            }
          }
          __syncthreads();
          for (int rl = warp; rl < BM; rl += kWarps) {
            const int h_t = thr_s[rl];
            if (h_t < 0) continue;
            int* first = hist + rl * nbins;
            const long long row = row0 + rl;
#pragma unroll
            for (int c = lane; c < kBN; c += 32) {  // same trip count on every lane
              const int h = h_s[rl * kHPitch + c];
              const bool ok = h <= h_t;
              const unsigned want = __ballot_sync(kFull, ok);
              if (want == 0u) continue;
              unsigned peers = 0u;
              int pos = 0;
              if (ok) {
                peers = __match_any_sync(want, h);
                pos = first[h] + __popc(peers & ((1u << lane) - 1u));
              }
              __syncwarp();  // every lane has read its bin's slot
              if (ok) {
                if (pos < r) {
                  vals[row * r + pos] = static_cast<float>(bits - 2 * h);
                  idx[row * r + pos] = t * kBN + c;
                }
                if ((peers >> lane) == 1u) first[h] = pos + 1;  // highest lane of the bin
              }
              __syncwarp();
            }
          }
        }
        t = next_tile(flags, t, ntiles, all);
      }
      cp_wait(0);
      __syncthreads();  // the pass's histogram, lists and flags are complete

      if (pass == 1 && !__syncthreads_or(tid < BM && lc_s[tid] > kList)) {
        // ---- every row's entries fit its list: sort each list (a warp per
        // row, bitonic over the lanes, key (hamming, column)) and emit; no
        // pass 2
        for (int rl = warp; rl < BM; rl += kWarps) {
          const int n = lc_s[rl];
          unsigned long long key = lane < n ? list[rl * kList + lane] : ~0ull;
#pragma unroll
          for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
            for (int j = k >> 1; j > 0; j >>= 1) {
              const unsigned long long o = __shfl_xor_sync(kFull, key, j);
              const bool keep_min = ((lane & k) == 0) == ((lane & j) == 0);
              key = keep_min ? (o < key ? o : key) : (o > key ? o : key);
            }
          }
          const long long row = row0 + rl;
          if (lane < min(n, r) && row < nq) {
            vals[row * r + lane] = static_cast<float>(bits - 2 * static_cast<int>(key >> 32));
            idx[row * r + lane] = static_cast<int>(key & 0xffffffffull);
          }
          if (lane == 0) cnt_s[rl] = n;
        }
        __syncthreads();
        break;
      }
      if (pass == 1) {
        // ---- a list overflowed: bins -> first output slot; threshold bin
        // h_t (a warp per row); pass 2 rescores the flagged tiles
        for (int rl = warp; rl < BM; rl += kWarps) {
          int* hrow = hist + rl * nbins;
          const int per = (nbins + 31) / 32;
          const int b0 = min(lane * per, nbins);
          const int b1 = min(b0 + per, nbins);
          int local = 0;
          for (int b = b0; b < b1; ++b) local += hrow[b];
          int incl = local;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl += v;
          }
          int run = incl - local;
          int ht = -1;
          for (int b = b0; b < b1; ++b) {
            const int n = hrow[b];
            hrow[b] = run;
            if (run < r) ht = b;
            run += n;
          }
          const int h_t = __reduce_max_sync(kFull, ht);
          const int total = __shfl_sync(kFull, incl, 31);
          if (lane == 0) {
            thr_s[rl] = h_t;
            cnt_s[rl] = total;
          }
        }
        __syncthreads();
      }
    }
  } else {
    for (int rl = tid; rl < BM; rl += kThreads) cnt_s[rl] = 0;
    __syncthreads();
  }

  // ---- empty slots
  for (int rl = warp; rl < BM; rl += kWarps) {
    const long long row = row0 + rl;
    if (row >= nq) break;
    for (int p = min(cnt_s[rl], r) + lane; p < r; p += 32) {
      vals[row * r + p] = -FLT_MAX;
      idx[row * r + p] = 0;
    }
  }
}

template <int BM, bool BIN, bool WIDE>
int launch(const void* q, const void* codes_t, void* vals, void* idx, int* ghist, long long nq,
           int words, long long stride, int ns, int r, int bits, int h_max, int stages,
           int fwords, int vec, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(hamming_topk_tc<BM, BIN, WIDE>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = (nq + BM - 1) / BM;
  hamming_topk_tc<BM, BIN, WIDE><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(codes_t),
      static_cast<float*>(vals), static_cast<int*>(idx), ghist, nq, words, stride, ns, r, bits,
      h_max, stages, fwords, vec);
  return static_cast<int>(cudaGetLastError());
}

// The most rows a block, then the double buffer, whose shared memory fits;
// wide codes (ghist set) walk the rows in chunks of scratch_rows.
template <bool BIN>
int pick_and_launch(const void* q, const void* codes_t, void* vals, void* idx, int* ghist,
                    long long scratch_rows, long long nq, int words, long long stride, int ns,
                    int r, int bits, int h_max, size_t optin, cudaStream_t st) {
  const int ntiles = (ns + kBN - 1) / kBN;
  const int fwords = (ntiles + 31) / 32 + 1;
  const int nbins = h_max + 1;
  const int arow = BIN ? 4 * words + 16 : 32 * words + 16;
  const int vec = (reinterpret_cast<uintptr_t>(codes_t) % 16 == 0 && stride % 4 == 0) ? 1 : 0;
  const bool wide = ghist != nullptr;
  const int cw = wide ? kWideWords : words;
  for (int bm = 64; bm >= 16; bm /= 2) {
    for (int stages = wide ? 1 : 4; stages >= 1; --stages) {
      const size_t smem = Layout(bm, arow, stages, cw, wide ? 0 : nbins, fwords).total;
      if (smem > optin) continue;
      const long long step = wide ? scratch_rows : nq;
      for (long long r0 = 0; r0 < nq; r0 += step) {
        const long long n = nq - r0 < step ? nq - r0 : step;
        const uint32_t* qc = static_cast<const uint32_t*>(q) + r0 * words;
        float* vc = static_cast<float*>(vals) + r0 * r;
        int* ic = static_cast<int*>(idx) + r0 * r;
#define FS_HAMMING_LAUNCH(BMV, W)                                                        \
  launch<BMV, BIN, W>(qc, codes_t, vc, ic, ghist, n, words, stride, ns, r, bits, h_max, stages, \
                      fwords, vec, smem, st)
        int rc;
        if (bm == 64)
          rc = wide ? FS_HAMMING_LAUNCH(64, true) : FS_HAMMING_LAUNCH(64, false);
        else if (bm == 32)
          rc = wide ? FS_HAMMING_LAUNCH(32, true) : FS_HAMMING_LAUNCH(32, false);
        else
          rc = wide ? FS_HAMMING_LAUNCH(16, true) : FS_HAMMING_LAUNCH(16, false);
#undef FS_HAMMING_LAUNCH
        if (rc != 0) return rc;
      }
      return 0;
    }
  }
  return static_cast<int>(cudaErrorInvalidConfiguration);
}

}  // namespace

// q int32 [nq, words], codes_t int32 [words, stride] (uint32 bit patterns),
// vals f32 [nq, r], idx int32 [nq, r]; bits = 32 * words <= 8192, r >= 1,
// 0 <= ns_valid <= stride, -1 <= h_max <= bits; route 0 scores on s8 mma,
// route 1 on b1 mma (bits a multiple of 256).  Wide codes (words > 64) need
// scratch: int32 [scratch_rows, h_max + 1] with scratch_rows a positive
// multiple of 64; the rows then run in launches of scratch_rows.  Other
// values return cudaErrorInvalidValue; a shape whose block does not fit in
// shared memory returns cudaErrorInvalidConfiguration.
extern "C" int fs_hamming_topk(const void* q, const void* codes_t, void* vals, void* idx,
                               void* scratch, long long scratch_rows, long long nq, int words,
                               long long stride, int ns_valid, int r, int bits, int h_max,
                               int route, void* stream) {
  const bool wide = words > kWideWords;
  if (words < 1 || words > kMaxWords || bits != 32 * words || r < 1 ||
      ns_valid < 0 || ns_valid > stride || h_max < -1 || h_max > bits ||
      route < 0 || route > 1 || (route == 1 && words % 8 != 0) ||
      (wide && (scratch == nullptr || scratch_rows < 64 || scratch_rows % 64 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* ghist = wide ? static_cast<int*>(scratch) : nullptr;
  if (route == 1)
    return pick_and_launch<true>(q, codes_t, vals, idx, ghist, scratch_rows, nq, words, stride,
                                 ns_valid, r, bits, h_max, static_cast<size_t>(optin), st);
  return pick_and_launch<false>(q, codes_t, vals, idx, ghist, scratch_rows, nq, words, stride,
                                ns_valid, r, bits, h_max, static_cast<size_t>(optin), st);
}
