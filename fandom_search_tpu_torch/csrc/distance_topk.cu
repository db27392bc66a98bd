// K2 — fused int8 distance + running top-k with the min_keep gate,
// written for Hopper (sm_90a), its scores on the int8 tensor cores.
//
// Replaces: fandom_search_tpu/ops/distance_topk.py, _topk_kernel with
// merge="insert" (launched by topk_dot_pallas).  For each query row it
// returns the exact top-k of dot(q, s) over script rows [0, ns_valid),
// ties to the lowest column, as vals = score * inv_dim (f32) and idx
// (int32).  Only scores >= min_keep_i enter (min_keep_i = ceil(min_keep *
// dim), or a floor far below any score for the exact full top-k); an
// empty slot is (-FLT_MAX, 0).
//
// Bound on this card: the int8 products, 2 * NQ * NS * dim operations at
// 1,979 TOP/s (142.2 ms for a 2^20-row batch against 2^20 script rows,
// 2.58 ms against 19,033).  The outputs (NQ * k * 8 B) and the script
// (NS * dim B) are small beside that.
//
// The gate, the same in every design.  Per step of columns, a row's
// scores reduce to its maximum with 3-way integer max, one compare with
// the row's gate, and one vote for the warp; when no score of the warp's
// rows reaches its row's gate, nothing touches shared memory.  Otherwise
// every score >= its row's gate goes to the row's list in shared memory
// (32 columns a list, so it cannot overflow), packed score * 32 + (31 -
// column in the list), and each row whose list is not empty is merged
// into its top-k by the warp (lane i holds slot i), on 64-bit keys score
// * 2^32 + (2^32 - 1 - column), so equal scores rank the lower column
// first whatever order the accumulator layout delivers them in: one entry
// (the common case) is inserted with a ballot and a shuffle; more are
// sorted over the lanes (bitonic) and merged with the top-k in one
// bitonic merge.  A row's gate is min_keep_i until it holds k entries,
// then its k-th score + 1: later columns lose every tie.  Each row's
// columns reach its merge in increasing order and the gate moves only
// between lists.  Rows past nq have a gate of INT_MAX; columns past
// ns_valid score INT_MIN.
//
// The engine's shape, dim 128 and k <= 32: topk_kernel_wgmma, warp-
// specialised on warpgroup MMA (wgmma), 384 threads and 512 query rows a
// block, one block an SM.
// - Warpgroup 0 produces: it gives up its registers (setmaxnreg.dec to
//   40) and one thread keeps a ring of kWgStages = 4 tiles in flight, 128
//   script rows (16 KiB) a tile, each one TMA load (cp.async.bulk.tensor
//   from a tensor map over s, the 128-byte swizzle wgmma's descriptor
//   reads, rows past ns_valid read 0), signalled on a full mbarrier and
//   freed on an empty one that the 8 consumer warps arrive on.  No
//   all-thread copies and no block barrier a tile.
// - Warpgroups 1 and 2 consume (setmaxnreg.inc to 232), 256 rows each:
//   four m64 tiles, their A fragments in registers for the whole walk (64
//   registers).  A step is 64 columns: 16 wgmma.mma_async m64n64k32 s8 (4
//   tiles x 4 k-steps) into 128 s32 accumulators a thread, B from the
//   ring slot, one commit group waited for before the step's epilogue.
// - Overlap: the two consumer warpgroups run unordered, so one's epilogue
//   runs while the other's products keep the tensor cores busy.  Measured
//   at 2^20 x 2^20: products alone (epilogue cut) 96.8% of the bound, with
//   the epilogue 84.5-84.9%.  The row maxima are a tree of 3-way maxima
//   (depth 3, no branch), since a short-circuit or a serial chain there
//   put the epilogue on the tensor cores' path (70%).  Lists and merges
//   run per m64 tile, 16 rows a warp, a 32-column half at a time, so
//   shared memory holds the ring, the top-k keys [512][k] and 16-row
//   lists: 213 KiB at k 32.
// - L2: every block reads the whole script once, and 512 query rows share
//   each tile, 0.25 L2 bytes a score (1.9 TB/s at the int8 peak; 256 rows
//   a block would need 3.9 TB/s).  The products-only rate shows the L2
//   keeps up, so no cluster multicast.
// - Small batches: where the row blocks fill fewer blocks than the card
//   has SMs, the wrapper (ops/distance_topk.py wgmma_splits) cuts the
//   script's tiles into column ranges (blockIdx.y), each block writes its
//   rows' top-k keys to part, and topk_kernel_merge merges each row's
//   ranges bitonically: 2,048 x 2^20 in 0.347 ms, 80% of its bound, where
//   one range a row block took 16.4 ms.
// Every kernel of K2's entry points carries topk_kernel in its name: the
// benchmark's k2_roofline.sweep sums exactly those kernels' device time.
//
// Other shapes keep the mma.sync producer of int8_tiles.cuh (topk_kernel,
// 256 rows a block, 64 a warp, a cp.async ring), each a template
// instantiation: wgmma's register-resident A and 128-byte rows fit dim
// 128 only, and above k 32 the top-k outgrows a warp's lanes and the
// block's shared memory.  No engine or benchmark shape takes them.
// - dim any multiple of 128 other than 128: the chunked producer (k-chunks
//   of 128 bytes, A reloaded per chunk).
// - k > 32: a row's top-k (score, column) lives in its own rows of the
//   outputs, vals as int32 scores until the end, and each step's list is
//   merged into it by the warp (merge_row_big).  Same keys, same gate, so
//   the same slots.
#include <cfloat>
#include <climits>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "int8_tiles.cuh"

namespace {

using namespace tiles;

constexpr long long kEmpty = LLONG_MIN;

__device__ __forceinline__ long long make_key(int score, int col) {
  return static_cast<long long>(
      (static_cast<unsigned long long>(static_cast<long long>(score)) << 32) |
      (0xffffffffu - static_cast<unsigned>(col)));
}

__device__ __forceinline__ int key_score(long long key) { return static_cast<int>(key >> 32); }

__device__ __forceinline__ int key_col(long long key) {
  return static_cast<int>(0xffffffffu - static_cast<unsigned>(key & 0xffffffffll));
}

// Shared memory: the ring, lists [kBlockRows][kSubCols], top-k keys
// [kBlockRows][k] (small k only), counts and gates.
size_t smem_bytes(int k, bool chunked, bool big) {
  return static_cast<size_t>(chunked ? kCRingBytes : kRingBytes) +
         sizeof(int) * kBlockRows * kSubCols + (big ? 0 : sizeof(long long) * kBlockRows * k) +
         2 * sizeof(int) * kBlockRows;
}

// Merge one row's list (n >= 1 entries of the step starting at c0) into
// its top-k (k keys, best first); returns the row's new gate.
__device__ __forceinline__ int merge_row(long long* __restrict__ top, const int* __restrict__ list,
                                         int n, int k, int c0, int min_keep_i, int lane) {
  long long b = kEmpty;
  if (lane < n) {
    const int p = list[lane];
    b = make_key(p >> 5, c0 + 31 - (p & 31));
  }
  long long a = lane < k ? top[lane] : kEmpty;
  if (n == 1) {
    // one entry (the common case): insert it after every better key; it
    // passed the gate, so it beats the k-th
    const long long e = __shfl_sync(kFull, b, 0);
    const int p = __popc(__ballot_sync(kFull, lane < k && a > e));
    const long long up = __shfl_up_sync(kFull, a, 1);
    if (lane >= p) a = lane == p ? e : up;
  } else {
    // the list, descending
#pragma unroll
    for (int w = 2; w <= 32; w <<= 1) {
#pragma unroll
      for (int j = w >> 1; j > 0; j >>= 1) {
        const long long o = __shfl_xor_sync(kFull, b, j);
        const bool keep_max = ((lane & w) == 0) == ((lane & j) == 0);
        b = keep_max ? (o > b ? o : b) : (o < b ? o : b);
      }
    }
    // the 32 best of top ++ list, a bitonic sequence; then sorted
    const long long rev = __shfl_sync(kFull, b, 31 - lane);
    a = a > rev ? a : rev;
#pragma unroll
    for (int j = 16; j > 0; j >>= 1) {
      const long long o = __shfl_xor_sync(kFull, a, j);
      a = (lane & j) == 0 ? (o > a ? o : a) : (o < a ? o : a);
    }
  }
  if (lane < k) top[lane] = a;
  const long long kth = __shfl_sync(kFull, a, k - 1);
  return kth == kEmpty ? min_keep_i : max(min_keep_i, key_score(kth) + 1);
}

// k > 32: merge one row's list (n >= 1 entries of the step starting at
// c0) into its top-k held in device memory (sc int32 scores, INT_MIN when
// empty, col columns; best first); returns the row's new gate.  The list
// is sorted over the lanes; each entry finds its place by a binary search
// of the top-k (its rank there plus its lane); then the slots from the
// best entry's place on move down by the number of entries that beat
// them, 32 at a time from the highest, and the entries are written.
__device__ __forceinline__ int merge_row_big(int* sc, int* col, const int* __restrict__ list,
                                             int n, int k, int c0, int min_keep_i, int lane) {
  long long e = kEmpty;
  if (lane < n) {
    const int p = list[lane];
    e = make_key(p >> 5, c0 + 31 - (p & 31));
  }
  // the list, descending (lanes >= n hold kEmpty, last)
#pragma unroll
  for (int w = 2; w <= 32; w <<= 1) {
#pragma unroll
    for (int j = w >> 1; j > 0; j >>= 1) {
      const long long o = __shfl_xor_sync(kFull, e, j);
      const bool keep_max = ((lane & w) == 0) == ((lane & j) == 0);
      e = keep_max ? (o > e ? o : e) : (o < e ? o : e);
    }
  }
  int lo = 0;  // slots holding a better key (an empty slot's key is below every entry's)
  if (lane < n) {
    int hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (make_key(sc[mid], col[mid]) > e) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
  }
  const int pos = lo + lane;  // the entry's place in the merged top-k
  const int p0 = __shfl_sync(kFull, pos, 0);
  for (int base = (k - 1) & ~31; base >= (p0 & ~31); base -= 32) {
    const int j = base + lane;
    const bool mv = j >= p0 && j < k;
    int vs = INT_MIN, vc = 0;
    if (mv) {
      vs = sc[j];
      vc = col[j];
    }
    const long long t = make_key(vs, vc);
    int c = 0;  // entries that beat slot j
    for (int i = 0; i < n; ++i) c += __shfl_sync(kFull, e, i) > t;
    __syncwarp();  // every lane has read its slot
    if (mv && j + c < k) {
      sc[j + c] = vs;
      col[j + c] = vc;
    }
    __syncwarp();
  }
  if (lane < n && pos < k) {
    sc[pos] = key_score(e);
    col[pos] = key_col(e);
  }
  __syncwarp();
  const int kth = sc[k - 1];
  return kth == INT_MIN ? min_keep_i : max(min_keep_i, kth + 1);
}

// CHUNKED: dim != 128 (walk_script_chunked); BIG: k > 32 (top-k in the
// outputs).
template <bool CHUNKED, bool BIG>
__global__ void __launch_bounds__(kThreads, 2)
topk_kernel(const int8_t* __restrict__ q,  // [nq, dim]
            const int8_t* __restrict__ s,  // [>= ns, dim]
            float* vals,                   // [nq, k] (BIG: the top-k scores as int32 first)
            int* idx,                      // [nq, k]
            long long nq, int ns, int dim, int k, int min_keep_i, float inv_dim) {
  constexpr int kRing = CHUNKED ? kCRingBytes : kRingBytes;
  constexpr int kTopK = BIG ? 0 : 1;  // top-k keys in shared memory
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint8_t* ring = smem;
  // this warp's rows: lists [64][32], top-k keys [64][k], counts, gates
  int* list = reinterpret_cast<int*>(smem + kRing) + warp * kWarpRows * kSubCols;
  long long* top = reinterpret_cast<long long*>(
                       smem + kRing + sizeof(int) * kBlockRows * kSubCols) +
                   warp * kWarpRows * k * kTopK;
  int* cnt = reinterpret_cast<int*>(smem + kRing + sizeof(int) * kBlockRows * kSubCols +
                                    sizeof(long long) * kBlockRows * k * kTopK) +
             warp * kWarpRows;
  int* gate_s = cnt + kBlockRows;
  // BIG: the rows' top-k scores (as int32) and columns, in the outputs
  int* top_sc = reinterpret_cast<int*>(vals);

  const long long r0 = static_cast<long long>(blockIdx.x) * kBlockRows + warp * kWarpRows;
  const long long rows = nq - r0 < kWarpRows ? nq - r0 : kWarpRows;
  if constexpr (BIG) {
    for (long long e = lane; e < rows * k; e += 32) {
      top_sc[r0 * k + e] = INT_MIN;
      idx[r0 * k + e] = 0;
    }
  } else {
    for (int e = lane; e < kWarpRows * k; e += 32) top[e] = kEmpty;
  }
  for (int r = lane; r < kWarpRows; r += 32) {
    cnt[r] = 0;
    gate_s[r] = r0 + r < nq ? min_keep_i : INT_MAX;
  }
  __syncwarp();
  int gate[kMT][2];  // the gates of this thread's 8 rows
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    gate[mt][0] = gate_s[mt * 16 + (lane >> 2)];
    gate[mt][1] = gate_s[mt * 16 + (lane >> 2) + 8];
  }
  auto epi = [&](Acc& acc, int c0) {
    bool pass = false;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) pass |= row_max(acc, mt, hi) >= gate[mt][hi];
    if (!__any_sync(kFull, pass)) return;
    // the step's passing scores to their rows' lists
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = mt * 16 + (lane >> 2) + 8 * hi;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int v = acc[mt][nt][2 * hi + e];
            if (v >= gate[mt][hi]) {
              const int p = atomicAdd(&cnt[r], 1);
              list[r * kSubCols + p] = v * 32 + (31 - (nt * 8 + 2 * (lane & 3) + e));
            }
          }
      }
    __syncwarp();
    // merge every row with entries, lowest row first
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      unsigned todo = __ballot_sync(kFull, cnt[half * 32 + lane] > 0);
      while (todo) {
        const int r = half * 32 + __ffs(todo) - 1;
        todo &= todo - 1;
        int g;
        if constexpr (BIG) {
          g = merge_row_big(top_sc + (r0 + r) * k, idx + (r0 + r) * k, list + r * kSubCols,
                            cnt[r], k, c0, min_keep_i, lane);
        } else {
          g = merge_row(top + r * k, list + r * kSubCols, cnt[r], k, c0, min_keep_i, lane);
        }
        __syncwarp();
        if (lane == 0) {
          cnt[r] = 0;
          gate_s[r] = g;
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      gate[mt][0] = gate_s[mt * 16 + (lane >> 2)];
      gate[mt][1] = gate_s[mt * 16 + (lane >> 2) + 8];
    }
  };
  if constexpr (CHUNKED) {
    walk_script_chunked(ring, q, nq, r0, s, ns, dim, lane, epi);
  } else {
    AFrag a;
    load_a(a, q, nq, r0, lane);
    walk_script(ring, s, ns, a, lane, epi);
  }

  // the warp's rows are contiguous in the outputs
  __syncwarp();
  for (long long e = lane; e < rows * k; e += 32) {
    if constexpr (BIG) {
      const int sc = top_sc[r0 * k + e];
      vals[r0 * k + e] = sc == INT_MIN ? -FLT_MAX : static_cast<float>(sc) * inv_dim;
    } else {
      const long long key = top[e];
      const bool empty = key == kEmpty;
      vals[r0 * k + e] = empty ? -FLT_MAX : static_cast<float>(key_score(key)) * inv_dim;
      idx[r0 * k + e] = empty ? 0 : key_col(key);
    }
  }
}

// ---- the engine's shape, dim 128 and k <= 32: warpgroup MMA ----

constexpr int kWgTiles = kMT;                        // m64 tiles a consumer warpgroup
constexpr int kConsumers = 2;                        // consumer warpgroups
constexpr int kWgRows = 64 * kWgTiles;               // rows a consumer warpgroup
constexpr int kWgBlockRows = kWgRows * kConsumers;   // rows a block
constexpr int kCWarps = 4 * kConsumers;              // consumer warps
constexpr int kWgThreads = 128 * (kConsumers + 1);   // a producer warpgroup first
constexpr int kWgTileCols = 128;                     // script rows a TMA tile
constexpr int kWgStages = 4;                         // ring slots
constexpr int kWgSlot = kWgTileCols * kDim;          // bytes a slot
constexpr int kWgN = 64;                             // columns a step
constexpr int kWgNT = kWgN / 8;                      // n8 tiles a step
constexpr int kWgSteps = kWgTileCols / kWgN;         // steps a tile
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kMergeWarps = 8;

using WgAcc = int[kWgTiles][kWgNT][4];  // [m64 tile][n8 tile][register]

// Shared memory: slack to align the ring to 1,024 bytes, the ring, top-k
// keys [kWgBlockRows][k], the ring's barriers, one 16-row list [16][32] a
// consumer warp, counts [16] a consumer warp, gates [kWgBlockRows].
size_t wg_smem_bytes(int k) {
  return 1024 + static_cast<size_t>(kWgStages) * kWgSlot +
         sizeof(long long) * kWgBlockRows * k + 2 * kWgStages * sizeof(uint64_t) +
         sizeof(int) * kCWarps * 16 * kSubCols + sizeof(int) * kCWarps * 16 +
         sizeof(int) * kWgBlockRows;
}

// The largest of a thread's 16 scores of one of its rows (hi) in an m64
// tile: a tree of 3-way maxima (depth 3), so the rows' reductions interleave.
__device__ __forceinline__ int wg_row_max(const int (&d)[kWgNT][4], int hi) {
  static_assert(kWgNT == 8, "a step of 64 columns");
  const int a = 2 * hi;
  const int b = a + 1;
  const int x0 = __vimax3_s32(d[0][a], d[0][b], d[1][a]);
  const int x1 = __vimax3_s32(d[1][b], d[2][a], d[2][b]);
  const int x2 = __vimax3_s32(d[3][a], d[3][b], d[4][a]);
  const int x3 = __vimax3_s32(d[4][b], d[5][a], d[5][b]);
  const int x4 = __vimax3_s32(d[6][a], d[6][b], d[7][a]);
  return max(__vimax3_s32(x0, x1, x2), __vimax3_s32(x3, x4, d[7][b]));
}

// Block (x, y): rows [x * kWgBlockRows, + kWgBlockRows) against the script
// tiles [y * tiles_per_split, + tiles_per_split).  With part null the
// rows' top-k go to vals and idx; else their keys go to part [splits][nq]
// [k] for topk_kernel_merge.
__global__ void __launch_bounds__(kWgThreads, 1)
topk_kernel_wgmma(__grid_constant__ const CUtensorMap s_map,  // s [ns, 128] int8, box 128 x 128
                  const int8_t* __restrict__ q,              // [nq, 128]
                  float* vals, int* idx,                     // [nq, k]
                  long long* part,                           // [splits, nq, k] or null
                  long long nq, int ns, int k, int min_keep_i, float inv_dim,
                  int tiles_per_split) {
  using namespace hopper;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;
  long long* top_all = reinterpret_cast<long long*>(smem + kWgStages * kWgSlot);
  uint64_t* full = reinterpret_cast<uint64_t*>(top_all + kWgBlockRows * k);
  uint64_t* empty = full + kWgStages;
  int* list_all = reinterpret_cast<int*>(empty + kWgStages);
  int* cnt_all = list_all + kCWarps * 16 * kSubCols;
  int* gate_all = cnt_all + kCWarps * 16;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int ntiles = (ns + kWgTileCols - 1) / kWgTileCols;
  const int t0 = blockIdx.y * tiles_per_split;
  const int t1 = min(ntiles, t0 + tiles_per_split);
  const int col_end = min(ns, t1 * kWgTileCols);
  // consumer warp cw: rows r0 + mt * 64 + [0, 16) of m64 tile mt, local
  // rows mt * 16 + [0, 16) in its state
  const int cw = warp - 4;
  const long long r0 = static_cast<long long>(blockIdx.x) * kWgBlockRows +
                       (wg - 1) * kWgRows + 16 * (warp & 3);
  long long* top = top_all + cw * 64 * k;
  int* list = list_all + cw * 16 * kSubCols;
  int* cnt = cnt_all + cw * 16;
  int* gate_s = gate_all + cw * 64;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kWgStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kCWarps);
    }
    mbar_init_fence();
  }
  if (wg > 0) {
    for (int e = lane; e < 64 * k; e += 32) top[e] = kEmpty;
    if (lane < 16) cnt[lane] = 0;
    for (int r = lane; r < 64; r += 32)
      gate_s[r] = r0 + (r >> 4) * 64 + (r & 15) < nq ? min_keep_i : INT_MAX;
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps kWgStages tiles in flight
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      for (int t = t0, i = 0; t < t1; ++t, ++i) {
        const int st = i % kWgStages;
        if (i >= kWgStages) mbar_wait(&empty[st], ((i / kWgStages) - 1) & 1);
        mbar_expect_tx(&full[st], kWgSlot);
        tma_load_2d(ring + st * kWgSlot, &s_map, &full[st], 0, t * kWgTileCols);
      }
    }
    return;
  }

  // consumers
  setmaxnreg_inc<kConsumerRegs>();
  AFrag a;
  load_a(a, q, nq, r0, lane, kDim, 0, 64);
  int gate[kWgTiles][2];  // the gates of this thread's 8 rows
#pragma unroll
  for (int mt = 0; mt < kWgTiles; ++mt) {
    gate[mt][0] = gate_s[mt * 16 + (lane >> 2)];
    gate[mt][1] = gate_s[mt * 16 + (lane >> 2) + 8];
  }
  auto epi = [&](WgAcc& acc, int c0) {
    unsigned mine = 0;
#pragma unroll
    for (int mt = 0; mt < kWgTiles; ++mt) {
      // both rows, no short circuit: a branch here serialises the rows
      const unsigned p = static_cast<unsigned>(wg_row_max(acc[mt], 0) >= gate[mt][0]) |
                         static_cast<unsigned>(wg_row_max(acc[mt], 1) >= gate[mt][1]);
      mine |= p << mt;
    }
    const unsigned need = __reduce_or_sync(kFull, mine);
    if (!need) return;
#pragma unroll
    for (int mt = 0; mt < kWgTiles; ++mt) {
      if (!((need >> mt) & 1u)) continue;
#pragma unroll
      for (int h = 0; h < kWgN / kSubCols; ++h) {
        // the passing scores of columns [c0 + 32 h, + 32) of the tile's 16
        // rows to their lists
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int r = (lane >> 2) + 8 * hi;
          const int g = gate_s[mt * 16 + r];
#pragma unroll
          for (int nt = h * 4; nt < h * 4 + 4; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int v = acc[mt][nt][2 * hi + e];
              if (v >= g) {
                const int p = atomicAdd(&cnt[r], 1);
                list[r * kSubCols + p] = v * 32 + (31 - ((nt - h * 4) * 8 + 2 * (lane & 3) + e));
              }
            }
        }
        __syncwarp();
        // merge every row with entries, lowest row first
        unsigned todo = __ballot_sync(kFull, lane < 16 && cnt[lane] > 0);
        while (todo) {
          const int r = __ffs(todo) - 1;
          todo &= todo - 1;
          const int g = merge_row(top + (mt * 16 + r) * k, list + r * kSubCols, cnt[r], k,
                                  c0 + h * kSubCols, min_keep_i, lane);
          __syncwarp();
          if (lane == 0) {
            cnt[r] = 0;
            gate_s[mt * 16 + r] = g;
          }
        }
        __syncwarp();
      }
      gate[mt][0] = gate_s[mt * 16 + (lane >> 2)];
      gate[mt][1] = gate_s[mt * 16 + (lane >> 2) + 8];
    }
  };

  // step j of the walk: columns [c0, c0 + kWgN) of tile t0 + j / kWgSteps
  const int nsteps = col_end > t0 * kWgTileCols
                         ? (col_end - t0 * kWgTileCols + kWgN - 1) / kWgN : 0;
  auto pin_all = [](WgAcc& acc) {
#pragma unroll
    for (int mt = 0; mt < kWgTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < kWgNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) pin(acc[mt][nt][e]);
  };
  // start step j's products into acc (one commit group)
  auto start = [&](WgAcc& acc, int j) {
    const int i = j / kWgSteps;
    const int sub = j - i * kWgSteps;
    const int st = i % kWgStages;
    if (sub == 0) mbar_wait(&full[st], (i / kWgStages) & 1);
    const uint64_t db = desc_sw128(ring + st * kWgSlot + sub * kWgN * kDim);
    pin_all(acc);
    wgmma_fence();
#pragma unroll
    for (int mt = 0; mt < kWgTiles; ++mt)
#pragma unroll
      for (int ks = 0; ks < kDim / 32; ++ks) wgmma_n64(acc[mt], a[mt][ks], db + 2 * ks, ks);
    wgmma_commit();
  };
  // step j's products have landed in acc
  auto finish = [&](WgAcc& acc, int j) {
    pin_all(acc);
    const int i = j / kWgSteps;
    const int sub = j - i * kWgSteps;
    const int c0 = (t0 + i) * kWgTileCols + sub * kWgN;
    // the slot's last step has read it: hand it back to the producer
    if (sub + 1 == kWgSteps || j + 1 == nsteps) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[i % kWgStages]);
    }
    if (c0 + kWgN > col_end) {
      // columns >= col_end score INT_MIN, below every gate
#pragma unroll
      for (int nt = 0; nt < kWgNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool out = c0 + nt * 8 + 2 * (lane & 3) + (e & 1) >= col_end;
#pragma unroll
          for (int mt = 0; mt < kWgTiles; ++mt)
            if (out) acc[mt][nt][e] = INT_MIN;
        }
    }
    epi(acc, c0);
  };
  // the other consumer warpgroup's products run while this one's epilogue
  // runs
  WgAcc acc;
#pragma unroll 1
  for (int j = 0; j < nsteps; ++j) {
    start(acc, j);
    wgmma_wait<0>();
    finish(acc, j);
  }

  // tile mt's 16 rows of this warp are contiguous in the outputs
  __syncwarp();
#pragma unroll 1
  for (int mt = 0; mt < kWgTiles; ++mt) {
    const long long row0 = r0 + mt * 64;
    const long long rows = nq - row0 < 16 ? nq - row0 : 16;
    for (long long e = lane; e < rows * k; e += 32) {
      const long long key = top[mt * 16 * k + e];
      if (part != nullptr) {
        part[(blockIdx.y * nq + row0) * k + e] = key;
      } else {
        const bool none = key == kEmpty;
        vals[row0 * k + e] = none ? -FLT_MAX : static_cast<float>(key_score(key)) * inv_dim;
        idx[row0 * k + e] = none ? 0 : key_col(key);
      }
    }
  }
}

// Each row's top-k from its splits' (part [splits][nq][k], keys best
// first): one warp a row merges them in turn, bitonically, lane i holding
// slot i.
__global__ void __launch_bounds__(32 * kMergeWarps)
topk_kernel_merge(const long long* __restrict__ part, float* vals, int* idx, long long nq, int k,
                  int splits, float inv_dim) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kMergeWarps + (threadIdx.x >> 5);
  if (row >= nq) return;
  long long a = kEmpty;
  for (int j = 0; j < splits; ++j) {
    const long long b = lane < k ? part[(j * nq + row) * k + lane] : kEmpty;
    // the 32 best of a ++ b (both descending), a bitonic sequence; sorted
    const long long rev = __shfl_sync(kFull, b, 31 - lane);
    a = a > rev ? a : rev;
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) {
      const long long o = __shfl_xor_sync(kFull, a, w);
      a = (lane & w) == 0 ? (o > a ? o : a) : (o < a ? o : a);
    }
  }
  if (lane < k) {
    const bool none = a == kEmpty;
    vals[row * k + lane] = none ? -FLT_MAX : static_cast<float>(key_score(a)) * inv_dim;
    idx[row * k + lane] = none ? 0 : key_col(a);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult qr;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &qr) != cudaSuccess ||
        qr != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

int launch_wgmma(const void* q, const void* s, void* vals, void* idx, void* part, long long nq,
                 int ns_valid, int k, int min_keep_i, float inv_dim, int splits,
                 cudaStream_t stream) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // s as a 2-D map of bytes, rows ns_valid (TMA reads 0 past them), boxes
  // of 128 rows under the 128-byte swizzle
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kDim),
                              static_cast<cuuint64_t>(ns_valid > 0 ? ns_valid : 1)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kDim)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kDim), static_cast<cuuint32_t>(kWgTileCols)};
  const cuuint32_t estr[2] = {1, 1};
  if (enc(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(s), dims, strides, box, estr,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = wg_smem_bytes(k);
  cudaError_t e = cudaFuncSetAttribute(topk_kernel_wgmma,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ntiles = (ns_valid + kWgTileCols - 1) / kWgTileCols;
  const int tps = (ntiles + splits - 1) / splits;
  const dim3 grid(static_cast<unsigned>((nq + kWgBlockRows - 1) / kWgBlockRows),
                  static_cast<unsigned>(splits));
  topk_kernel_wgmma<<<grid, kWgThreads, smem, stream>>>(
      map, static_cast<const int8_t*>(q), static_cast<float*>(vals), static_cast<int*>(idx),
      splits > 1 ? static_cast<long long*>(part) : nullptr, nq, ns_valid, k, min_keep_i, inv_dim,
      tps);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  topk_kernel_merge<<<static_cast<unsigned>((nq + kMergeWarps - 1) / kMergeWarps),
                      32 * kMergeWarps, 0, stream>>>(static_cast<const long long*>(part),
                                                     static_cast<float*>(vals),
                                                     static_cast<int*>(idx), nq, k, splits,
                                                     inv_dim);
  return static_cast<int>(cudaGetLastError());
}

template <bool CHUNKED, bool BIG>
int launch(const void* q, const void* s, void* vals, void* idx, long long nq, int ns_valid,
           int dim, int k, int min_keep_i, float inv_dim, cudaStream_t stream) {
  const size_t smem = smem_bytes(k, CHUNKED, BIG);
  const cudaError_t e = cudaFuncSetAttribute(topk_kernel<CHUNKED, BIG>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (nq + kBlockRows - 1) / kBlockRows;
  topk_kernel<CHUNKED, BIG><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(s), static_cast<float*>(vals),
      static_cast<int*>(idx), nq, ns_valid, dim, k, min_keep_i, inv_dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q int8 [nq, dim], s int8 [>= ns_valid, dim] (both 16-byte aligned),
// vals f32 [nq, k], idx int32 [nq, k].  dim a positive multiple of 128
// other than 128, or k > 32 (the engine's shape is fs_topk_wgmma's); the
// Python wrapper routes and checks, other values return
// cudaErrorInvalidValue.
extern "C" int fs_topk(const void* q, const void* s, void* vals, void* idx,
                       long long nq, int ns_valid, int dim, int k,
                       int min_keep_i, float inv_dim, void* stream) {
  if (dim < kDim || dim % kDim != 0 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool chunked = dim != kDim;
  const bool big = k > 32;
  if (!chunked && !big) return static_cast<int>(cudaErrorInvalidValue);
  if (!chunked)
    return launch<false, true>(q, s, vals, idx, nq, ns_valid, dim, k, min_keep_i, inv_dim, st);
  if (!big)
    return launch<true, false>(q, s, vals, idx, nq, ns_valid, dim, k, min_keep_i, inv_dim, st);
  return launch<true, true>(q, s, vals, idx, nq, ns_valid, dim, k, min_keep_i, inv_dim, st);
}

// The engine's shape: dim 128, 1 <= k <= 32, the arguments of fs_topk, then
// part int64 [splits, nq, k] (used when splits > 1) and splits >= 1, the
// script's tiles cut into that many column ranges.
extern "C" int fs_topk_wgmma(const void* q, const void* s, void* vals, void* idx,
                             long long nq, int ns_valid, int dim, int k,
                             int min_keep_i, float inv_dim, void* part, int splits,
                             void* stream) {
  if (dim != kDim || k < 1 || k > 32 || splits < 1 || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_wgmma(q, s, vals, idx, part, nq, ns_valid, k, min_keep_i, inv_dim, splits,
                      static_cast<cudaStream_t>(stream));
}
