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
// 1,979 TOP/s (2.58 ms for a 2^20-row batch against 19,033 script rows).
// The outputs (NQ * k * 8 B) and the script (NS * dim B) are small
// beside that.
//
// Design.  Scores come from the shared producer in int8_tiles.cuh:
// mma.sync m16n8k32 s8, 256 query rows a block (64 a warp, A fragments
// in registers for the whole walk), script tiles through a 3-slot
// cp.async ring.  The ring tile is read by every block, 10 GB of L2
// reads per 2^20-row batch.  Per 32-column step the epilogue is:
// - Common path: a thread's 8 scores of each of its 8 rows reduce to a
//   row maximum with 3-way integer max (4 instructions a row), one
//   compare with the row's gate, and one __any_sync for the warp: about
//   0.7 integer instructions a score.  When no score of the warp's 64
//   rows reaches its row's gate, nothing touches shared memory.
// - Otherwise every score >= its row's gate goes to the row's list in
//   shared memory (one entry per column of the step, so it cannot
//   overflow), packed score * 32 + (31 - column in the step).  Each row
//   whose list is not empty is then merged into its top-k by the warp
//   (lane i holds slot i), on 64-bit keys score * 2^32 + (2^32 - 1 -
//   column), so equal scores rank the lower column first whatever order
//   the accumulator layout delivers them in: one entry (the common case)
//   is inserted with a ballot and a shuffle; more are sorted over the
//   lanes (bitonic) and merged with the top-k in one bitonic merge.
// - A row's gate is min_keep_i until it holds k entries, then its k-th
//   score + 1: later steps hold only higher columns, which lose every
//   tie.  The gate moves only between steps.  Sparse real rows merge
//   almost never; rows that pass often (the zero tokens padding a
//   partial batch, the exact top-k) merge early and then stop at a high
//   gate, with no second pass and no fallback.
// Rows past nq have a gate of INT_MAX; columns past ns_valid score
// INT_MIN.
// Other shapes, each a template instantiation beside the engine's (dim
// 128, k <= 32), which keeps its code:
// - dim any multiple of 128 other than 128: the chunked producer of
//   int8_tiles.cuh (k-chunks of 128 bytes, A reloaded per chunk).
// - k > 32: a row's top-k (score, column) lives in its own rows of the
//   outputs, vals as int32 scores until the end, and each step's list is
//   merged into it by the warp (merge_row_big).  Same keys, same gate, so
//   the same slots.
#include <cfloat>
#include <climits>
#include <cstdint>
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
// and k >= 1 are checked by the Python wrapper; other values return
// cudaErrorInvalidValue.
extern "C" int fs_topk(const void* q, const void* s, void* vals, void* idx,
                       long long nq, int ns_valid, int dim, int k,
                       int min_keep_i, float inv_dim, void* stream) {
  if (dim < kDim || dim % kDim != 0 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool chunked = dim != kDim;
  const bool big = k > 32;
  if (!chunked && !big)
    return launch<false, false>(q, s, vals, idx, nq, ns_valid, dim, k, min_keep_i, inv_dim, st);
  if (!chunked)
    return launch<false, true>(q, s, vals, idx, nq, ns_valid, dim, k, min_keep_i, inv_dim, st);
  if (!big)
    return launch<true, false>(q, s, vals, idx, nq, ns_valid, dim, k, min_keep_i, inv_dim, st);
  return launch<true, true>(q, s, vals, idx, nq, ns_valid, dim, k, min_keep_i, inv_dim, st);
}
