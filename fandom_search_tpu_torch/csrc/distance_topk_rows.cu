// K7 — fused int8 distance + top-k with the row-extraction merge, written
// for Hopper (sm_90a), its scores on the int8 tensor cores.
//
// Replaces: fandom_search_tpu/ops/distance_topk.py, _topk_kernel_rows
// (topk_dot_pallas with merge="rows" and min_keep >= 1).  It computes K2's
// function: per query row, the exact top-k of dot(q, s) over script rows
// [0, ns_valid), ties to the lowest column, as vals = score * inv_dim (f32)
// and idx (int32).  Only scores >= min_keep_i (>= 1) enter; an empty slot
// is (-FLT_MAX, 0).
//
// Bound on this card: the int8 products, 2 * NQ * NS * dim operations, as
// K2.  The merge adds work only on rows whose step maximum beats their
// k-th score, which at the engine's threshold is a small share of them.
//
// Design (the TPU kernel's idea, not its blocks).  The scores come from
// K2's producer (int8_tiles.cuh: mma.sync m16n8k32 s8, 256 query rows a
// block and 64 a warp, A in registers, script tiles through a 3-slot
// cp.async ring; 10 GB of L2 reads per 2^20-row batch).  Each warp owns
// its rows, and per step of kSubCols = 32 columns:
//  (a) Row maxima: a thread's 8 scores of each of its rows reduce with
//      3-way integer max, then two quad shuffles give the row's maximum
//      over the step (about 1 integer instruction a score, 0.25 of them
//      shuffles).
//  (b) Gate: a row is an entrant iff its step maximum is >= min_keep_i
//      and > its current k-th score (strict: an equal score in a later
//      step has a higher column and never enters).  When no row of the
//      warp is an entrant, nothing touches shared memory.  Otherwise the
//      warp writes its 64 x 32 scores to a shared tile of odd pitch.
//  (c) Row merge: for each entrant row, lowest first, the warp runs the
//      TPU kernel's per-row kill loop: lane j holds column j's packed key
//      score * 32 + (31 - j), and each round a warp max (__reduce_max_sync)
//      picks the best score, lower column on ties; it is inserted if it
//      is >= min_keep_i and beats the k-th, and its column is killed.  The
//      first round that inserts nothing ends the loop: every later winner
//      is smaller.  The row's top-k lives in shared memory; the warp holds
//      it in lanes 0..k-1 while it merges, and an insert is a ballot for
//      the slot and one shuffle up.
// Other shapes, each a template instantiation beside the engine's (dim
// 128, k <= 32): dim any other multiple of 128 takes the chunked producer
// of int8_tiles.cuh; k > 32 keeps a row's top-k scores and columns in its
// own rows of the outputs (vals as int32 scores until the end), and an
// insert counts the slots scoring >= the winner (lane-strided) and moves
// the later slots down by one, highest first.
// The TPU kernel's max_rows cap and staged fallback bounded unrolled TPU
// code; here every entrant is merged, so there is none.  Columns past
// ns_valid score INT_MIN and are dead keys; rows past nq never enter.
#include <cfloat>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "int8_tiles.cuh"

namespace {

using namespace tiles;

constexpr int kPitch = kSubCols + 1;  // score-tile row pitch, in ints

// Shared memory: the ring, the score tile, and top-k scores and columns
// [kBlockRows][k] (small k only).
size_t smem_bytes(int k, bool chunked, bool big) {
  return static_cast<size_t>(chunked ? kCRingBytes : kRingBytes) +
         sizeof(int) * (static_cast<size_t>(kBlockRows) * kPitch + (big ? 0 : 2 * kBlockRows * k));
}

// The gate of a row whose k-th score is kth (INT_MIN: fewer than k).
__device__ __forceinline__ int row_gate(int kth, int min_keep_i) {
  return kth == INT_MIN ? min_keep_i : max(min_keep_i, kth + 1);
}

// One warp merges row r's step scores (columns c0 + j) into its top-k.
__device__ __forceinline__ void merge_row(const int* __restrict__ sr, int c0, int k,
                                          int min_keep_i, int* __restrict__ top_sc,
                                          int* __restrict__ top_col, int lane) {
  const int v = sr[lane];
  int key = v == INT_MIN ? INT_MIN : v * 32 + (31 - lane);
  int sc = INT_MIN, col = 0;  // lane i < k holds slot i, best first
  if (lane < k) {
    sc = top_sc[lane];
    col = top_col[lane];
  }
  int kth = __shfl_sync(kFull, sc, k - 1);
  // at most k inserts, then the round that ends the loop
  for (int round = 0; round <= k; ++round) {
    const int m = __reduce_max_sync(kFull, key);
    if (m == INT_MIN) break;  // every column killed, or past ns_valid
    const int ms = m >> 5;
    if (ms < min_keep_i || ms <= kth) break;
    const int mj = 31 - (m & 31);
    // slot: after every entry scoring >= ms (those have lower columns)
    const int p = __popc(__ballot_sync(kFull, lane < k && sc >= ms));
    const int up_sc = __shfl_up_sync(kFull, sc, 1);
    const int up_col = __shfl_up_sync(kFull, col, 1);
    if (lane < k) {
      if (lane == p) {
        sc = ms;
        col = c0 + mj;
      } else if (lane > p) {
        sc = up_sc;
        col = up_col;
      }
    }
    kth = __shfl_sync(kFull, sc, k - 1);
    if (lane == mj) key = INT_MIN;
  }
  if (lane < k) {
    top_sc[lane] = sc;
    top_col[lane] = col;
  }
}

// k > 32: one warp merges row r's step scores into its top-k held in
// device memory (top_sc int32 scores, INT_MIN when empty; top_col).
__device__ __forceinline__ void merge_row_big(const int* __restrict__ sr, int c0, int k,
                                              int min_keep_i, int* top_sc, int* top_col,
                                              int lane) {
  const int v = sr[lane];
  int key = v == INT_MIN ? INT_MIN : v * 32 + (31 - lane);
  int kth = top_sc[k - 1];
  // at most one insert a column, then the round that ends the loop
  for (int round = 0; round <= 32; ++round) {
    const int m = __reduce_max_sync(kFull, key);
    if (m == INT_MIN) break;
    const int ms = m >> 5;
    if (ms < min_keep_i || ms <= kth) break;
    const int mj = 31 - (m & 31);
    // slot: after every entry scoring >= ms (those have lower columns)
    int ge = 0;
    for (int j = lane; j < k; j += 32) ge += top_sc[j] >= ms;
    const int pos = __reduce_add_sync(kFull, ge);
    for (int base = (k - 1) & ~31; base >= (pos & ~31); base -= 32) {
      const int j = base + lane;
      const bool mv = j > pos && j < k;
      int vs = 0, vc = 0;
      if (mv) {
        vs = top_sc[j - 1];
        vc = top_col[j - 1];
      }
      __syncwarp();
      if (mv) {
        top_sc[j] = vs;
        top_col[j] = vc;
      }
      __syncwarp();
    }
    if (lane == 0) {
      top_sc[pos] = ms;
      top_col[pos] = c0 + mj;
    }
    __syncwarp();
    kth = top_sc[k - 1];
    if (lane == mj) key = INT_MIN;
  }
}

// CHUNKED: dim != 128 (walk_script_chunked); BIG: k > 32 (top-k in the
// outputs).
template <bool CHUNKED, bool BIG>
__global__ void __launch_bounds__(kThreads, 2)
topk_rows_kernel(const int8_t* __restrict__ q,  // [nq, dim]
                 const int8_t* __restrict__ s,  // [>= ns, dim]
                 float* vals,                   // [nq, k] (BIG: the top-k scores as int32 first)
                 int* idx,                      // [nq, k]
                 long long nq, int ns, int dim, int k, int min_keep_i, float inv_dim) {
  constexpr int kRing = CHUNKED ? kCRingBytes : kRingBytes;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint8_t* ring = smem;
  const long long r0 = static_cast<long long>(blockIdx.x) * kBlockRows + warp * kWarpRows;
  const long long rows = nq - r0 < kWarpRows ? nq - r0 : kWarpRows;
  // this warp's rows: score tile [64][kPitch], top-k scores and columns
  // [64][k] (in shared memory, or BIG: the warp's rows of the outputs)
  int* score = reinterpret_cast<int*>(smem + kRing) + warp * kWarpRows * kPitch;
  int* top_sc;
  int* top_col;
  if constexpr (BIG) {
    top_sc = reinterpret_cast<int*>(vals) + r0 * k;
    top_col = idx + r0 * k;
    for (long long e = lane; e < rows * k; e += 32) {
      top_sc[e] = INT_MIN;
      top_col[e] = 0;
    }
  } else {
    top_sc = reinterpret_cast<int*>(smem + kRing) + kBlockRows * kPitch + warp * kWarpRows * k;
    top_col = top_sc + kBlockRows * k;
    for (int e = lane; e < kWarpRows * k; e += 32) {
      top_sc[e] = INT_MIN;  // empty slot: below every real score
      top_col[e] = 0;
    }
  }
  int gate[kMT][2];  // the gates of this thread's 8 rows
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
      gate[mt][hi] = r0 + mt * 16 + (lane >> 2) + 8 * hi < nq ? min_keep_i : INT_MAX;
  auto epi = [&](Acc& acc, int c0) {
    // (a) + (b): each row's step maximum over its quad, and the gate
    bool enter[kMT][2];
    bool any = false;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        int m = row_max(acc, mt, hi);
        m = max(m, __shfl_xor_sync(kFull, m, 1));
        m = max(m, __shfl_xor_sync(kFull, m, 2));
        enter[mt][hi] = m >= gate[mt][hi];
        any |= enter[mt][hi];
      }
    if (!__any_sync(kFull, any)) return;
    // the warp's scores to its tile
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          score[(mt * 16 + (lane >> 2) + 8 * (e >> 1)) * kPitch + nt * 8 + 2 * (lane & 3) +
                (e & 1)] = acc[mt][nt][e];
    __syncwarp();
    // (c) entrants, lowest row first: lane 4g of (mt, hi) votes for row
    // mt * 16 + 8 hi + g
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        unsigned todo = __ballot_sync(kFull, enter[mt][hi] && (lane & 3) == 0);
        while (todo) {
          const int r = mt * 16 + 8 * hi + ((__ffs(todo) - 1) >> 2);
          todo &= todo - 1;
          if constexpr (BIG) {
            merge_row_big(score + r * kPitch, c0, k, min_keep_i, top_sc + r * k,
                          top_col + r * k, lane);
          } else {
            merge_row(score + r * kPitch, c0, k, min_keep_i, top_sc + r * k, top_col + r * k,
                      lane);
          }
        }
      }
    __syncwarp();
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = mt * 16 + (lane >> 2) + 8 * hi;
        if (enter[mt][hi]) gate[mt][hi] = row_gate(top_sc[r * k + k - 1], min_keep_i);
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
    const int sc = top_sc[e];
    const bool empty = sc == INT_MIN;
    vals[r0 * k + e] = empty ? -FLT_MAX : static_cast<float>(sc) * inv_dim;
    if constexpr (!BIG) idx[r0 * k + e] = empty ? 0 : top_col[e];
  }
}

template <bool CHUNKED, bool BIG>
int launch(const void* q, const void* s, void* vals, void* idx, long long nq, int ns_valid,
           int dim, int k, int min_keep_i, float inv_dim, cudaStream_t stream) {
  const size_t smem = smem_bytes(k, CHUNKED, BIG);
  const cudaError_t e = cudaFuncSetAttribute(topk_rows_kernel<CHUNKED, BIG>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (nq + kBlockRows - 1) / kBlockRows;
  topk_rows_kernel<CHUNKED, BIG><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(s), static_cast<float*>(vals),
      static_cast<int*>(idx), nq, ns_valid, dim, k, min_keep_i, inv_dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q int8 [nq, dim], s int8 [>= ns_valid, dim] (both 16-byte aligned),
// vals f32 [nq, k], idx int32 [nq, k].  dim a positive multiple of 128,
// k >= 1 and min_keep_i >= 1 are checked by the Python wrapper; other
// values return cudaErrorInvalidValue.
extern "C" int fs_topk_rows(const void* q, const void* s, void* vals, void* idx,
                            long long nq, int ns_valid, int dim, int k,
                            int min_keep_i, float inv_dim, void* stream) {
  if (dim < kDim || dim % kDim != 0 || k < 1 || min_keep_i < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
