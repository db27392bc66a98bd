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

size_t smem_bytes(int k) {
  return static_cast<size_t>(kRingBytes) +
         sizeof(int) * (static_cast<size_t>(kBlockRows) * kPitch + 2 * kBlockRows * k);
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

__global__ void __launch_bounds__(kThreads, 2)
topk_rows_kernel(const int8_t* __restrict__ q,  // [nq, 128]
                 const int8_t* __restrict__ s,  // [>= ns, 128]
                 float* __restrict__ vals,      // [nq, k]
                 int* __restrict__ idx,         // [nq, k]
                 long long nq, int ns, int k, int min_keep_i, float inv_dim) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint8_t* ring = smem;
  // this warp's rows: score tile [64][kPitch], top-k scores and columns [64][k]
  int* score = reinterpret_cast<int*>(smem + kRingBytes) + warp * kWarpRows * kPitch;
  int* top_sc = reinterpret_cast<int*>(smem + kRingBytes) + kBlockRows * kPitch +
                warp * kWarpRows * k;
  int* top_col = top_sc + kBlockRows * k;

  const long long r0 = static_cast<long long>(blockIdx.x) * kBlockRows + warp * kWarpRows;
  for (int e = lane; e < kWarpRows * k; e += 32) {
    top_sc[e] = INT_MIN;  // empty slot: below every real score
    top_col[e] = 0;
  }
  int gate[kMT][2];  // the gates of this thread's 8 rows
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
      gate[mt][hi] = r0 + mt * 16 + (lane >> 2) + 8 * hi < nq ? min_keep_i : INT_MAX;
  AFrag a;
  load_a(a, q, nq, r0, lane);

  walk_script(ring, s, ns, a, lane, [&](Acc& acc, int c0) {
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
          merge_row(score + r * kPitch, c0, k, min_keep_i, top_sc + r * k, top_col + r * k,
                    lane);
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
  });

  // the warp's rows are contiguous in the outputs
  __syncwarp();
  const long long rows = nq - r0 < kWarpRows ? nq - r0 : kWarpRows;
  for (long long e = lane; e < rows * k; e += 32) {
    const int sc = top_sc[e];
    const bool empty = sc == INT_MIN;
    vals[r0 * k + e] = empty ? -FLT_MAX : static_cast<float>(sc) * inv_dim;
    idx[r0 * k + e] = empty ? 0 : top_col[e];
  }
}

}  // namespace

// q int8 [nq, dim], s int8 [>= ns_valid, dim] (both 16-byte aligned),
// vals f32 [nq, k], idx int32 [nq, k].  dim == 128, 1 <= k <= 32 and
// min_keep_i >= 1 are checked by the Python wrapper; other values return
// cudaErrorInvalidValue.
extern "C" int fs_topk_rows(const void* q, const void* s, void* vals, void* idx,
                            long long nq, int ns_valid, int dim, int k,
                            int min_keep_i, float inv_dim, void* stream) {
  if (dim != kDim || k < 1 || k > 32 || min_keep_i < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(k);
  const cudaError_t e = cudaFuncSetAttribute(
      topk_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (nq + kBlockRows - 1) / kBlockRows;
  topk_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(s), static_cast<float*>(vals),
      static_cast<int*>(idx), nq, ns_valid, k, min_keep_i, inv_dim);
  return static_cast<int>(cudaGetLastError());
}
