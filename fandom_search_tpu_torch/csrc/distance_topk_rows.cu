// K7 — fused int8 distance + top-k with the row-extraction merge, written
// for Hopper (sm_90a).
//
// Replaces: fandom_search_tpu/ops/distance_topk.py, _topk_kernel_rows
// (topk_dot_pallas with merge="rows" and min_keep >= 1).  It computes K2's
// function: per query row, the exact top-k of dot(q, s) over script rows
// [0, ns_valid), ties to the lowest column, as vals = score * inv_dim (f32)
// and idx (int32).  Only scores >= min_keep_i (>= 1) enter; an empty slot
// is (-FLT_MAX, 0).
//
// Bound on this card: int8 multiply-adds, NQ * NS * dim per call, as K2.
// The merge adds work only on rows whose tile maximum beats their k-th
// score, which at the engine's threshold is a small share of the tiles.
//
// Design (the TPU kernel's idea, not its blocks): one block of 128 threads
// owns 128 query rows (one per thread, its dim int8 values as 32 int32
// words in registers) and walks the script in tiles of kTS columns, staged
// through shared memory as in K2.
//  (a) Scores: each thread computes its row's kTS dots with __dp4a into a
//      shared [128][kTS + 1] int32 tile (the odd pitch keeps both the
//      row-wise writes and the warp's column-wise reads free of bank
//      conflicts) and keeps its row's maximum; columns past ns_valid are
//      written as INT_MIN, below every threshold.
//  (b) Gate: a row is an entrant iff its tile maximum is >= min_keep_i and
//      > its current k-th score (strict: an equal score in a later tile has
//      a higher column and never enters).  Entrants are compacted lowest
//      row first with __ballot_sync / __popc.
//  (c) Row merge: warp w takes entrants w, w + 4, ...  For its row it runs
//      the TPU kernel's per-row kill loop: each round a warp argmax of the
//      packed key score * 256 + (255 - column) over the row's kTS scores
//      (equal scores go to the lower column), an insert if the winner is
//      >= min_keep_i and beats the k-th, and a kill of the winner's column.
//      The first round that inserts nothing ends the loop: every later
//      winner is smaller.  The row's top-k lives in shared memory
//      ([128][k] scores and columns), so any warp can merge any row; the
//      warp holds it in lanes 0..k-1 while it merges, and an insert is a
//      ballot for the slot and one shuffle up.
// The TPU kernel's max_rows cap and staged fallback bounded unrolled TPU
// code; here every entrant is merged by a warp, so there is none.  Tensor
// cores for the scores are later work, as for K2.
#include <cfloat>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;          // query rows per block, one per thread
constexpr int kWarps = kRows / 32;
constexpr int kTS = 64;             // script columns per tile
constexpr int kPitch = kTS + 1;     // score-tile row pitch, in ints
constexpr int kPer = kTS / 32;      // tile columns per lane in a row merge
constexpr int kDW = 32;             // int32 words of one 128-lane int8 row
constexpr int kVec = kDW / 4;       // int4 vectors of one row
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kDead = LLONG_MIN;

size_t smem_bytes(int k) {
  return sizeof(int4) * kTS * kVec +
         sizeof(int) * (static_cast<size_t>(kRows) * kPitch + 2 * kRows * k + kRows + kWarps);
}

// One warp merges tile row r's kTS scores into row r's top-k.
__device__ __forceinline__ void merge_row(int r, int t0, int k, int min_keep_i,
                                          const int* __restrict__ score,
                                          int* __restrict__ top_sc,
                                          int* __restrict__ top_col, int lane) {
  long long key[kPer];
  const int* sr = score + r * kPitch;
#pragma unroll
  for (int v = 0; v < kPer; ++v) {
    const int j = v * 32 + lane;
    key[v] = static_cast<long long>(sr[j]) * 256 + (255 - j);
  }
  int sc = INT_MIN, col = 0;  // lane i < k holds slot i, best first
  if (lane < k) {
    sc = top_sc[r * k + lane];
    col = top_col[r * k + lane];
  }
  int kth = __shfl_sync(kFull, sc, k - 1);
  const long long floor_key = static_cast<long long>(min_keep_i) * 256;
  // at most k inserts, then the round that ends the loop
  for (int round = 0; round <= k; ++round) {
    long long m = key[0];
#pragma unroll
    for (int v = 1; v < kPer; ++v) m = max(m, key[v]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(kFull, m, off));
    if (m < floor_key) break;  // below min_keep_i (or a column past ns_valid)
    const int ms = static_cast<int>(m >> 8);
    if (ms <= kth) break;
    const int mj = 255 - static_cast<int>(m & 255);
    // slot: after every entry scoring >= ms (those have lower columns)
    const int p = __popc(__ballot_sync(kFull, lane < k && sc >= ms));
    const int up_sc = __shfl_up_sync(kFull, sc, 1);
    const int up_col = __shfl_up_sync(kFull, col, 1);
    if (lane < k) {
      if (lane == p) {
        sc = ms;
        col = t0 + mj;
      } else if (lane > p) {
        sc = up_sc;
        col = up_col;
      }
    }
    kth = __shfl_sync(kFull, sc, k - 1);
#pragma unroll
    for (int v = 0; v < kPer; ++v) {
      if (v * 32 + lane == mj) key[v] = kDead;
    }
  }
  if (lane < k) {
    top_sc[r * k + lane] = sc;
    top_col[r * k + lane] = col;
  }
}

__global__ void __launch_bounds__(kRows)
topk_rows_kernel(const int8_t* __restrict__ q,  // [nq, 128]
                 const int8_t* __restrict__ s,  // [>= ns, 128]
                 float* __restrict__ vals,      // [nq, k]
                 int* __restrict__ idx,         // [nq, k]
                 long long nq, int ns, int k, int min_keep_i, float inv_dim) {
  extern __shared__ int4 smem4[];
  int4* stile = smem4;                                       // [kTS][kVec]
  int* score = reinterpret_cast<int*>(stile + kTS * kVec);   // [kRows][kPitch]
  int* top_sc = score + kRows * kPitch;                      // [kRows][k]
  int* top_col = top_sc + kRows * k;                         // [kRows][k]
  int* ent = top_col + kRows * k;                            // [kRows]
  int* wcnt = ent + kRows;                                   // [kWarps]

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long row = static_cast<long long>(blockIdx.x) * kRows + t;
  const bool active = row < nq;

  int qw[kDW];
  if (active) {
    const int4* qr = reinterpret_cast<const int4*>(q) + row * kVec;
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      const int4 v = qr[c];
      qw[4 * c] = v.x;
      qw[4 * c + 1] = v.y;
      qw[4 * c + 2] = v.z;
      qw[4 * c + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < kDW; ++c) qw[c] = 0;
  }
  for (int i = 0; i < k; ++i) {
    top_sc[t * k + i] = INT_MIN;  // empty slot: below every real score
    top_col[t * k + i] = 0;
  }

  const int4* s4 = reinterpret_cast<const int4*>(s);
  int* my = score + t * kPitch;
  for (int t0 = 0; t0 < ns; t0 += kTS) {
    const int cols = min(kTS, ns - t0);
    // the previous tile's merges are done: the stage, the score tile and
    // the top lists are free to read and write
    __syncthreads();
    for (int i = t; i < cols * kVec; i += kRows) {
      stile[i] = s4[static_cast<long long>(t0) * kVec + i];
    }
    __syncthreads();

    // (a) scores
    int rmax = INT_MIN;
#pragma unroll 2
    for (int j = 0; j < kTS; ++j) {
      int dot = INT_MIN;  // past ns_valid: never enters
      if (j < cols) {
        const int4* sr = stile + j * kVec;
        dot = 0;
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          const int4 v = sr[c];
          dot = __dp4a(qw[4 * c], v.x, dot);
          dot = __dp4a(qw[4 * c + 1], v.y, dot);
          dot = __dp4a(qw[4 * c + 2], v.z, dot);
          dot = __dp4a(qw[4 * c + 3], v.w, dot);
        }
        rmax = max(rmax, dot);
      }
      my[j] = dot;
    }

    // (b) gate, and the entrants compacted lowest row first
    const bool enter = active && rmax >= min_keep_i && rmax > top_sc[t * k + k - 1];
    const unsigned bal = __ballot_sync(kFull, enter);
    if (lane == 0) wcnt[warp] = __popc(bal);
    __syncthreads();
    int base = 0, n_ent = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) base += wcnt[w];
      n_ent += wcnt[w];
    }
    if (enter) ent[base + __popc(bal & ((1u << lane) - 1u))] = t;
    __syncthreads();

    // (c) one warp per entrant row
    for (int e = warp; e < n_ent; e += kWarps) {
      merge_row(ent[e], t0, k, min_keep_i, score, top_sc, top_col, lane);
    }
  }
  __syncthreads();
  if (!active) return;
  for (int i = 0; i < k; ++i) {
    const int sc = top_sc[t * k + i];
    const bool empty = sc == INT_MIN;
    vals[row * k + i] = empty ? -FLT_MAX : static_cast<float>(sc) * inv_dim;
    idx[row * k + i] = empty ? 0 : top_col[t * k + i];
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
  if (dim != 128 || k < 1 || k > 32 || min_keep_i < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(k);
  const cudaError_t e = cudaFuncSetAttribute(
      topk_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (nq + kRows - 1) / kRows;
  topk_rows_kernel<<<static_cast<unsigned>(blocks), kRows, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(s), static_cast<float*>(vals),
      static_cast<int*>(idx), nq, ns_valid, k, min_keep_i, inv_dim);
  return static_cast<int>(cudaGetLastError());
}
