// K2 — fused int8 distance + running top-k with the min_keep gate,
// written for Hopper (sm_90a).
//
// Replaces: fandom_search_tpu/ops/distance_topk.py, _topk_kernel with
// merge="insert" (launched by topk_dot_pallas).  For each query row it
// returns the exact top-k of dot(q, s) over script rows [0, ns_valid),
// ties to the lowest column, as vals = score * inv_dim (f32) and idx
// (int32).  Only scores >= min_keep_i enter (min_keep_i = ceil(min_keep *
// dim), or a floor far below any score for the exact full top-k); an
// empty slot is (-FLT_MAX, 0).
//
// Bound on this card: int8 multiply-adds, NQ * NS * dim per call (2^20 x
// ~20k x 128 per engine batch).  The outputs (NQ * k * 8 B) and the
// script rows (NS * dim B, re-read from L2 by every block) are small
// beside that.
//
// Design: one thread owns one query row and holds its dim int8 values as
// dim/4 int32 words in registers.  A block of 128 rows walks the script
// rows in ascending order, staged 64 rows at a time through shared
// memory (every thread reads the same word: a broadcast), and computes
// each dot with __dp4a.  Each thread keeps its own sorted top-k in
// registers (k <= KCAP, unrolled so the arrays never leave registers).
// A column enters only when its score exceeds max(kth score,
// min_keep_i - 1); it goes in after every entry of equal score, and
// since columns arrive in ascending order the lowest column wins every
// tie without the TPU kernel's packed (score, column) field, its column
// chunking or its (8, 128) tiles.  Tensor-core mma / wgmma is later work.
#include <cfloat>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;  // query rows per block, one per thread
constexpr int kTile = 64;   // script rows per shared-memory stage

template <int KCAP>
__device__ __forceinline__ void insert(int (&sc)[KCAP], int (&col)[KCAP],
                                       int k, int s, int c, int& kth) {
  // Entries are sorted by score, descending; equal scores keep arrival
  // (= column) order.  Walking from the tail, every entry scoring below
  // s moves down one slot and s lands after the last entry >= s.
#pragma unroll
  for (int i = KCAP - 1; i >= 0; --i) {
    if (i < k) {
      const bool shift = (i > 0) && (sc[i > 0 ? i - 1 : 0] < s);
      if (shift) {
        sc[i] = sc[i - 1 >= 0 ? i - 1 : 0];
        col[i] = col[i - 1 >= 0 ? i - 1 : 0];
      } else if (sc[i] < s) {
        sc[i] = s;
        col[i] = c;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < KCAP; ++i) {
    if (i == k - 1) kth = sc[i];
  }
}

template <int DW, int KCAP>
__global__ void __launch_bounds__(kRows)
topk_kernel(const int8_t* __restrict__ q,  // [nq, 4 * DW]
            const int8_t* __restrict__ s,  // [>= ns, 4 * DW]
            float* __restrict__ vals,      // [nq, k]
            int* __restrict__ idx,         // [nq, k]
            long long nq, int ns, int k, int min_keep_i, float inv_dim) {
  constexpr int kVec = DW / 4;  // int4 vectors per row
  __shared__ int4 stile[kTile * kVec];

  const long long row = static_cast<long long>(blockIdx.x) * kRows + threadIdx.x;
  const bool active = row < nq;

  int qw[DW];
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
    for (int c = 0; c < DW; ++c) qw[c] = 0;
  }

  int sc[KCAP];
  int col[KCAP];
#pragma unroll
  for (int i = 0; i < KCAP; ++i) {
    sc[i] = INT_MIN;  // empty slot: below every real score
    col[i] = 0;
  }
  int kth = INT_MIN;
  const int floor_gate = min_keep_i - 1;
  int gate = floor_gate;  // a column enters iff its score > gate

  const int4* s4 = reinterpret_cast<const int4*>(s);
  for (int t0 = 0; t0 < ns; t0 += kTile) {
    const int rows = min(kTile, ns - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < rows * kVec; i += kRows) {
      stile[i] = s4[static_cast<long long>(t0) * kVec + i];
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < rows; ++j) {
      const int4* sr = stile + j * kVec;
      int dot = 0;
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        const int4 v = sr[c];
        dot = __dp4a(qw[4 * c], v.x, dot);
        dot = __dp4a(qw[4 * c + 1], v.y, dot);
        dot = __dp4a(qw[4 * c + 2], v.z, dot);
        dot = __dp4a(qw[4 * c + 3], v.w, dot);
      }
      if (dot > gate) {
        insert<KCAP>(sc, col, k, dot, t0 + j, kth);
        gate = max(kth, floor_gate);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < KCAP; ++i) {
    if (i < k) {
      const bool empty = sc[i] == INT_MIN;
      vals[row * k + i] = empty ? -FLT_MAX : static_cast<float>(sc[i]) * inv_dim;
      idx[row * k + i] = empty ? 0 : col[i];
    }
  }
}

template <int DW, int KCAP>
void launch(const void* q, const void* s, void* vals, void* idx, long long nq,
            int ns, int k, int min_keep_i, float inv_dim, cudaStream_t stream) {
  const long long blocks = (nq + kRows - 1) / kRows;
  topk_kernel<DW, KCAP><<<static_cast<unsigned>(blocks), kRows, 0, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(s),
      static_cast<float*>(vals), static_cast<int*>(idx), nq, ns, k, min_keep_i,
      inv_dim);
}

}  // namespace

// q int8 [nq, dim], s int8 [>= ns_valid, dim] (both 16-byte aligned),
// vals f32 [nq, k], idx int32 [nq, k].  dim == 128 (the engine's) and
// 1 <= k <= 32 are checked by the Python wrapper; other values return
// cudaErrorInvalidValue.
extern "C" int fs_topk(const void* q, const void* s, void* vals, void* idx,
                       long long nq, int ns_valid, int dim, int k,
                       int min_keep_i, float inv_dim, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dim != 128 || k < 1 || k > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (k <= 16) launch<32, 16>(q, s, vals, idx, nq, ns_valid, k, min_keep_i, inv_dim, st);
  else launch<32, 32>(q, s, vals, idx, nq, ns_valid, k, min_keep_i, inv_dim, st);
  return static_cast<int>(cudaGetLastError());
}
