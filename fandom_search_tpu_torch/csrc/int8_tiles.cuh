// Shared pieces of the int8 tensor-core kernels (sm_90a): the PTX
// wrappers K6 (hamming_topk.cu), K2 (distance_topk.cu) and K7
// (distance_topk_rows.cu) use, and the score producer K2 and K7 share.
//
// The score producer computes dot(q, s) for dim-128 int8 rows on
// mma.sync m16n8k32 s8 x s8 -> s32 (exact: |dot| <= 128^3).  A block of
// kWarps warps owns kBlockRows query rows, kWarpRows per warp, so every
// row's scores, state and merges belong to one warp and need no block
// barrier.  Both operands are K-major as they lie in memory: q
// [nq, 128] row-major is A, s [ns, 128] row-major is B's "col" layout.
// - A: each warp loads its rows' fragments once from device memory
//   (kMT m16 tiles x 4 k-steps x 4 registers = 64 registers) and keeps
//   them for the whole walk; rows past nq read 0.
// - B: tiles of kTileCols script rows stream through a ring of kStages
//   shared-memory slots, filled with 16-byte cp.async copies kStages - 1
//   tiles ahead, one block barrier a tile.  Rows are padded to
//   kRowPitch bytes, so the ldmatrix reads of 8 rows are free of bank
//   conflicts; script rows past ns read 0 (zero-fill) and their scores
//   are set to INT_MIN, below every gate.
// - Scores: each warp walks a tile in steps of kSubCols columns; a step
//   is kMT x 4 n8 tiles x 4 k-steps = 64 mma into 64 accumulator
//   registers, which the caller's epilogue reads in the m16n8 layout:
//   acc[mt][nt][e] is row mt * 16 + lane / 4 + 8 * (e / 2) of the warp,
//   column c0 + nt * 8 + 2 * (lane % 4) + e % 2.
// L2: every block reads the whole script once, ns * 128 bytes, so a
// 2^20-row batch against 19,033 script rows reads 4,096 x 2.44 MB =
// 10 GB from L2; kWarpRows = 64 makes a warp's ldmatrix reads of B 2
// per 16 mma.
// Other dims (any multiple of 128) take walk_script_chunked: the same
// warps, rows and epilogue steps, but the dot runs over 128-byte k-chunks.
// A ring slot holds one step's kSubCols script rows x one chunk (kCStages
// slots), and the warp reloads its A fragments of the chunk from device
// memory (L1) for each slot, so neither registers nor shared memory grow
// with dim; the step's accumulators add up over the chunks before the
// epilogue sees them.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N of this thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// Wait until at most n (0..2) of this thread's copy groups are pending.
__device__ __forceinline__ void cp_wait(int n) {
  if (n >= 2) {
    asm volatile("cp.async.wait_group 2;\n" ::);
  } else if (n == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::);
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::);
  }
}

namespace tiles {

constexpr int kDim = 128;          // bytes of one int8 row
constexpr int kMT = 4;             // m16 tiles a warp
constexpr int kWarpRows = 16 * kMT;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockRows = kWarpRows * kWarps;
constexpr int kTileCols = 128;     // script rows a ring slot
constexpr int kSubCols = 32;       // columns an epilogue step
constexpr int kNT = kSubCols / 8;  // n8 tiles a step
constexpr int kRowPitch = kDim + 16;
constexpr int kStages = 3;
constexpr int kSlotBytes = kTileCols * kRowPitch;
constexpr int kRingBytes = kStages * kSlotBytes;
constexpr int kCStages = 8;                        // chunked ring: slots
constexpr int kCSlotBytes = kSubCols * kRowPitch;  // one step x one 128-byte chunk
constexpr int kCRingBytes = kCStages * kCSlotBytes;
constexpr unsigned kFull = 0xffffffffu;

using AFrag = uint32_t[kMT][4][4];  // [m16 tile][k-step][register]
using Acc = int[kMT][kNT][4];       // [m16 tile][n8 tile][register]

// The warp's A fragments for rows [r0, r0 + kWarpRows), bytes [koff, koff
// + 128) of rows ld bytes long; rows >= nq are 0.
__device__ __forceinline__ void load_a(AFrag& a, const int8_t* __restrict__ q, long long nq,
                                       long long r0, int lane, int ld = kDim, int koff = 0) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const long long ra = r0 + mt * 16 + (lane >> 2);
    const long long rb = ra + 8;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int off = koff + ks * 32 + (lane & 3) * 4;
      const uint32_t* pa = reinterpret_cast<const uint32_t*>(q + ra * ld + off);
      const uint32_t* pb = reinterpret_cast<const uint32_t*>(q + rb * ld + off);
      a[mt][ks][0] = ra < nq ? pa[0] : 0u;
      a[mt][ks][1] = rb < nq ? pb[0] : 0u;
      a[mt][ks][2] = ra < nq ? pa[4] : 0u;
      a[mt][ks][3] = rb < nq ? pb[4] : 0u;
    }
  }
}

// Stage script rows [c0, c0 + kTileCols) into a slot; rows >= ns read 0.
__device__ __forceinline__ void load_b(uint8_t* slot, const int8_t* __restrict__ s, int ns,
                                       int c0) {
  for (int e = threadIdx.x; e < kTileCols * (kDim / 16); e += kThreads) {
    const int r = e / (kDim / 16);
    const int ch = e - r * (kDim / 16);
    const bool ok = c0 + r < ns;
    cp_async16(slot + r * kRowPitch + ch * 16,
               ok ? s + static_cast<long long>(c0 + r) * kDim + ch * 16 : s, ok ? 16 : 0);
  }
}

__device__ __forceinline__ void zero_acc(Acc& acc) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
}

// acc += the warp's rows x the kSubCols script rows staged at `b` (one
// 128-byte chunk of each).
__device__ __forceinline__ void score_add(Acc& acc, const AFrag& a, const uint8_t* b,
                                          int lane) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    // matrix j of an ldmatrix.x4: 8 script rows x bytes [16 j, 16 j + 16)
    // of a 64-byte half, i.e. b0 / b1 of two k-steps
    const uint8_t* p = b + (nt * 8 + (lane & 7)) * kRowPitch + (lane >> 3) * 16;
    uint32_t bf[2][4];
    ldsm_x4(bf[0], p);
    ldsm_x4(bf[1], p + 64);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t b0 = bf[ks >> 1][(ks & 1) * 2];
      const uint32_t b1 = bf[ks >> 1][(ks & 1) * 2 + 1];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) mma_s8(acc[mt][nt], a[mt][ks], b0, b1);
    }
  }
}

// acc = the warp's rows x the kSubCols script rows staged at `b`.
__device__ __forceinline__ void score_step(Acc& acc, const AFrag& a, const uint8_t* b,
                                           int lane) {
  zero_acc(acc);
  score_add(acc, a, b, lane);
}

// Columns >= ns score INT_MIN, below every gate.
__device__ __forceinline__ void mask_tail(Acc& acc, int c0, int ns, int lane) {
  if (c0 + kSubCols <= ns) return;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool out = c0 + nt * 8 + 2 * (lane & 3) + (e & 1) >= ns;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        if (out) acc[mt][nt][e] = INT_MIN;
    }
}

// The largest of a thread's 8 scores of row (mt, hi) in a step.
__device__ __forceinline__ int row_max(const Acc& acc, int mt, int hi) {
  const int x = __vimax3_s32(acc[mt][0][2 * hi], acc[mt][0][2 * hi + 1], acc[mt][1][2 * hi]);
  const int y = __vimax3_s32(acc[mt][1][2 * hi + 1], acc[mt][2][2 * hi], acc[mt][2][2 * hi + 1]);
  return __vimax3_s32(x, y, max(acc[mt][3][2 * hi], acc[mt][3][2 * hi + 1]));
}

// Walk script rows [0, ns): for each step of kSubCols columns starting at
// c0, call epi(acc, c0) with the warp's scores; columns >= ns hold
// INT_MIN.  Every thread of the block calls it (it holds the ring's
// barriers).
template <class Epi>
__device__ __forceinline__ void walk_script(uint8_t* ring, const int8_t* __restrict__ s, int ns,
                                            const AFrag& a, int lane, Epi&& epi) {
  const int ntiles = (ns + kTileCols - 1) / kTileCols;
#pragma unroll
  for (int i = 0; i + 1 < kStages; ++i) {
    if (i < ntiles) load_b(ring + i * kSlotBytes, s, ns, i * kTileCols);
    cp_commit();
  }
#pragma unroll 1
  for (int t = 0; t < ntiles; ++t) {
    cp_wait(kStages - 2);  // tile t has landed for this thread...
    __syncthreads();       // ...and every thread; the last tile's slot is free
    const int tn = t + kStages - 1;
    if (tn < ntiles) load_b(ring + (tn % kStages) * kSlotBytes, s, ns, tn * kTileCols);
    cp_commit();
    const uint8_t* slot = ring + (t % kStages) * kSlotBytes;
#pragma unroll 1
    for (int sub = 0; sub < kTileCols / kSubCols; ++sub) {
      const int c0 = t * kTileCols + sub * kSubCols;
      if (c0 >= ns) break;
      Acc acc;
      score_step(acc, a, slot + sub * kSubCols * kRowPitch, lane);
      mask_tail(acc, c0, ns, lane);
      epi(acc, c0);
    }
  }
  cp_wait(0);
}

// Stage bytes [ch * 128, ch * 128 + 128) of script rows [c0, c0 + kSubCols)
// (rows dim bytes long) into a chunked-ring slot; rows >= ns read 0.
__device__ __forceinline__ void load_b_chunk(uint8_t* slot, const int8_t* __restrict__ s,
                                             int ns, int dim, int c0, int ch) {
  for (int e = threadIdx.x; e < kSubCols * (kDim / 16); e += kThreads) {
    const int r = e / (kDim / 16);
    const int piece = e - r * (kDim / 16);
    const bool ok = c0 + r < ns;
    cp_async16(slot + r * kRowPitch + piece * 16,
               ok ? s + static_cast<long long>(c0 + r) * dim + ch * kDim + piece * 16 : s,
               ok ? 16 : 0);
  }
}

// walk_script for rows of any dim that is a multiple of 128: items (step t,
// chunk ch) stream through the chunked ring in order, kCStages - 1 ahead;
// the warp's A fragments of chunk ch come from device memory (q, rows
// [r0, r0 + kWarpRows), nq rows of dim bytes), and epi(acc, c0) runs once
// a step's last chunk has been added.
template <class Epi>
__device__ __forceinline__ void walk_script_chunked(uint8_t* ring, const int8_t* __restrict__ q,
                                                    long long nq, long long r0,
                                                    const int8_t* __restrict__ s, int ns,
                                                    int dim, int lane, Epi&& epi) {
  const int nch = dim / kDim;
  const int nitems = (ns + kSubCols - 1) / kSubCols * nch;
#pragma unroll
  for (int i = 0; i + 1 < kCStages; ++i) {
    if (i < nitems) load_b_chunk(ring + i * kCSlotBytes, s, ns, dim, i / nch * kSubCols, i % nch);
    cp_commit();
  }
  Acc acc;
#pragma unroll 1
  for (int it = 0; it < nitems; ++it) {
    cp_wait_n<kCStages - 2>();  // item it has landed for this thread...
    __syncthreads();            // ...and every thread; the last item's slot is free
    const int in = it + kCStages - 1;
    if (in < nitems) {
      load_b_chunk(ring + (in % kCStages) * kCSlotBytes, s, ns, dim, in / nch * kSubCols,
                   in % nch);
    }
    cp_commit();
    const int t = it / nch;
    const int ch = it - t * nch;
    if (ch == 0) zero_acc(acc);
    AFrag a;
    load_a(a, q, nq, r0, lane, dim, ch * kDim);
    score_add(acc, a, ring + (it % kCStages) * kCSlotBytes, lane);
    if (ch == nch - 1) {
      const int c0 = t * kSubCols;
      mask_tail(acc, c0, ns, lane);
      epi(acc, c0);
    }
  }
  cp_wait(0);
}

}  // namespace tiles
}  // namespace
