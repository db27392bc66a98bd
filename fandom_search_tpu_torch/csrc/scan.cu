// K3 — inclusive int32 prefix scan ("add" = cumsum, "max" = cummax) and
// the compaction built on it (nonzero_compact), written for Hopper
// (sm_90a).  Each is ONE cooperative kernel launch.
//
// Replaces: fandom_search_tpu/ops/scan.py, _scan_kernel (launched by
// _scan_padded / scan1d_i32), and the scan + scatter sequence of
// fandom_search_tpu/search/engine.py nonzero_compact.  Scan: out[i] =
// x[0] op ... op x[i]; the add wraps mod 2^32 like an int32 cumsum.
// Compaction: each i with mask[i] != 0 goes to slot csum_i - 1 when that
// slot is below `size`; slots [total, size) are -1.
//
// Bound on this card: the bytes, 4 B read and 4 B written per element for
// the scan, 1 B read per element plus 4 B per output slot for the
// compaction (8 MB at the engine's 2^20, 2.5 us).  At that size the time
// is launch and synchronisation latency, not bandwidth.
//
// Design: the TPU kernel carries its running total from one sequential
// grid step to the next; CUDA blocks run in no order.  This kernel is
// launched cooperatively (cudaLaunchCooperativeKernel), so every block is
// resident and one grid-wide barrier replaces the second and third
// launches of a three-launch scan:
//   phase 1  each block reduces its contiguous slice of 4096-element
//            chunks (16 per thread, 16-byte loads) and writes its total
//            to a scratch word of its own;
//   barrier  cooperative_groups grid sync;
//   phase 2  each block combines the totals of the blocks before it (at
//            most a few hundred words, from L2), then rescans its slice
//            chunk by chunk (warp shuffles, then one warp over the warp
//            totals) and writes the result.  The compaction knows the
//            grand total here too, so the -1 fill of [total, size) is
//            split across all blocks in the same launch.
// The scratch words are written before they are read in every launch, so
// they need no reset.  The grid is capped at the number of co-resident
// blocks; larger inputs loop over chunks inside each block.  Decoupled
// look-back was the alternative: it needs a dynamic tile ticket and
// per-launch epochs on its status words, and only the last tile knows the
// total that the -1 fill needs.
#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kChunk = kThreads * kItems;  // 4096 elements
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;

// MODE 0: scan add, 1: scan max, 2: compaction (mask bytes, add).
template <int MODE>
__device__ __forceinline__ int ident() {
  return MODE == 1 ? INT_MIN : 0;
}

template <int MODE>
__device__ __forceinline__ int combine(int a, int b) {
  if (MODE == 1) return max(a, b);
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// The kItems values of thread `t` of chunk `c` (identity past n).
template <int MODE>
__device__ __forceinline__ void load_items(const void* x, long long n, long long c,
                                           bool aligned, int (&v)[kItems]) {
  const long long i0 = c * kChunk + static_cast<long long>(threadIdx.x) * kItems;
  if (MODE == 2) {
    const uint8_t* m = static_cast<const uint8_t*>(x);
    if (aligned && i0 + kItems <= n) {
      const uint4 w = *reinterpret_cast<const uint4*>(m + i0);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < kItems; ++i) v[i] = ((ws[i >> 2] >> (8 * (i & 3))) & 0xffu) != 0u;
    } else {
#pragma unroll
      for (int i = 0; i < kItems; ++i) v[i] = (i0 + i < n) ? (m[i0 + i] != 0) : 0;
    }
  } else {
    const int* xi = static_cast<const int*>(x);
    if (aligned && i0 + kItems <= n) {
#pragma unroll
      for (int q = 0; q < kItems / 4; ++q) {
        const int4 w = *reinterpret_cast<const int4*>(xi + i0 + 4 * q);
        v[4 * q] = w.x;
        v[4 * q + 1] = w.y;
        v[4 * q + 2] = w.z;
        v[4 * q + 3] = w.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kItems; ++i) v[i] = (i0 + i < n) ? xi[i0 + i] : ident<MODE>();
    }
  }
}

// Block-wide reduction of one value per thread; every thread gets it.
template <int MODE>
__device__ __forceinline__ int block_reduce(int t, int* s_warp) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t = combine<MODE>(t, __shfl_xor_sync(0xffffffffu, t, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // s_warp may still be read from an earlier call
  if (lane == 0) s_warp[warp] = t;
  __syncthreads();
  int r = ident<MODE>();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) r = combine<MODE>(r, s_warp[w]);
  return r;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const void* __restrict__ x, int* __restrict__ out, int* __restrict__ partial,
            long long n, long long chunks, int size, int aligned) {
  __shared__ int s_warp[kWarps];
  __shared__ int s_scan[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long c0 = chunks * blockIdx.x / gridDim.x;
  const long long c1 = chunks * (blockIdx.x + 1) / gridDim.x;

  // ---- phase 1: this block's total
  int acc = ident<MODE>();
  for (long long c = c0; c < c1; ++c) {
    int v[kItems];
    load_items<MODE>(x, n, c, aligned, v);
#pragma unroll
    for (int i = 0; i < kItems; ++i) acc = combine<MODE>(acc, v[i]);
  }
  acc = block_reduce<MODE>(acc, s_warp);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
  cg::this_grid().sync();

  // ---- the blocks before this one, and (compaction) the grand total
  int before = ident<MODE>(), total = ident<MODE>();
  for (int j = threadIdx.x; j < static_cast<int>(gridDim.x); j += kThreads) {
    const int p = __ldcg(partial + j);
    if (j < static_cast<int>(blockIdx.x)) before = combine<MODE>(before, p);
    if (MODE == 2) total = combine<MODE>(total, p);
  }
  int carry = block_reduce<MODE>(before, s_warp);
  if (MODE == 2) total = block_reduce<MODE>(total, s_warp);

  // ---- phase 2: rescan the slice with the carry in front
  for (long long c = c0; c < c1; ++c) {
    int v[kItems];
    load_items<MODE>(x, n, c, aligned, v);
#pragma unroll
    for (int i = 1; i < kItems; ++i) v[i] = combine<MODE>(v[i - 1], v[i]);
    int t = v[kItems - 1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t = combine<MODE>(u, t);
    }
    __syncthreads();  // s_scan is read by the previous chunk
    if (lane == 31) s_scan[warp] = t;
    __syncthreads();
    int wpre = ident<MODE>(), ctot = ident<MODE>();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) wpre = combine<MODE>(wpre, s_scan[w]);
      ctot = combine<MODE>(ctot, s_scan[w]);
    }
    int excl = __shfl_up_sync(0xffffffffu, t, 1);
    if (lane == 0) excl = ident<MODE>();
    const int prefix = combine<MODE>(carry, combine<MODE>(wpre, excl));
    const long long i0 = c * kChunk + static_cast<long long>(threadIdx.x) * kItems;
    if (MODE == 2) {
      int prev = prefix;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int cs = combine<MODE>(prefix, v[i]);  // inclusive count
        if (cs != prev && cs <= size) out[cs - 1] = static_cast<int>(i0 + i);
        prev = cs;
      }
    } else if (aligned && i0 + kItems <= n) {
#pragma unroll
      for (int q = 0; q < kItems / 4; ++q) {
        *reinterpret_cast<int4*>(out + i0 + 4 * q) = make_int4(
            combine<MODE>(prefix, v[4 * q]), combine<MODE>(prefix, v[4 * q + 1]),
            combine<MODE>(prefix, v[4 * q + 2]), combine<MODE>(prefix, v[4 * q + 3]));
      }
    } else {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        if (i0 + i < n) out[i0 + i] = combine<MODE>(prefix, v[i]);
      }
    }
    carry = combine<MODE>(carry, ctot);
  }

  // ---- compaction: slots [total, size) are -1, split across the grid
  if (MODE == 2) {
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long s = static_cast<long long>(total) + blockIdx.x * kThreads + threadIdx.x;
         s < size; s += stride) {
      out[s] = -1;
    }
  }
}

// Co-resident blocks of scan_kernel<MODE> on the current device (cached).
template <int MODE>
int resident_blocks(int* err) {
  static int cache[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev < kMaxDevices && cache[dev] > 0) return cache[dev];
  int sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scan_kernel<MODE>, kThreads, 0);
  }
  if (e != cudaSuccess) {
    *err = static_cast<int>(e);
    return 0;
  }
  const int r = sms * per_sm;
  if (dev < kMaxDevices) cache[dev] = r;
  return r;
}

template <int MODE>
int launch(const void* x, int* out, int* partial, long long n, int size, int scratch_cap,
           cudaStream_t st) {
  int err = 0;
  const int res = resident_blocks<MODE>(&err);
  if (err != 0) return err;
  const long long chunks = (n + kChunk - 1) / kChunk;
  long long grid = chunks < res ? chunks : res;
  if (grid > scratch_cap) grid = scratch_cap;
  if (grid < 1) grid = 1;
  // 16-byte loads (and, for the scan, stores) when the pointers allow
  int aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) ? 1 : 0;
  if (MODE != 2 && reinterpret_cast<uintptr_t>(out) % 16 != 0) aligned = 0;
  long long nchunks = chunks;
  void* args[] = {(void*)&x, (void*)&out, (void*)&partial, (void*)&n,
                  (void*)&nchunks, (void*)&size, (void*)&aligned};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(scan_kernel<MODE>), dim3(static_cast<unsigned>(grid)),
      dim3(kThreads), args, 0, st));
}

}  // namespace

// x, out int32 [n] (n >= 1); scratch int32 [scratch_cap] (no reset
// needed); op 0 = add, 1 = max.  One launch.
extern "C" int fs_scan(const void* x, void* out, void* scratch, long long n, int op,
                       int scratch_cap, void* stream) {
  if (n < 1 || scratch_cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* oi = static_cast<int*>(out);
  int* si = static_cast<int*>(scratch);
  int rc;
  if (op == 0) {
    rc = launch<0>(x, oi, si, n, 0, scratch_cap, st);
  } else if (op == 1) {
    rc = launch<1>(x, oi, si, n, 0, scratch_cap, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}

// mask bool/uint8 [n] (n >= 0), out int32 [size] (size >= 1); scratch as
// for fs_scan.  One launch.
extern "C" int fs_compact(const void* mask, void* out, void* scratch, long long n, int size,
                          int scratch_cap, void* stream) {
  if (n < 0 || size < 1 || scratch_cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = launch<2>(mask, static_cast<int*>(out), static_cast<int*>(scratch), n, size,
                           scratch_cap, static_cast<cudaStream_t>(stream));
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}
