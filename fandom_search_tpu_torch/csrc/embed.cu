// K1 — shingle embedding, written for Hopper (sm_90a).
//
// Replaces: fandom_search_tpu/ops/embed.py, _embed_kernel_t (launched by
// embed_shingles_pallas_t).  Computes, bit-exactly,
//   e[m, l] = sum_{p<n} (1 - 2 * bit31(tok[m+p] * mult[p, l] mod 2^32))
// as int8 [M, dim], M = T - n + 1 — the row-major layout of the host
// oracle (data/shingler.py embed_shingles_np) and K2's query operand.
//
// Bound on this card: the larger of the bytes written, M * dim int8 (128
// MB for 2^20 shingles at dim 128: 0.040 ms at 3.35 TB/s), and the
// M * dim * n 32-bit integer multiplies (805 M at n = 6), which Hopper
// issues on 64 lanes an SM a clock (about 0.048 ms at 1.98 GHz).  The
// token reads are 4 B a row, reused by n rows.
//
// Design: a warp owns a run of kRun = 128 consecutive rows and one 128-lane
// group of dim (blockIdx.y); a thread owns kLPT = 8 consecutive lanes of
// the group, so 16 threads cover a row and the warp walks 2 rows at a
// time.
// - The thread's n x 8 multipliers are loaded once (16-byte loads) and
//   stay in registers for the whole run: no shared-memory table, so no
//   bank conflicts and no per-block restaging of it.
// - The warp stages its run's kRun + n - 1 tokens in shared memory with
//   coalesced loads; each thread slides its n-token window down the rows
//   in registers, reading the new tokens from there.
// - Each (row, lane, position) is one IMAD and one sign-accumulate,
//   acc += (int)prod >> 31 (0 or -1), then e = n + 2 * acc.
// - Stores are coalesced: 8 bytes a thread, 128 contiguous bytes a row.
// 8 lanes a thread and 128 rows a warp measured fastest of 4, 8 and 16
// lanes and 64 and 128 rows on an H100 at n 6 (0.085 ms against
// 0.087-0.100 ms), and keep n x 8 multipliers in registers up to n = 12.
// n is a template parameter up to kMaxN, so the window and the multipliers
// are register arrays; a larger n takes the same loop with the
// multipliers read from L1 at every row (N = 0).
// The TPU kernel's lane-major [dim, M] layout and its (1, TM) stream views
// are not carried over.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 128;  // lanes of dim a warp covers
constexpr int kMaxN = 12;
constexpr int kLPT = 8;      // lanes a thread (8-byte stores)
constexpr int kRun = 128;    // rows a warp walks

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(static_cast<uint8_t>(a))) |
         (static_cast<uint32_t>(static_cast<uint8_t>(b)) << 8) |
         (static_cast<uint32_t>(static_cast<uint8_t>(c)) << 16) |
         (static_cast<uint32_t>(static_cast<uint8_t>(d)) << 24);
}

// e = n + 2 * acc for the thread's 8 lanes, one 8-byte store.
__device__ __forceinline__ void store_row(int8_t* dst, const int (&acc)[kLPT], int n) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(
      pack4(n + 2 * acc[0], n + 2 * acc[1], n + 2 * acc[2], n + 2 * acc[3]),
      pack4(n + 2 * acc[4], n + 2 * acc[5], n + 2 * acc[6], n + 2 * acc[7]));
}

// N > 0: n == N, window and multipliers in registers; N == 0: any n, the
// multipliers read from L1 at every row.
template <int N>
__global__ void __launch_bounds__(kThreads)
embed_kernel(const uint32_t* __restrict__ tokens,  // [m + n - 1]
             const uint32_t* __restrict__ mults,   // [n, dim]
             int8_t* __restrict__ out,             // [m, dim]
             long long m, int n, int dim) {
  constexpr int kTPR = kGroup / kLPT;  // threads a row
  constexpr int kRPI = 32 / kTPR;      // rows a warp step
  constexpr int kTok = kRun + (N > 0 ? N : 1) - 1;
  __shared__ uint32_t stok_all[kWarps][N > 0 ? kTok : 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 = (static_cast<long long>(blockIdx.x) * kWarps + warp) * kRun;
  if (row0 >= m) return;  // the whole warp
  const int rows = static_cast<int>(m - row0 < kRun ? m - row0 : kRun);
  const int ro = lane / kTPR;
  const int l0 = blockIdx.y * kGroup + (lane % kTPR) * kLPT;
  const bool act = l0 < dim;
  int8_t* o = out + row0 * dim + l0;

  if constexpr (N > 0) {
    uint32_t* stok = stok_all[warp];
    for (int t = lane; t < rows + N - 1; t += 32) stok[t] = __ldg(tokens + row0 + t);
    __syncwarp();
    uint32_t mu[N][kLPT];
#pragma unroll
    for (int p = 0; p < N; ++p)
#pragma unroll
      for (int i = 0; i < kLPT / 4; ++i) {
        const uint4 v = act ? __ldg(reinterpret_cast<const uint4*>(mults + p * dim + l0) + i)
                            : make_uint4(0u, 0u, 0u, 0u);
        mu[p][4 * i] = v.x;
        mu[p][4 * i + 1] = v.y;
        mu[p][4 * i + 2] = v.z;
        mu[p][4 * i + 3] = v.w;
      }
    uint32_t win[N];  // win[p] = tok[r + p]
#pragma unroll
    for (int p = 0; p < N; ++p) win[p] = p + kRPI < N ? stok[min(ro + p, kTok - 1)] : 0u;
#pragma unroll 2
    for (int r = ro; r < rows; r += kRPI) {
#pragma unroll
      for (int p = N - kRPI < 0 ? 0 : N - kRPI; p < N; ++p) win[p] = stok[r + p];
      int acc[kLPT];
#pragma unroll
      for (int l = 0; l < kLPT; ++l) acc[l] = 0;
#pragma unroll
      for (int p = 0; p < N; ++p)
#pragma unroll
        for (int l = 0; l < kLPT; ++l)
          acc[l] += static_cast<int>(win[p] * mu[p][l]) >> 31;  // wraps mod 2^32; -1 if bit 31
      if (act) store_row(o + static_cast<long long>(r) * dim, acc, N);
#pragma unroll
      for (int p = 0; p + kRPI < N; ++p) win[p] = win[p + kRPI];
    }
  } else {
    if (!act) return;
    for (int r = ro; r < rows; r += kRPI) {
      int acc[kLPT];
#pragma unroll
      for (int l = 0; l < kLPT; ++l) acc[l] = 0;
      for (int p = 0; p < n; ++p) {
        const uint32_t tok = __ldg(tokens + row0 + r + p);
#pragma unroll
        for (int i = 0; i < kLPT / 4; ++i) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(mults + p * dim + l0) + i);
          acc[4 * i] += static_cast<int>(tok * v.x) >> 31;
          acc[4 * i + 1] += static_cast<int>(tok * v.y) >> 31;
          acc[4 * i + 2] += static_cast<int>(tok * v.z) >> 31;
          acc[4 * i + 3] += static_cast<int>(tok * v.w) >> 31;
        }
      }
      store_row(o + static_cast<long long>(r) * dim, acc, n);
    }
  }
}

template <int N>
int launch(const void* tokens, const void* mults, void* out, long long m, int n, int dim,
           cudaStream_t stream) {
  const long long per_block = static_cast<long long>(kWarps) * kRun;
  const dim3 grid(static_cast<unsigned>((m + per_block - 1) / per_block),
                  static_cast<unsigned>((dim + kGroup - 1) / kGroup));
  embed_kernel<N><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(tokens), static_cast<const uint32_t*>(mults),
      static_cast<int8_t*>(out), m, n, dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tokens uint32 [m + n - 1], mults uint32 [n, dim] (16-byte aligned), out
// int8 [m, dim] (16-byte aligned); n >= 1, dim % 16 == 0 (checked by the
// Python wrapper; other values return cudaErrorInvalidValue).
extern "C" int fs_embed(const void* tokens, const void* mults, void* out,
                        long long m, int n, int dim, void* stream) {
  if (n < 1 || dim < 16 || dim % 16 != 0 || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: return launch<1>(tokens, mults, out, m, n, dim, st);
    case 2: return launch<2>(tokens, mults, out, m, n, dim, st);
    case 3: return launch<3>(tokens, mults, out, m, n, dim, st);
    case 4: return launch<4>(tokens, mults, out, m, n, dim, st);
    case 5: return launch<5>(tokens, mults, out, m, n, dim, st);
    case 6: return launch<6>(tokens, mults, out, m, n, dim, st);
    case 7: return launch<7>(tokens, mults, out, m, n, dim, st);
    case 8: return launch<8>(tokens, mults, out, m, n, dim, st);
    case 9: return launch<9>(tokens, mults, out, m, n, dim, st);
    case 10: return launch<10>(tokens, mults, out, m, n, dim, st);
    case 11: return launch<11>(tokens, mults, out, m, n, dim, st);
    case kMaxN: return launch<kMaxN>(tokens, mults, out, m, n, dim, st);
    default: return launch<0>(tokens, mults, out, m, n, dim, st);
  }
}
