// K6 — Hamming-similarity top-R over packed sign codes, written for
// Hopper (sm_90a).
//
// Replaces: fandom_search_tpu/ops/lsh.py, _hamming_topk_kernel (launched
// by hamming_topk_pallas).  For each query row q of W = bits/32 code words
// it scores every script column c < ns_valid by
//   sim = bits - 2 * popcount(q XOR s_c)
// and returns the R best, sim descending and then column ascending, as
// vals (f32 sim) and idx (int32 column).  Only columns with hamming <=
// h_max enter (h_max = (bits - min_keep_sim) / 2, or bits for the exact
// top-R); an empty slot is (-FLT_MAX, 0).
//
// Bound on this card: sim is the dot product of the two codes as +-1
// vectors, so the least time for the work is that of an int8 product on
// the tensor cores, 2 * NQ * ns * bits operations at 1,979 TOP/s.  This
// kernel runs on the CUDA cores instead: NQ * ns * W __popc per pass (16
// per clock per SM), two passes.  The bytes (the codes in, NQ * R * 8 out)
// are small beside either.
//
// Design: one warp per query row, kRows rows per block.  The row's W code
// words sit in registers (every lane holds all of them).  Tiles of kTile
// columns of codes_t are staged in shared memory and serve every row of
// the block; lane l scores tile column l, l + 32, ...  Pass 1 counts, per
// row, the columns in each hamming bin 0..h_max (a histogram in shared
// memory).  An exclusive prefix over the bins gives each bin its first
// output slot and the threshold bin h_t, the last bin whose first slot is
// below R.  Pass 2 recomputes the scores and writes every column with
// hamming <= h_t straight to its final slot, dropping slots >= R.  Bins
// ascend in hamming (descending sim), and inside a bin columns arrive in
// ascending order — tiles ascend, steps ascend, and __match_any_sync ranks
// the lanes of one bin by lane — so the output is sorted, lowest column
// first on ties, with no sort.  The TPU kernel's packed (sim, column)
// field, its column chunking above 2^17 columns and its R serial
// selection passes are not carried over.
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;                // query rows per block, one warp each
constexpr int kThreads = kRows * 32;
constexpr int kTile = 128;               // script columns per shared-memory stage
constexpr int kMaxR = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load_tile(uint32_t* tile, const uint32_t* __restrict__ st,
                                          int words, long long stride, int t0, int ns) {
  __syncthreads();  // the previous tile is no longer read
  for (int e = threadIdx.x; e < words * kTile; e += kThreads) {
    const int w = e / kTile;
    const int col = t0 + (e - w * kTile);
    tile[e] = col < ns ? st[static_cast<long long>(w) * stride + col] : 0u;
  }
  __syncthreads();
}

template <int WCAP>
__device__ __forceinline__ int hamming(const uint32_t (&qw)[WCAP], const uint32_t* tile,
                                       int words, int c) {
  int h = 0;
#pragma unroll
  for (int w = 0; w < WCAP; ++w) {
    if (w < words) h += __popc(qw[w] ^ tile[w * kTile + c]);
  }
  return h;
}

template <int WCAP>
__global__ void __launch_bounds__(kThreads)
hamming_topk_kernel(const uint32_t* __restrict__ q,   // [nq, words]
                    const uint32_t* __restrict__ st,  // [words, stride]
                    float* __restrict__ vals,         // [nq, r]
                    int* __restrict__ idx,            // [nq, r]
                    long long nq, int words, long long stride, int ns, int r,
                    int bits, int h_max) {
  extern __shared__ uint32_t smem[];
  uint32_t* tile = smem;                          // [words][kTile]
  const int nbins = h_max + 1;                    // 0 when nothing may enter
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* hist = reinterpret_cast<int*>(smem + words * kTile) + warp * nbins;
  const long long row = static_cast<long long>(blockIdx.x) * kRows + warp;
  const bool active = row < nq;

  uint32_t qw[WCAP];
#pragma unroll
  for (int w = 0; w < WCAP; ++w) qw[w] = (active && w < words) ? q[row * words + w] : 0u;
  for (int b = lane; b < nbins; b += 32) hist[b] = 0;
  __syncwarp();

  // ---- pass 1: histogram of hamming over the columns that may enter
  for (int t0 = 0; t0 < ns; t0 += kTile) {
    load_tile(tile, st, words, stride, t0, ns);
    if (!active) continue;
    for (int c = lane; c < kTile && t0 + c < ns; c += 32) {
      const int h = hamming<WCAP>(qw, tile, words, c);
      if (h <= h_max) atomicAdd(&hist[h], 1);
    }
  }
  __syncwarp();

  // ---- bins -> first output slot; threshold bin h_t
  const int per = (nbins + 31) / 32;
  const int b0 = min(lane * per, nbins);
  const int b1 = min(b0 + per, nbins);
  int local = 0;
  for (int b = b0; b < b1; ++b) local += hist[b];
  int incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  int run = incl - local;
  int ht = -1;
  for (int b = b0; b < b1; ++b) {
    const int n = hist[b];
    hist[b] = run;
    if (run < r) ht = b;
    run += n;
  }
  const int h_t = __reduce_max_sync(kFull, ht);
  __syncwarp();

  // ---- pass 2: every column with hamming <= h_t to its slot
  for (int t0 = 0; t0 < ns; t0 += kTile) {
    load_tile(tile, st, words, stride, t0, ns);
    if (!active || h_t < 0) continue;
    for (int c = lane; c < kTile; c += 32) {  // same trip count on every lane
      const int col = t0 + c;
      const int h = col < ns ? hamming<WCAP>(qw, tile, words, c) : bits + 1;
      const bool ok = h <= h_t;
      const unsigned want = __ballot_sync(kFull, ok);
      if (want == 0u) continue;
      unsigned peers = 0u;
      int pos = 0;
      if (ok) {
        peers = __match_any_sync(want, h);
        pos = hist[h] + __popc(peers & ((1u << lane) - 1u));
      }
      __syncwarp();  // every lane has read its bin's slot
      if (ok) {
        if (pos < r) {
          vals[row * r + pos] = static_cast<float>(bits - 2 * h);
          idx[row * r + pos] = col;
        }
        if ((peers >> lane) == 1u) hist[h] = pos + 1;  // highest lane of the bin
      }
      __syncwarp();
    }
  }
  if (!active) return;
  for (int p = min(total, r) + lane; p < r; p += 32) {
    vals[row * r + p] = -FLT_MAX;
    idx[row * r + p] = 0;
  }
}

template <int WCAP>
int launch(const void* q, const void* codes_t, void* vals, void* idx, long long nq,
           int words, long long stride, int ns, int r, int bits, int h_max,
           cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * (static_cast<size_t>(words) * kTile +
                                          static_cast<size_t>(kRows) * (h_max + 1));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hamming_topk_kernel<WCAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = (nq + kRows - 1) / kRows;
  hamming_topk_kernel<WCAP><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(codes_t),
      static_cast<float*>(vals), static_cast<int*>(idx), nq, words, stride, ns, r, bits,
      h_max);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q int32 [nq, words], codes_t int32 [words, stride] (uint32 bit patterns),
// vals f32 [nq, r], idx int32 [nq, r]; bits = 32 * words <= 2048,
// 1 <= r <= 1024, 0 <= ns_valid <= stride, -1 <= h_max <= bits.  Other
// values return cudaErrorInvalidValue.
extern "C" int fs_hamming_topk(const void* q, const void* codes_t, void* vals, void* idx,
                               long long nq, int words, long long stride, int ns_valid,
                               int r, int bits, int h_max, void* stream) {
  if (words < 1 || words > 64 || bits != 32 * words || r < 1 || r > kMaxR ||
      ns_valid < 0 || ns_valid > stride || h_max < -1 || h_max > bits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (words <= 8) return launch<8>(q, codes_t, vals, idx, nq, words, stride, ns_valid, r, bits, h_max, st);
  if (words <= 16) return launch<16>(q, codes_t, vals, idx, nq, words, stride, ns_valid, r, bits, h_max, st);
  if (words <= 32) return launch<32>(q, codes_t, vals, idx, nq, words, stride, ns_valid, r, bits, h_max, st);
  return launch<64>(q, codes_t, vals, idx, nq, words, stride, ns_valid, r, bits, h_max, st);
}
