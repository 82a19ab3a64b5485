// Dense C-MinHash signing over int8 rows, with the fused b-bit pack
// epilogue.
//
// Replaces the Pallas circulant min-reduce kernel of the JAX package:
//   src/repro/kernels/cminhash_kernel.py  _kernel (:37) and cminhash_pallas
//   (:77; pallas_call at :127 and :138).
//
// Computes, for row b and hash q in [0, K),
//     h[b, q] = min over m in [0, D) of { pi[m] : v[b, (m + q + off) mod D] > 0 },
// on the caller's (already sigma-permuted) int8 rows as they are: entries
// <= 0 are zeros.  A row with no positive entry keeps SENTINEL = 2^31-1.
//
// What bounds it on an H100: B*K*D masked mins (6.9e10 at B = 4096,
// D = 2^16, K = 256) against ~B*D bytes read, so the integer operation rate.
// The design: a block of 8 warps owns 8 rows x 128 hashes (one row per
// warp, 4 hashes per lane: q = q0 + lane + 32j) and keeps their 32 running
// minima in registers while it walks D in tiles of 512 positions.  Per tile
// it stages pi's slice and, per row, the 640-position band that the tile's
// windows cover, read straight from the rows with the circular index applied
// as it loads: the TPU wrapper's padded copy of the batch,
// [v, v[:K+off], 0...] (cminhash_kernel.py:105-115), is never made.  The
// band is stored as 0 (set) or SENTINEL (not set), so the inner step is
// branch-free, min(h, pi[m] | band[m + q - q0]): one broadcast shared read of
// pi[m] per warp, then a shared read, an OR and a min per hash.  pi values
// are < D <= 2^31-1, so pi | SENTINEL == SENTINEL.  Positions past D in the
// last tile read pi as SENTINEL.  The shared footprint is 22 KB per block,
// so eight blocks fit an SM.  Row offsets are 64-bit (B*D passes 2^31 from
// B = 32,768 at D = 2^16).

#include <cuda_runtime.h>

#include "pack_epilogue.cuh"

namespace {

using cminhash::kSentinel;

constexpr int kRows = 8;                    // rows per block, one per warp
constexpr int kThreads = 32 * kRows;
constexpr int kQPerLane = 4;
constexpr int kHashTile = 32 * kQPerLane;   // hashes per block
constexpr int kDTile = 512;                 // positions per step
constexpr int kBand = kDTile + kHashTile;   // band positions per row

__global__ void __launch_bounds__(kThreads)
cminhash_dense_kernel(const signed char* __restrict__ v,
                      const int* __restrict__ pi, int* __restrict__ out,
                      int B, int D, int K, int off, int pack_b, int n_words) {
  __shared__ int pi_s[kDTile];
  __shared__ int band_s[kRows][kBand];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int q0 = blockIdx.y * kHashTile;

  int h[kQPerLane];
#pragma unroll
  for (int j = 0; j < kQPerLane; ++j) h[j] = kSentinel;

  for (int d0 = 0; d0 < D; d0 += kDTile) {
    __syncthreads();                          // the last tile is consumed
    for (int t = threadIdx.x; t < kDTile; t += kThreads) {
      const int m = d0 + t;
      pi_s[t] = m < D ? __ldg(pi + m) : kSentinel;
    }
    // band[r][t] = row r at position (d0 + q0 + off + t) mod D
    const int p0 = static_cast<int>(((long long)d0 + q0 + off) % D);
    for (int i = threadIdx.x; i < kRows * kBand; i += kThreads) {
      const int r = i / kBand, t = i % kBand;
      const long long row = row0 + r;
      int val = kSentinel;
      if (row < B) {
        int p = p0 + t;
        if (p >= D) p %= D;                   // the wrap; rare at large D
        val = v[row * D + p] > 0 ? 0 : kSentinel;
      }
      band_s[r][t] = val;
    }
    __syncthreads();
    const int* __restrict__ band = band_s[warp] + lane;
    const int m_end = min(kDTile, D - d0);
#pragma unroll 4
    for (int m = 0; m < m_end; ++m) {
      const int p = pi_s[m];
#pragma unroll
      for (int j = 0; j < kQPerLane; ++j)
        h[j] = min(h[j], p | band[m + 32 * j]);
    }
  }

  const long long row = row0 + warp;          // uniform across the warp
  if (row >= B) return;
  int* __restrict__ out_row = out + row * (pack_b ? n_words : K);
#pragma unroll
  for (int j = 0; j < kQPerLane; ++j)
    cminhash::store_codes(out_row, q0 + lane + 32 * j, K, h[j], pack_b);
}

}  // namespace

extern "C" int cminhash_dense_launch(const signed char* v, const int* pi,
                                     int* out, int B, int D, int K, int off,
                                     int pack_b, int n_words, void* stream) {
  if (B == 0 || K == 0) return cudaSuccess;
  const dim3 grid((B + kRows - 1) / kRows, (K + kHashTile - 1) / kHashTile);
  cminhash_dense_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      v, pi, out, B, D, K, off, pack_b, n_words);
  return cudaGetLastError();
}

extern "C" const char* cminhash_dense_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
