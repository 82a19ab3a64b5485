// Band-hash fold: the coordinator's query leg before the shard broadcast.
//
// Replaces the Pallas fold kernel of the JAX package:
//   src/repro/kernels/query_fused.py  _fold_kernel (:157) and
//   fold_planes_pallas (:164; pallas_call at :179).
//
// Computes, for each (row, band), the polynomial fold of the band's R codes
//     h = 0;  for r < R:  h = h * 0x9E3779B97F4A7C15 + x_r + 1;  h ^= h >> 29
// in wrapping uint64 arithmetic, bit-identical to core.lsh._poly_fold.  The
// TPU has no 64-bit lanes and emulates this on two uint32 planes with a
// 16-bit-limb multiply and explicit carries; Hopper has native 64-bit
// integers, so one thread folds one band with unsigned long long.  The codes
// arrive as int32 (uint32 bits): packed words zero-extend (sign_extend = 0),
// raw int32 signature codes sign-extend (sign_extend = 1), as the host
// fold's astype(np.uint64) does for each.
//
// What bounds it on an H100: bytes.  It reads Q*nb*R*4 bytes and writes
// Q*nb*8, a few operations per byte, and at the serving shapes (Q ~ 1088,
// nb = 32, R = 8: ~1.4 MB) the launch itself costs more than the traffic.
// Consecutive threads take consecutive bands, so a warp's reads cover one
// contiguous span of rows.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kBase = 0x9E3779B97F4A7C15ull;

__global__ void __launch_bounds__(kThreads)
fold_kernel(const int* __restrict__ x, long long* __restrict__ out,
            long long n_bands_total, int R, int sign_extend) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_bands_total) return;
  const int* __restrict__ row = x + e * R;
  unsigned long long h = 0;
  for (int r = 0; r < R; ++r) {
    const int v = __ldg(row + r);
    const unsigned long long c =
        sign_extend ? static_cast<unsigned long long>(static_cast<long long>(v))
                    : static_cast<unsigned long long>(static_cast<unsigned>(v));
    h = h * kBase + c + 1ull;
    h ^= h >> 29;
  }
  out[e] = static_cast<long long>(h);
}

}  // namespace

extern "C" int fold_launch(const int* x, long long* out, long long n_rows,
                           int n_bands, int R, int sign_extend, void* stream) {
  const long long total = n_rows * n_bands;
  if (total == 0) return cudaSuccess;
  const long long grid = (total + kThreads - 1) / kThreads;
  fold_kernel<<<unsigned(grid), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(x, out, total, R,
                                                     sign_extend);
  return cudaGetLastError();
}

extern "C" const char* fold_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
