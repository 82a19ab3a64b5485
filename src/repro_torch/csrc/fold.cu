// Band-hash fold: the coordinator's query leg before the shard broadcast.
//
// Replaces the Pallas fold kernel of the JAX package:
//   src/repro/kernels/query_fused.py  _fold_kernel (:157) and
//   fold_planes_pallas (:164; pallas_call at :179).
//
// Computes, for each (row, band), the polynomial fold of the band's R codes
// (band_fold.cuh, shared with the probe kernel's words-in prologue) and
// writes it as int64 with the uint64 bits.  The hashes stay on the card:
// the probe kernel (lsh_probe.cu) reads them there, and only a consumer on
// the host (the spill leg, the host walk) copies them out.  The TPU has no
// 64-bit lanes and emulates the fold on two uint32 planes; Hopper folds in
// native 64-bit integers, one thread a band.
//
// What bounds it on an H100: bytes.  It reads Q*nb*R*4 bytes and writes
// Q*nb*8, a few operations per byte, and at the serving shapes (Q ~ 1088,
// nb = 32, R = 8: ~1.4 MB) the launch itself costs more than the traffic.
// Consecutive threads take consecutive bands, so a warp's reads cover one
// contiguous span of rows; a band of R = 8 codes is two 16-byte loads,
// both in flight before the chain starts.

#include <cuda_runtime.h>

#include "band_fold.cuh"

namespace {

// The block sizes compiled (kernels/autotune.py's "fold" kind picks one a
// call; 256 is the default).
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const int* __restrict__ x, long long* __restrict__ out,
            long long n_bands_total, int R, int sign_extend) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n_bands_total) return;
  out[e] = static_cast<long long>(band_fold::fold(x + e * R, R,
                                                  sign_extend != 0));
}

template <int kThreads>
int launch(const int* x, long long* out, long long total, int R,
           int sign_extend, cudaStream_t stream) {
  const long long grid = (total + kThreads - 1) / kThreads;
  fold_kernel<kThreads><<<unsigned(grid), kThreads, 0, stream>>>(
      x, out, total, R, sign_extend);
  return cudaGetLastError();
}

}  // namespace

// threads: the block size, 128, 256 or 512; any other is refused.
extern "C" int fold_launch(const int* x, long long* out, long long n_rows,
                           int n_bands, int R, int sign_extend, int threads,
                           void* stream) {
  const long long total = n_rows * n_bands;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads != 128 && threads != 256 && threads != 512)
    return cudaErrorInvalidValue;
  if (total == 0) return cudaSuccess;
  switch (threads) {
    case 128: return launch<128>(x, out, total, R, sign_extend, s);
    case 256: return launch<256>(x, out, total, R, sign_extend, s);
    default: return launch<512>(x, out, total, R, sign_extend, s);
  }
}

extern "C" const char* fold_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
