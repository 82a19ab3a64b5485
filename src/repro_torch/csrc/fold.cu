// Band-hash fold: the coordinator's query leg before the shard broadcast.
//
// Replaces the Pallas fold kernel of the JAX package:
//   src/repro/kernels/query_fused.py  _fold_kernel (:157) and
//   fold_planes_pallas (:164; pallas_call at :179).
//
// Computes, for each (row, band), the polynomial fold of the band's R codes,
//     h = 0;  for r < R:  h = h * 0x9E3779B97F4A7C15 + x_r + 1;  h ^= h >> 29
// in wrapping uint64 arithmetic, bit-identical to core.lsh._poly_fold and to
// the two-uint32-plane emulation of the JAX package's Pallas fold, and
// writes it as int64 with the uint64 bits.  The codes arrive as int32
// (uint32 bits): packed words zero-extend (sign_extend = 0), raw int32
// signature codes sign-extend (sign_extend = 1), as the host fold's
// astype(np.uint64) does for each.  The hashes stay on the card, where the
// probe kernel (lsh_probe.cu) reads them: a packed query batch is folded
// here and then probed, on a shard of the service and in the single store
// alike.  Only a consumer on the host (the spill leg, the host walk) copies
// them out.  The TPU has no 64-bit lanes and emulates the fold on two
// uint32 planes; Hopper folds in native 64-bit integers, one thread a band.
//
// What bounds it on an H100: bytes.  It reads Q*nb*R*4 bytes and writes
// Q*nb*8, a few operations per byte, and at the serving shapes (Q ~ 1088,
// nb = 32, R = 8: ~1.4 MB) the launch itself costs more than the traffic.
// Consecutive threads take consecutive bands, so a warp's reads cover one
// contiguous span of rows; a band of R = 8 codes is two 16-byte loads,
// both in flight before the chain starts.  The chain is serial, so what a
// thread waits on is the loads: a band whose R codes make whole 16-byte
// vectors (R % 4 == 0) and that starts on a 16-byte boundary is read as
// int4 loads, up to kFoldVec of them issued before the chain consumes the
// first; any other band is read with scalar loads.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned long long kBase = 0x9E3779B97F4A7C15ull;
constexpr int kFoldVec = 4;     // int4 loads in flight: R <= 16 in one batch

__device__ __forceinline__ unsigned long long step(unsigned long long h,
                                                   int v, bool sign_extend) {
  const unsigned long long c =
      sign_extend ? static_cast<unsigned long long>(static_cast<long long>(v))
                  : static_cast<unsigned long long>(static_cast<unsigned>(v));
  h = h * kBase + c + 1ull;
  return h ^ (h >> 29);
}

// The fold of the R codes at `row` (read-only for the kernel's lifetime).
__device__ __forceinline__ unsigned long long fold(const int* __restrict__ row,
                                                   int R, bool sign_extend) {
  unsigned long long h = 0;
  if ((R & 3) == 0 && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    const int4* __restrict__ v = reinterpret_cast<const int4*>(row);
    const int n = R >> 2;
    for (int i0 = 0; i0 < n; i0 += kFoldVec) {
      int4 q[kFoldVec];
#pragma unroll
      for (int i = 0; i < kFoldVec; ++i)
        if (i0 + i < n) q[i] = __ldg(v + i0 + i);
#pragma unroll
      for (int i = 0; i < kFoldVec; ++i) {
        if (i0 + i < n) {
          h = step(h, q[i].x, sign_extend);
          h = step(h, q[i].y, sign_extend);
          h = step(h, q[i].z, sign_extend);
          h = step(h, q[i].w, sign_extend);
        }
      }
    }
  } else {
    for (int r = 0; r < R; ++r) h = step(h, __ldg(row + r), sign_extend);
  }
  return h;
}

// The block sizes compiled (kernels/autotune.py's "fold" kind picks one a
// call; 256 is the default).
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const int* __restrict__ x, long long* __restrict__ out,
            long long n_bands_total, int R, int sign_extend) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n_bands_total) return;
  out[e] = static_cast<long long>(fold(x + e * R, R, sign_extend != 0));
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
