// Pairwise collision counts: the brute-force fallback's scoring kernel.
//
// Replaces the Pallas collision kernel of the JAX package:
//   src/repro/kernels/collision_kernel.py  _kernel (:22) and
//   collision_count_pallas (:37; pallas_call at :51).
//
// Computes count[q, n] = sum_k 1{a[q, k] == b[n, k]} for (Q, K) x (N, K)
// int32 codes -> (Q, N) int32: the data flow of a matrix product with
// (==, +) in place of (*, +).  No tensor-core instruction computes an
// equality count, so this runs on the integer ALUs.
//
// What bounds it on an H100: operations.  At the brute-force shapes
// (Q' = 64 pow2-padded fallback rows, N = 16384 rows per block call,
// K = 256) it does 2*Q*N*K integer operations (a compare and an add) on
// ~17 MB of codes, far more than the 3.35 TB/s memory can feed per
// operation.  The design is a register-blocked tile, as for a SIMT matrix
// product: a block of 256 threads owns a 64 x 64 output tile, stages the
// K loop through shared memory 32 columns at a time (both operands
// transposed, padded by one word against bank conflicts), and each thread
// keeps a 4 x 4 block of counts in registers, so every shared-memory read
// feeds four compares.  Ragged edges are masked: out-of-range rows load 0
// and are never written, and the last K chunk runs a shorter loop, so no
// sentinel padding is needed.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // output rows and columns per block
constexpr int kK = 32;         // K columns staged per step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

// One staged K column: four A codes x four B codes into the 4 x 4 counts.
__device__ __forceinline__ void count_step(const int (*As)[kTile + 1],
                                           const int (*Bs)[kTile + 1], int kk,
                                           int tx, int ty, int (&acc)[4][4]) {
  int av[4], bv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
  for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += av[i] == bv[j];
}

__global__ void __launch_bounds__(kThreads)
collision_kernel(const int* __restrict__ a, const int* __restrict__ b,
                 int* __restrict__ out, int Q, int N, int K) {
  __shared__ int As[kK][kTile + 1];
  __shared__ int Bs[kK][kTile + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long q0 = (long long)blockIdx.y * kTile;
  const long long n0 = (long long)blockIdx.x * kTile;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kK) {
    for (int e = threadIdx.x; e < kTile * kK; e += kThreads) {
      const int r = e / kK, c = e % kK, kc = k0 + c;
      const long long qa = q0 + r, nb = n0 + r;
      As[c][r] = (qa < Q && kc < K) ? __ldg(a + qa * K + kc) : 0;
      Bs[c][r] = (nb < N && kc < K) ? __ldg(b + nb * K + kc) : 0;
    }
    __syncthreads();
    const int kn = min(kK, K - k0);
    if (kn == kK) {
#pragma unroll 8
      for (int kk = 0; kk < kK; ++kk) count_step(As, Bs, kk, tx, ty, acc);
    } else {
      for (int kk = 0; kk < kn; ++kk) count_step(As, Bs, kk, tx, ty, acc);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long q = q0 + ty + 16 * i;
    if (q >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long n = n0 + tx + 16 * j;
      if (n < N) out[q * N + n] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int collision_launch(const int* a, const int* b, int* out, int Q,
                                int N, int K, void* stream) {
  if (Q == 0 || N == 0) return cudaSuccess;
  const dim3 grid((N + kTile - 1) / kTile, (Q + kTile - 1) / kTile);
  collision_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, Q, N, K);
  return cudaGetLastError();
}

extern "C" const char* collision_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
