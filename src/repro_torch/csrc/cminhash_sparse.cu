// Sparse C-MinHash signing with the fused b-bit pack epilogue.
//
// Replaces the Pallas window-min kernel of the JAX package:
//   src/repro/kernels/cminhash_sparse.py  _kernel (:153) and
//   cminhash_sparse_pallas (:186; pallas_call at :229 and :239).
//
// Computes, for document b and hash q in [0, K),
//     h[b, q] = min over valid j of pi[(idx[b, j] - q - off) mod D],
// which is the reference's window form min_j rev_ext[s_j + q] with
// s_j = (D-1-idx_j+off) mod D and rev[m] = pi[(D-1-m) mod D].  The TPU
// kernel reverses pi so that every nonzero reads one contiguous slice; here
// the 32 lanes of a warp take 32 consecutive q and so read 32 consecutive
// (descending) entries of pi, which is just as coalesced, and the kernel
// reads pi as it is, without a window table.  sigma is applied by the
// caller.  Padding (idx < 0) is skipped; a row with no valid index keeps
// SENTINEL = 2^31-1, which truncates to all-ones at b < 32 as
// packfmt.pack_codes does.  With pack_b set, the epilogue
// (pack_epilogue.cuh) truncates each code to b bits and ORs the 32/b codes
// of a word together across lanes (a shuffle butterfly), so the words are
// bit-identical to pack_codes.
//
// An index >= D wraps mod D, as the plain version's window_starts does.  The
// hot path pays one unsigned compare per table read, as for the m < 0 wrap
// alone; only offsets outside [0, D) take the modulo.
//
// What bounds it on an H100: the bytes it must move are small (idx in,
// words out, pi once: ~8 MB for a 4096-document batch), while the work is
// B*K*nnz table reads and mins, so the bound is the integer operation
// rate, and in practice the latency of the table reads.  What the design
// does about it: pi stays in global memory as int32 and is read through
// the read-only data cache (__ldg); at D = 2^16 it is 256 KiB, which the
// 50 MB L2 holds.  Blocks of 1024 threads sign four documents at a time,
// 256 threads per document, two blocks per SM, and loop over documents
// (grid-stride); the nnz loop is unrolled by four so that four independent
// table reads are in flight per thread.
// The placement the TPU kernel suggests, pi staged once per block into
// shared memory as uint16 (128 KiB at D = 2^16, where an int32 table of
// ~264 KiB would not fit in a block's 227 KB), was built and timed at the
// serving shape and measured slower: it allows one block per SM (PERF.md).

#include <cuda_runtime.h>

#include "pack_epilogue.cuh"

namespace {

using cminhash::kSentinel;

constexpr int kThreads = 1024;   // threads per block
constexpr int kGroup = 256;      // threads per document (a multiple of 32)

__device__ __forceinline__ int window(const int* __restrict__ pi, int i,
                                      int base, int D) {
  if (i < 0) return kSentinel;   // padding; uniform across the warp
  int m = i + base;              // i - q - off
  if (static_cast<unsigned>(m) >= static_cast<unsigned>(D)) {
    m = i % D + base;            // rare: i < q + off, or i >= D
    if (m < 0) m += D;
  }
  return __ldg(pi + m);
}

__global__ void __launch_bounds__(kThreads)
cminhash_sparse_kernel(const int* __restrict__ idx, const int* __restrict__ pi,
                       int* __restrict__ out, int B, int nnz, int D, int K,
                       int off, int pack_b, int n_words) {
  const int groups = blockDim.x / kGroup;
  const int t = threadIdx.x % kGroup;
  const int k_round = (K + 31) & ~31;          // whole warps, for shuffles

  for (long long doc = (long long)blockIdx.x * groups + threadIdx.x / kGroup;
       doc < B; doc += (long long)gridDim.x * groups) {
    const int* __restrict__ row = idx + doc * nnz;
    int* __restrict__ out_row = out + doc * (pack_b ? n_words : K);
    for (int q = t; q < k_round; q += kGroup) {  // q % 32 == lane
      int h = kSentinel;
      if (q < K) {
        const int base = -q - off;
        int j = 0;
        for (; j + 4 <= nnz; j += 4) {
          const int i0 = __ldg(row + j), i1 = __ldg(row + j + 1);
          const int i2 = __ldg(row + j + 2), i3 = __ldg(row + j + 3);
          const int w0 = window(pi, i0, base, D);
          const int w1 = window(pi, i1, base, D);
          const int w2 = window(pi, i2, base, D);
          const int w3 = window(pi, i3, base, D);
          h = min(h, min(min(w0, w1), min(w2, w3)));
        }
        for (; j < nnz; ++j)
          h = min(h, window(pi, __ldg(row + j), base, D));
      }
      cminhash::store_codes(out_row, q, K, h, pack_b);
    }
  }
}

}  // namespace

extern "C" int cminhash_sparse_launch(const int* idx, const int* pi, int* out,
                                      int B, int nnz, int D, int K, int off,
                                      int pack_b, int n_words, void* stream) {
  if (B == 0) return cudaSuccess;
  cudaError_t e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, cminhash_sparse_kernel, kThreads, 0);
  if (e != cudaSuccess) return e;
  const long long groups = kThreads / kGroup;
  long long grid = (B + groups - 1) / groups;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (grid > resident) grid = resident;
  cminhash_sparse_kernel<<<int(grid), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      idx, pi, out, B, nnz, D, K, off, pack_b, n_words);
  return cudaGetLastError();
}

extern "C" const char* cminhash_sparse_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
