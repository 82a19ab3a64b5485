// Dense C-MinHash signing over bit-packed rows, with the fused b-bit pack
// epilogue.
//
// Replaces the Pallas bit-packed kernel of the JAX package:
//   src/repro/kernels/cminhash_packed.py  _kernel (:48) and
//   cminhash_packed_pallas (:95; pallas_call at :139 and :147).
//
// Input: words (B, ceil(D/32)) from kernels/cminhash_packed.pack_bits, row
// position 32w + j at bit j of word w (bits at positions >= D are ignored).
// Computes, for row b and hash q in [0, K),
//     h[b, q] = min over set positions p of pi[(p - q - off) mod D],
// which is the dense kernel's min_m { pi[m] : v[(m + q + off) mod D] } with
// m = p - q - off.  A row with no set bit keeps SENTINEL = 2^31-1.
//
// What bounds it on an H100: the words are D/8 bytes a row (32 MiB for a
// 4096-row batch at D = 2^16), so the work sets the time: B*K*nnz table
// reads and mins plus B*D/32 word scans, about 2.7e8 + 8.4e6 at the
// service's batch (B = 4096, K = 256, ~254 set bits a row).
// The design: the TPU kernel funnel-shifts the word pair under every hash's
// window and unpacks all D bits for every hash, B*K*D work, because its
// vector unit has no cheap gather.  Here a block of 256 threads owns one row
// and 256 hashes (q = qb + threadIdx.x), and the row's set bits are found
// once for all of them: each thread takes one word of a 256-word chunk,
// appends its set positions (__popc, __ffs, clear lowest) to a list in
// shared memory (a min does not care about order), and after a barrier
// every thread folds pi[p - q - off] over the list.  The 32 lanes of a warp
// read 32 consecutive entries of pi for each position, so the table reads
// coalesce; pi stays in global memory behind the read-only cache, as in the
// sparse kernel, where a shared uint16 table measured slower at D = 2^16.
// A chunk holds at most 256 * 32 positions, so the list never overflows its
// 32 KB.  The circular wrap is one compare and add per read: no extended
// copy [v, v[:K+off]] of the rows is packed, so D % 32 != 0 needs nothing
// but the mask on the row's last word.  Row offsets are 64-bit.

#include <cuda_runtime.h>

#include "pack_epilogue.cuh"

namespace {

using cminhash::kSentinel;

constexpr int kThreads = 256;              // hashes per pass, words per chunk
constexpr int kCap = kThreads * 32;        // positions a chunk can hold

__global__ void __launch_bounds__(kThreads)
cminhash_packed_kernel(const unsigned* __restrict__ words,
                       const int* __restrict__ pi, int* __restrict__ out,
                       int B, int nw, int D, int K, int off, int pack_b,
                       int n_words) {
  __shared__ int pos_s[kCap];
  __shared__ int n_s;
  for (long long row = blockIdx.x; row < B; row += gridDim.x) {
    const unsigned* __restrict__ wrow = words + row * nw;
    int* __restrict__ out_row = out + row * (pack_b ? n_words : K);
    for (int qb = 0; qb < K; qb += kThreads) {
      const int q = qb + threadIdx.x;        // q % 32 == lane
      const int base = -q - off;             // m = p + base, >= -D
      int h = kSentinel;
      for (int w0 = 0; w0 < nw; w0 += kThreads) {
        if (threadIdx.x == 0) n_s = 0;
        __syncthreads();
        const int w = w0 + threadIdx.x;
        if (w < nw) {
          unsigned bits = __ldg(wrow + w);
          const int left = D - 32 * w;       // positions of this word < D
          if (left < 32) bits &= (1u << left) - 1u;
          if (bits) {
            int slot = atomicAdd(&n_s, __popc(bits));
            do {
              pos_s[slot++] = 32 * w + __ffs(bits) - 1;
              bits &= bits - 1u;
            } while (bits);
          }
        }
        __syncthreads();
        const int n = n_s;
        if (q < K) {
          int i = 0;
          for (; i + 4 <= n; i += 4) {
            int m0 = pos_s[i] + base, m1 = pos_s[i + 1] + base;
            int m2 = pos_s[i + 2] + base, m3 = pos_s[i + 3] + base;
            if (m0 < 0) m0 += D;
            if (m1 < 0) m1 += D;
            if (m2 < 0) m2 += D;
            if (m3 < 0) m3 += D;
            h = min(h, min(min(__ldg(pi + m0), __ldg(pi + m1)),
                           min(__ldg(pi + m2), __ldg(pi + m3))));
          }
          for (; i < n; ++i) {
            int m = pos_s[i] + base;
            if (m < 0) m += D;
            h = min(h, __ldg(pi + m));
          }
        }
        __syncthreads();                      // the list is consumed
      }
      cminhash::store_codes(out_row, q, K, h, pack_b);
    }
  }
}

}  // namespace

extern "C" int cminhash_packed_launch(const unsigned* words, const int* pi,
                                      int* out, int B, int nw, int D, int K,
                                      int off, int pack_b, int n_words,
                                      void* stream) {
  if (B == 0 || K == 0) return cudaSuccess;
  cminhash_packed_kernel<<<B, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      words, pi, out, B, nw, D, K, off, pack_b, n_words);
  return cudaGetLastError();
}

extern "C" const char* cminhash_packed_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
