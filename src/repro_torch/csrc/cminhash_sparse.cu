// Sparse C-MinHash signing with the fused b-bit pack epilogue.
//
// Replaces the Pallas window-min kernel of the JAX package:
//   src/repro/kernels/cminhash_sparse.py  _kernel (:153) and
//   cminhash_sparse_pallas (:186; pallas_call at :229 and :239).
//
// Computes, for document b and hash q in [0, K),
//     h[b, q] = min over valid j of pi[(idx[b, j] - q - off) mod D],
// which is the reference's window form min_j rev_ext[s_j + q] with
// s_j = (D-1-idx_j+off) mod D and rev[m] = pi[(D-1-m) mod D].  sigma is
// applied by the caller.  Padding (idx < 0) is skipped; an index >= D wraps
// mod D, as the plain version's window_starts does; a row with no valid
// index keeps SENTINEL = 2^31-1, which truncates to all-ones at b < 32 as
// packfmt.pack_codes does.  With pack_b set, the epilogue
// (pack_epilogue.cuh) truncates each code to b bits and ORs the 32/b codes
// of a word together across lanes, so the words are bit-identical to
// pack_codes.
//
// What bounds it on an H100: the bytes are small (idx in, words out: ~8 MB
// for a 4096-document batch), the work is one table read and one min per
// (valid index, hash): 2.6e8 at the serving batch (B = 4096, ~254 valid
// indices, K = 256).  Read from global memory, the table is 256 KiB, more
// than L1 keeps, so each warp read of 32 entries is a 128-byte L2
// transaction, ~1 GB of L2 traffic a batch, and the L2's bandwidth sets
// the time at ~11x the operation bound.  What the design does about it
// (window_fold.cuh): pi lives on the SM, as uint16 in shared memory at
// D = 2^16 (128 KiB, one persistent block of 16 warps per SM, staged once
// per block) and as uint16 pairs at small D, so a warp's 32 table reads
// are one shared wavefront; each warp owns one document and all K hashes
// in registers, compacts the document's valid indices (wrapped mod D) into
// a shared list with a ballot, and folds the table over the list.  The
// bound left is the SM's shared-memory wavefront rate, ~8.2e6 wavefronts a
// batch, ~31 us.  D > 65,536 reads pi from global memory.  pi must hold
// values in [0, D) (a permutation): the shared tables keep it as uint16.

#include <cuda_runtime.h>

#include "window_fold.cuh"

namespace {

using namespace wfold;

template <int H, int P>
__global__ void __launch_bounds__(kThreads)
cminhash_sparse_kernel(const int* __restrict__ idx, const int* __restrict__ pi,
                       int* __restrict__ out, int B, int nnz, int D, int K,
                       int off, int pack_b, int n_words, int ext) {
  extern __shared__ int4 smem[];
  int* lists = reinterpret_cast<int*>(smem);
  const auto tab = make_table<P>(lists + kWarps * kSlot, pi, D, ext);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* list = lists + warp * kSlot;
  constexpr int kUnroll = 4;                 // index loads in flight a lane

  for (long long doc = (long long)blockIdx.x * kWarps + warp; doc < B;
       doc += (long long)gridDim.x * kWarps) {   // uniform across the warp
    const int* __restrict__ row = idx + doc * nnz;
    int* __restrict__ out_row = out + doc * (pack_b ? n_words : K);
    for (int q0 = 0; q0 < K; q0 += 32 * H) {
      int h[H];
      tab.template init<H>(h);
      const int s0 = tab.start(q0, off);
      int n = 0;
      for (int j0 = 0; j0 < nnz; j0 += 32 * kUnroll) {
        int i[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + 32 * u + lane;
          i[u] = j < nnz ? __ldg(row + j) : -1;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (i[u] >= D) i[u] %= D;
          n = append1(list, n, i[u] >= 0, i[u]);
          if (n > kCap - 32) {
            fold_list<H>(list, n, tab, s0, h);
            n = 0;
          }
        }
      }
      fold_list<H>(list, n, tab, s0, h);
      tab.template store<H>(out_row, q0, K, h, pack_b);
    }
  }
}

template <int H>
cudaError_t launch(const int* idx, const int* pi, int* out, int B, int nnz,
                   int D, int K, int off, int pack_b, int n_words,
                   int placement, cudaStream_t stream) {
  const int ext = table_ext(K, off);
  using Kernel = decltype(&cminhash_sparse_kernel<H, kShared16>);
  Kernel pairs = nullptr;
  if constexpr (H >= kPairsMinH) pairs = cminhash_sparse_kernel<H, kPairs>;
  const Kernel kernels[kPlacements] = {cminhash_sparse_kernel<H, kShared16>,
                                       cminhash_sparse_kernel<H, kGlobal32>,
                                       pairs};
  Plan plan;
  const cudaError_t e = plan_launch(kernels, D, ext, B, placement, &plan);
  if (e != cudaSuccess) return e;
  kernels[plan.placement]<<<plan.grid, kThreads, plan.smem, stream>>>(
      idx, pi, out, B, nnz, D, K, off, pack_b, n_words, ext);
  return cudaGetLastError();
}

}  // namespace

// placement: where pi lives (kShared16 = 0, kGlobal32 = 1, kPairs = 2,
// window_fold.cuh), or -1 for the launch's own pick; one that is not
// offered at (D, K) or does not fit is refused.
extern "C" int cminhash_sparse_launch(const int* idx, const int* pi, int* out,
                                      int B, int nnz, int D, int K, int off,
                                      int pack_b, int n_words, int placement,
                                      void* stream) {
  if (B == 0 || K == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lane_hashes(K)) {
    case 2: return launch<2>(idx, pi, out, B, nnz, D, K, off, pack_b, n_words,
                             placement, s);
    case 8: return launch<8>(idx, pi, out, B, nnz, D, K, off, pack_b, n_words,
                             placement, s);
    case 16: return launch<16>(idx, pi, out, B, nnz, D, K, off, pack_b, n_words,
                               placement, s);
    default: return launch<32>(idx, pi, out, B, nnz, D, K, off, pack_b, n_words,
                               placement, s);
  }
}

// Test entry point: every later launch takes placement p (kShared16 = 0,
// kGlobal32 = 1, kPairs = 2), or fails where it is not offered or does not
// fit; -1 restores the per-call choice.
extern "C" void cminhash_sparse_force_placement(int p) {
  forced_placement().store(p);
}

extern "C" const char* cminhash_sparse_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
