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
// 4096-row batch at D = 2^16, 10 us at 3.35 TB/s), so the work sets the
// time: one table read and one min per set bit per hash (2.7e8 at the
// service's batch, ~254 set bits a row, K = 256) plus B*D/32 word scans.
// The TPU kernel funnel-shifts the word pair under every hash's window and
// unpacks all D bits for every hash, B*K*D work, because its vector unit
// has no cheap gather.  The design here is the sparse and dense int8
// kernels' (window_fold.cuh): a warp owns a row and all K hashes in
// registers; each lane loads eight words a step (as two 16-byte loads
// where the row length is a multiple of 4 words and the batch 16-byte
// aligned), masks the row's last word to positions < D, and adds the
// step's words to the warp's shared list: where the step's positions fit
// the list (1024 entries), all at once after one warp prefix sum of the
// lanes' popcounts; otherwise word by word through append_mask, which
// places a warp's 32 words (up to 1024 positions) with a prefix sum each,
// and the list is folded (fold_list) first whenever the next word's
// positions might not fit.  pi lives where plan_launch puts it for the
// shape: uint16 pairs or uint16 in shared memory, staged once per
// persistent block, or int32 in global memory past D = 65,536.  pi must
// hold values in [0, D) (a permutation): the shared tables keep it as
// uint16.  Row offsets are 64-bit.

#include <cstdint>

#include <cuda_runtime.h>

#include "window_fold.cuh"

namespace {

using namespace wfold;

// One step of the scan: x[t], word w[t] of the row (masked to positions
// < D), for t < S, a lane.  When the step's positions fit the list, one
// warp prefix sum of the lanes' popcounts places them all; otherwise the
// words go one at a time through append_mask, the list folded first
// whenever the next word's positions might not fit.
template <int S, int H, class Table>
__device__ __forceinline__ int append_words(int* list, int n,
                                            const unsigned (&x)[S],
                                            const int (&w)[S],
                                            const Table& tab, int s0,
                                            int (&h)[H]) {
  int c = 0;
#pragma unroll
  for (int t = 0; t < S; ++t) c += __popc(x[t]);
  const int total = static_cast<int>(__reduce_add_sync(kFull, c));
  if (total == 0) return n;
  if (n + total <= kCap) {
    const int lane = threadIdx.x & 31;
    int incl = c;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, s);
      if (lane >= s) incl += v;
    }
    int slot = n + incl - c;
#pragma unroll
    for (int t = 0; t < S; ++t)
      for (unsigned m = x[t]; m; m &= m - 1u)
        list[slot++] = 32 * w[t] + __ffs(m) - 1;
    return n + total;
  }
#pragma unroll
  for (int t = 0; t < S; ++t) {
    if (n + static_cast<int>(__reduce_add_sync(kFull, __popc(x[t]))) > kCap) {
      fold_list<H>(list, n, tab, s0, h);
      n = 0;
    }
    n = append_mask(list, n, x[t], 32 * w[t]);
  }
  return n;
}

template <int H, int P>
__global__ void __launch_bounds__(kThreads)
cminhash_packed_kernel(const unsigned* __restrict__ words,
                       const int* __restrict__ pi, int* __restrict__ out,
                       int B, int nw, int D, int K, int off, int pack_b,
                       int n_words, int ext, int vec) {
  extern __shared__ int4 smem[];
  int* lists = reinterpret_cast<int*>(smem);
  const auto tab = make_table<P>(lists + kWarps * kSlot, pi, D, ext);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* list = lists + warp * kSlot;
  constexpr int kStep = 8;                   // words a lane per step

  for (long long row = (long long)blockIdx.x * kWarps + warp; row < B;
       row += (long long)gridDim.x * kWarps) {   // uniform across the warp
    const unsigned* __restrict__ wrow = words + row * nw;
    int* __restrict__ out_row = out + row * (pack_b ? n_words : K);
    for (int q0 = 0; q0 < K; q0 += 32 * H) {
      int h[H];
      tab.template init<H>(h);
      const int s0 = tab.start(q0, off);
      int n = 0;
      // A step covers 256 words: with 16-byte loads (nw % 4 == 0, aligned)
      // lane l takes words w0 + 4 l + t and w0 + 128 + 4 l + t, t < 4;
      // otherwise words w0 + 32 t + l, t < 8.  A min takes the positions
      // in any order.
      for (int w0 = 0; w0 < nw; w0 += 32 * kStep) {
        unsigned x[kStep];
        if (vec) {
          const uint4* __restrict__ r4 =
              reinterpret_cast<const uint4*>(wrow + w0);
#pragma unroll
          for (int u = 0; u < kStep / 4; ++u) {
            const int w = w0 + 128 * u + 4 * lane;
            const uint4 v = w < nw ? __ldg(r4 + 32 * u + lane)
                                   : make_uint4(0u, 0u, 0u, 0u);
            x[4 * u] = v.x;
            x[4 * u + 1] = v.y;
            x[4 * u + 2] = v.z;
            x[4 * u + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int t = 0; t < kStep; ++t) {
            const int w = w0 + 32 * t + lane;
            x[t] = w < nw ? __ldg(wrow + w) : 0u;
          }
        }
        int w[kStep];
#pragma unroll
        for (int t = 0; t < kStep; ++t) {
          w[t] = vec ? w0 + 128 * (t >> 2) + 4 * lane + (t & 3)
                     : w0 + 32 * t + lane;
          const int left = D - 32 * w[t];    // positions of the word < D
          if (left < 32) x[t] = left > 0 ? x[t] & ((1u << left) - 1u) : 0u;
        }
        n = append_words<kStep, H>(list, n, x, w, tab, s0, h);
      }
      fold_list<H>(list, n, tab, s0, h);
      tab.template store<H>(out_row, q0, K, h, pack_b);
    }
  }
}

template <int H>
cudaError_t launch(const unsigned* words, const int* pi, int* out, int B,
                   int nw, int D, int K, int off, int pack_b, int n_words,
                   int placement, cudaStream_t stream) {
  const int ext = table_ext(K, off);
  const int vec =
      nw % 4 == 0 && reinterpret_cast<uintptr_t>(words) % 16 == 0;
  using Kernel = decltype(&cminhash_packed_kernel<H, kShared16>);
  Kernel pairs = nullptr;
  if constexpr (H >= kPairsMinH) pairs = cminhash_packed_kernel<H, kPairs>;
  const Kernel kernels[kPlacements] = {cminhash_packed_kernel<H, kShared16>,
                                       cminhash_packed_kernel<H, kGlobal32>,
                                       pairs};
  Plan plan;
  const cudaError_t e = plan_launch(kernels, D, ext, B, placement, &plan);
  if (e != cudaSuccess) return e;
  kernels[plan.placement]<<<plan.grid, kThreads, plan.smem, stream>>>(
      words, pi, out, B, nw, D, K, off, pack_b, n_words, ext, vec);
  return cudaGetLastError();
}

}  // namespace

// placement: where pi lives (kShared16 = 0, kGlobal32 = 1, kPairs = 2,
// window_fold.cuh), or -1 for the launch's own pick; one that is not
// offered at (D, K) or does not fit is refused.
extern "C" int cminhash_packed_launch(const unsigned* words, const int* pi,
                                      int* out, int B, int nw, int D, int K,
                                      int off, int pack_b, int n_words,
                                      int placement, void* stream) {
  if (B == 0 || K == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lane_hashes(K)) {
    case 2: return launch<2>(words, pi, out, B, nw, D, K, off, pack_b, n_words,
                             placement, s);
    case 8: return launch<8>(words, pi, out, B, nw, D, K, off, pack_b, n_words,
                             placement, s);
    case 16: return launch<16>(words, pi, out, B, nw, D, K, off, pack_b, n_words,
                               placement, s);
    default: return launch<32>(words, pi, out, B, nw, D, K, off, pack_b, n_words,
                               placement, s);
  }
}

// Test entry point: every later launch takes placement p (kShared16 = 0,
// kGlobal32 = 1, kPairs = 2), or fails where it is not offered or does not
// fit; -1 restores the per-call choice.
extern "C" void cminhash_packed_force_placement(int p) {
  forced_placement().store(p);
}

extern "C" const char* cminhash_packed_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
