// Dense C-MinHash signing over int8 rows, with the fused b-bit pack
// epilogue.
//
// Replaces the Pallas circulant min-reduce kernel of the JAX package:
//   src/repro/kernels/cminhash_kernel.py  _kernel (:37) and cminhash_pallas
//   (:77; pallas_call at :127 and :138).
//
// Computes, for row b and hash q in [0, K),
//     h[b, q] = min over m in [0, D) of { pi[m] : v[b, (m + q + off) mod D] > 0 }
//             = min over set positions p of pi[(p - q - off) mod D],
// on the caller's (already sigma-permuted) int8 rows as they are: entries
// <= 0 are zeros.  A row with no positive entry keeps SENTINEL = 2^31-1.
//
// What bounds it on an H100: the function reads each byte once (B*D bytes:
// 268 MB at B = 4096, D = 2^16) and does one min per set entry per hash
// (set bits x K: 1.5e9 at the paper's 4096 x 2048, K = 512, on image-like
// rows).  The TPU kernel walks all D positions for every hash instead,
// B*K*D masked mins (4.3e9 and 6.9e10, 2.8x and 65x the function's work),
// which on this card is bound by the instruction rate.  The design
// (window_fold.cuh): a warp owns one row and all K hashes in registers.  It
// scans the row once with 16-byte loads (eight in flight per lane), turns
// each lane's 16 bytes into a 16-bit mask of the entries > 0, and compacts
// the set positions into its shared list with a warp prefix sum of the
// masks' popcounts; whenever the list could overflow on the next step (it
// holds 1024 positions, a row may have D) it folds pi over the list and
// empties it.  pi lives on the SM, staged once per persistent block: as
// uint16 pairs at D = 2048 (two hashes a 4-byte shared read), as uint16
// at D <= 65,536, in global memory beyond.  So the work is B*D byte tests
// plus set bits x K table reads, bound at the paper's shape by the shared
// wavefront rate and at the service's by the row bytes.  D % 16 != 0 or an
// unaligned batch scans a byte per lane instead.  K > 1024 (K = D is
// legal) takes passes of 1024 hashes, each scanning the row again.  Row
// offsets are 64-bit (B*D passes 2^31 from B = 32,768 at D = 2^16).  pi
// must hold values in [0, D) (a permutation): the shared tables keep it as
// uint16.

#include <cstdint>

#include <cuda_runtime.h>

#include "window_fold.cuh"

namespace {

using namespace wfold;

// Bit i set where byte i of w is > 0 (signed): low 7 bits nonzero, sign
// bit clear.  The multiply gathers the four byte flags into bits 28..31.
__device__ __forceinline__ unsigned positive_bytes(unsigned w) {
  const unsigned gt = ((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) & ~w & 0x80808080u;
  return (gt * 0x00204081u) >> 28;
}

__device__ __forceinline__ unsigned positive_mask16(int4 v) {
  return positive_bytes(v.x) | positive_bytes(v.y) << 4 |
         positive_bytes(v.z) << 8 | positive_bytes(v.w) << 12;
}

template <int H, int P>
__global__ void __launch_bounds__(kThreads)
cminhash_dense_kernel(const signed char* __restrict__ v,
                      const int* __restrict__ pi, int* __restrict__ out,
                      int B, int D, int K, int off, int pack_b, int n_words,
                      int ext, int vec) {
  extern __shared__ int4 smem[];
  int* lists = reinterpret_cast<int*>(smem);
  const auto tab = make_table<P>(lists + kWarps * kSlot, pi, D, ext);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* list = lists + warp * kSlot;
  constexpr int kUnroll = 8;                 // 16-byte loads in flight a lane

  for (long long row = (long long)blockIdx.x * kWarps + warp; row < B;
       row += (long long)gridDim.x * kWarps) {   // uniform across the warp
    const signed char* __restrict__ vrow = v + row * D;
    int* __restrict__ out_row = out + row * (pack_b ? n_words : K);
    for (int q0 = 0; q0 < K; q0 += 32 * H) {
      int h[H];
      tab.template init<H>(h);
      const int s0 = tab.start(q0, off);
      int n = 0;
      if (vec) {                             // D % 16 == 0, 16-byte aligned
        const int4* __restrict__ r4 = reinterpret_cast<const int4*>(vrow);
        const int n16 = D / 16;
        for (int c0 = 0; c0 < n16; c0 += 32 * kUnroll) {
          int4 w[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int c = c0 + 32 * u + lane;
            w[u] = c < n16 ? __ldg(r4 + c) : make_int4(0, 0, 0, 0);
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            n = append_mask(list, n, positive_mask16(w[u]),
                            16 * (c0 + 32 * u + lane));
            if (n > kCap - 512) {
              fold_list<H>(list, n, tab, s0, h);
              n = 0;
            }
          }
        }
      } else {
        for (int p0 = 0; p0 < D; p0 += 32) {
          const int p = p0 + lane;
          n = append1(list, n, p < D && vrow[p] > 0, p);
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
cudaError_t launch(const signed char* v, const int* pi, int* out, int B,
                   int D, int K, int off, int pack_b, int n_words,
                   int placement, cudaStream_t stream) {
  const int ext = table_ext(K, off);
  const int vec = D % 16 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  using Kernel = decltype(&cminhash_dense_kernel<H, kShared16>);
  Kernel pairs = nullptr;
  if constexpr (H >= kPairsMinH) pairs = cminhash_dense_kernel<H, kPairs>;
  const Kernel kernels[kPlacements] = {cminhash_dense_kernel<H, kShared16>,
                                       cminhash_dense_kernel<H, kGlobal32>,
                                       pairs};
  Plan plan;
  const cudaError_t e = plan_launch(kernels, D, ext, B, placement, &plan);
  if (e != cudaSuccess) return e;
  kernels[plan.placement]<<<plan.grid, kThreads, plan.smem, stream>>>(
      v, pi, out, B, D, K, off, pack_b, n_words, ext, vec);
  return cudaGetLastError();
}

}  // namespace

// placement: where pi lives (kShared16 = 0, kGlobal32 = 1, kPairs = 2,
// window_fold.cuh), or -1 for the launch's own pick; one that is not
// offered at (D, K) or does not fit is refused.
extern "C" int cminhash_dense_launch(const signed char* v, const int* pi,
                                     int* out, int B, int D, int K, int off,
                                     int pack_b, int n_words, int placement,
                                     void* stream) {
  if (B == 0 || K == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lane_hashes(K)) {
    case 2: return launch<2>(v, pi, out, B, D, K, off, pack_b, n_words,
                             placement, s);
    case 8: return launch<8>(v, pi, out, B, D, K, off, pack_b, n_words,
                             placement, s);
    case 16: return launch<16>(v, pi, out, B, D, K, off, pack_b, n_words,
                               placement, s);
    default: return launch<32>(v, pi, out, B, D, K, off, pack_b, n_words,
                               placement, s);
  }
}

// Test entry point: every later launch takes placement p (kShared16 = 0,
// kGlobal32 = 1, kPairs = 2), or fails where it is not offered or does not
// fit; -1 restores the per-call choice.
extern "C" void cminhash_dense_force_placement(int p) {
  forced_placement().store(p);
}

extern "C" const char* cminhash_dense_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
