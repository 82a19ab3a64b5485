// Band-hash fold of one band, shared by the fold kernel (fold.cu) and the
// probe kernel's words-in prologue (lsh_probe.cu).
//
// The polynomial fold of a band's R codes,
//     h = 0;  for r < R:  h = h * 0x9E3779B97F4A7C15 + x_r + 1;  h ^= h >> 29
// in wrapping uint64 arithmetic, bit-identical to core.lsh._poly_fold and to
// the two-uint32-plane emulation of the JAX package's Pallas fold
// (src/repro/kernels/query_fused.py _fold_kernel).  Hopper has native 64-bit
// integers, so the fold is a chain of 64-bit multiply-adds.  The codes
// arrive as int32 (uint32 bits): packed words zero-extend (sign_extend =
// false), raw int32 signature codes sign-extend (sign_extend = true), as the
// host fold's astype(np.uint64) does for each.
//
// The chain is serial, so what a caller waits on is the loads: a row whose
// R codes make whole 16-byte vectors (R % 4 == 0) and that starts on a
// 16-byte boundary is read as int4 loads, up to kFoldVec of them issued
// before the chain consumes the first; any other row is read with scalar
// loads.

#pragma once

#include <cstdint>

namespace band_fold {

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

}  // namespace band_fold
