// The fused b-bit pack epilogue of the three signing kernels
// (cminhash_sparse.cu, cminhash_dense.cu, cminhash_packed.cu).
//
// Layout (kernels/packfmt.py): K codes of b bits are packed little-endian
// into ceil(K / (32/b)) 32-bit words, code q at bit (q % (32/b)) * b of word
// q / (32/b); b = 32 is a bitcast.  A row with no set entry keeps SENTINEL =
// 2^31-1, whose low b bits are all ones, as packfmt.pack_codes gives.
//
// store_codes is called by all 32 lanes of a warp together, lane l holding
// hash q with q % 32 == l (lanes with q >= K pass anything): the 32/b codes
// of a word sit on neighbouring lanes and are ORed together with a shuffle
// butterfly, and the lane holding the word's first code writes it.

#pragma once

#include <cuda_runtime.h>

namespace cminhash {

constexpr int kSentinel = 0x7fffffff;

// out_row: the row's K codes (pack_b == 0) or its n_words words.
__device__ __forceinline__ void store_codes(int* __restrict__ out_row, int q,
                                            int K, int h, int pack_b) {
  if (pack_b == 0) {
    if (q < K) out_row[q] = h;
    return;
  }
  const int cpw = 32 / pack_b;
  const unsigned mask = pack_b == 32 ? 0xffffffffu : ((1u << pack_b) - 1u);
  const unsigned code = q < K ? (static_cast<unsigned>(h) & mask) : 0u;
  unsigned word = code << ((q % cpw) * pack_b % 32);
  for (int s = 1; s < cpw; s <<= 1)
    word |= __shfl_xor_sync(0xffffffffu, word, s);
  if (q % cpw == 0 && q < K) out_row[q / cpw] = static_cast<int>(word);
}

}  // namespace cminhash
