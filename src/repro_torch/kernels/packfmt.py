"""b-bit packed-code format: the storage layout, in torch.

K codes of b bits each are packed little-endian into ceil(K / (32/b))
32-bit words: code j of a row lives at bit (j % (32/b)) * b of word
j // (32/b).  b == 32 is a bitcast (one code per word).  Words are int32
tensors carrying uint32 bits; ``repro_torch.device`` converts at the host
boundary.  The CUDA signing kernel's fused epilogue packs to this layout.
"""

from __future__ import annotations

import torch

PACK_BITS = (1, 2, 4, 8, 16, 32)  # b values whose codes tile a 32-bit word


def pack_geometry(k: int, b: int) -> tuple[int, int]:
    """-> (codes_per_word, n_words) for K b-bit codes."""
    if b not in PACK_BITS:
        raise ValueError(f"b must be one of {PACK_BITS} (got {b})")
    codes_per_word = 32 // b
    return codes_per_word, -(-k // codes_per_word)


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same low 32 bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def pack_codes(sig: torch.Tensor, b: int) -> torch.Tensor:
    """(B, K) int32 signatures -> (B, W) int32 words (uint32 bits)."""
    bsz, k = sig.shape
    cpw, n_words = pack_geometry(k, b)
    if b == 32:
        return sig.to(torch.int32).clone()
    codes = (sig.to(torch.int64) & ((1 << b) - 1))
    pad = n_words * cpw - k
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad))
    shifts = torch.arange(cpw, dtype=torch.int64, device=sig.device) * b
    words = (codes.reshape(bsz, n_words, cpw) << shifts).sum(-1)
    return wrap_int32(words)


def unpack_codes(words: torch.Tensor, k: int, b: int) -> torch.Tensor:
    """(B, W) int32 words -> (B, K) int32 codes in [0, 2^b); at b = 32 a
    view of ``words``."""
    bsz = words.shape[0]
    cpw, n_words = pack_geometry(k, b)
    if b == 32:
        return words[:, :k]
    shifts = torch.arange(cpw, dtype=torch.int32, device=words.device) * b
    # arithmetic >> is fine: the mask keeps bits s..s+b-1, all below bit 32
    codes = (words[:, :, None] >> shifts) & ((1 << b) - 1)
    return codes.reshape(bsz, n_words * cpw)[:, :k]
