"""Dense signing and pairwise scoring: the library entry points the paper's
experiments call, and the packed-code scoring and top-k select the query
planner calls.

Signing goes through ``kernels.dispatch``; the b-bit packed-code format
lives in ``kernels.packfmt``.
"""

from __future__ import annotations

import torch

from . import dispatch
from .collision_kernel import (collision_counts_kernel,
                               packed_collision_counts_kernel)
from .packfmt import unpack_codes
from .topk_select import topk_select  # noqa: F401  (the planner's select)


def cminhash_signatures(v: torch.Tensor, pi: torch.Tensor, k: int,
                        sigma: torch.Tensor | None = None, *,
                        shift_offset: int = 1,
                        impl: str = "auto") -> torch.Tensor:
    """Dense C-MinHash signatures: (B, D) binary -> (B, K) int32, through
    the kernel ``impl`` picks (``dispatch.DENSE_IMPLS``)."""
    return dispatch.signatures_dense(v, pi, k, sigma,
                                     shift_offset=shift_offset, impl=impl)


def cminhash_signatures_packed(v: torch.Tensor, pi: torch.Tensor, k: int,
                               b: int, sigma: torch.Tensor | None = None, *,
                               shift_offset: int = 1,
                               impl: str = "auto") -> torch.Tensor:
    """Fused sign -> pack: (B, D) binary -> (B, ceil(K/(32/b))) int32
    words, bit-identical to ``pack_codes(cminhash_signatures(...), b)``."""
    return dispatch.signatures_dense(v, pi, k, sigma,
                                     shift_offset=shift_offset, impl=impl,
                                     pack_b=b)


def collision_counts(sig_q: torch.Tensor, sig_n: torch.Tensor) -> torch.Tensor:
    """(Q, K) x (N, K) int32 -> (Q, N) int32 match counts (the collision
    kernel on a CUDA device, its plain version on the CPU)."""
    return collision_counts_kernel(sig_q.contiguous(), sig_n.contiguous())


def estimated_jaccard_matrix(sig_q: torch.Tensor,
                             sig_n: torch.Tensor) -> torch.Tensor:
    """(Q, N) float32 estimated Jaccard from signatures: count / K."""
    k = sig_q.shape[-1]
    return collision_counts(sig_q, sig_n).to(torch.float32) / k


def packed_collision_counts(words_q: torch.Tensor, words_n: torch.Tensor,
                            k: int, b: int, *,
                            unpack_block_n: int = 16384) -> torch.Tensor:
    """(Q, W) x (N, W) packed int32 words -> (Q, N) int32 matching-code
    counts.  On a CUDA device, one launch of the collision kernel over the
    words as the index stores them.  On the CPU, the index side is unpacked
    and scored in blocks of ``unpack_block_n`` rows, so the unpacked (N', K)
    intermediate stays bounded while the resident index keeps its packed
    footprint."""
    if words_n.device.type != "cpu":
        return packed_collision_counts_kernel(words_q.contiguous(),
                                              words_n.contiguous(), k, b)
    uq = unpack_codes(words_q, k, b)
    n = words_n.shape[0]
    if n <= unpack_block_n:
        return collision_counts(uq, unpack_codes(words_n, k, b))
    parts = [collision_counts(
        uq, unpack_codes(words_n[lo: lo + unpack_block_n], k, b))
        for lo in range(0, n, unpack_block_n)]
    return torch.cat(parts, dim=1)


def packed_estimated_jaccard_matrix(words_q: torch.Tensor,
                                    words_n: torch.Tensor, k: int,
                                    b: int) -> torch.Tensor:
    """(Q, N) float32 estimated Jaccard from b-bit packed codes."""
    counts = packed_collision_counts(words_q, words_n, k, b)
    return counts.to(torch.float32) / k

