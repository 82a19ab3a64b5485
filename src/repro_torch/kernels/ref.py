"""Plain-torch oracles for the kernels, in the most obvious form.

Explicit rolls and broadcasts, independent of the kernels' plain versions
and of their operand layouts, so that a layout fault cannot cancel out.
They hold whole (B, D) or (Q, N, K) temporaries: small inputs only (the
tests).  Counterparts of ``repro.kernels.ref``.
"""

from __future__ import annotations

import torch

SENTINEL = 2 ** 31 - 1


def cminhash_dense_ref(v: torch.Tensor, pi: torch.Tensor, k: int, *,
                       shift_offset: int = 1) -> torch.Tensor:
    """h_q = min_m { pi[m] : v[(m + q + shift_offset) mod D] > 0 }, q < K.

    v: (B, D) binary, already sigma-permuted; pi: (D,) int32.  Returns
    (B, K) int32."""
    mask = v > 0
    pi = pi.to(torch.int32)
    cols = [torch.where(torch.roll(mask, -(q + shift_offset), dims=-1), pi,
                        SENTINEL).amin(dim=-1) for q in range(k)]
    return torch.stack(cols, dim=-1).to(torch.int32)


def collision_count_ref(sig_q: torch.Tensor,
                        sig_n: torch.Tensor) -> torch.Tensor:
    """(Q, K) x (N, K) int32 -> (Q, N) int32 match counts."""
    eq = sig_q[:, None, :] == sig_n[None, :, :]
    return eq.sum(dim=-1, dtype=torch.int32)


def packed_collision_count_ref(words_q: torch.Tensor, words_n: torch.Tensor,
                               k: int, b: int) -> torch.Tensor:
    """(Q, W) x (N, W) b-bit packed words (int32 carrying uint32 bits) ->
    (Q, N) int32 matching-code counts, from the XOR of each word pair (a
    b-bit field matches iff its XOR field is zero); shares no unpack helper
    with ``packfmt``."""
    x = (words_q[:, None, :].long() ^ words_n[None, :, :].long()) \
        & 0xFFFFFFFF                                        # (Q, N, W)
    cpw = 32 // b
    shifts = torch.arange(cpw, device=x.device) * b
    fields = (x[..., None] >> shifts) & ((1 << b) - 1)     # (Q, N, W, cpw)
    q, n, w = x.shape
    match = (fields == 0).reshape(q, n, w * cpw)[..., :k]
    return match.sum(dim=-1, dtype=torch.int32)
