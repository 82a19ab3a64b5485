"""Jaccard estimators from signatures, and exact Jaccard for ground truth
(the paper's Eqs. 2, 4, 7).  Counterparts of ``repro.core.estimators``.

An estimate here is the float32 mean of 0/1 matches as the reference's
``jnp.mean`` computes it, ``count * float32(1 / K)`` (the reciprocal's
rounding, not a division), so the two agree bit for bit.  The collision
kernel's ``kernels.ops.estimated_jaccard_matrix`` is ``count / K``, as the
reference's ops are.
"""

from __future__ import annotations

import numpy as np
import torch


def jaccard_from_signatures(sig_a: torch.Tensor,
                            sig_b: torch.Tensor) -> torch.Tensor:
    """\\hat J = (1/K) sum_k 1{h_k(v) = h_k(w)} over matching leading
    shapes."""
    return match_mean(sig_a == sig_b)


def match_mean(eq: torch.Tensor) -> torch.Tensor:
    """float32 mean over the last axis of a bool tensor, as ``jnp.mean``:
    the match count times the float32 reciprocal of the axis length."""
    count = eq.sum(dim=-1, dtype=torch.int32).to(torch.float32)
    return count * torch.tensor(1.0 / eq.shape[-1], dtype=torch.float32)


def pairwise_jaccard_from_signatures(sig_q: torch.Tensor,
                                     sig_n: torch.Tensor) -> torch.Tensor:
    """(Q, K) x (N, K) -> (Q, N) estimated Jaccard (the plain path; the
    collision kernel's is ``kernels.ops.estimated_jaccard_matrix``)."""
    return jaccard_from_signatures(sig_q[:, None, :], sig_n[None, :, :])


def true_jaccard_dense(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact J for dense binary (..., D) pairs, float32 (0 where both are
    empty)."""
    a, b = v > 0, w > 0
    inter = (a & b).sum(dim=-1).to(torch.float32)
    union = (a | b).sum(dim=-1).to(torch.float32)
    return torch.where(union > 0, inter / union.clamp(min=1),
                       torch.zeros_like(union))


def true_jaccard_sparse(idx_a: np.ndarray, idx_b: np.ndarray) -> float:
    """Exact J for two padded sparse index lists (host-side)."""
    sa = set(int(i) for i in np.asarray(idx_a) if i >= 0)
    sb = set(int(i) for i in np.asarray(idx_b) if i >= 0)
    if not sa and not sb:
        return 0.0
    return len(sa & sb) / len(sa | sb)


def mae(estimates, truth) -> float:
    return float(np.mean(np.abs(np.asarray(estimates) - np.asarray(truth))))


def mse(estimates, truth) -> float:
    return float(np.mean((np.asarray(estimates) - np.asarray(truth)) ** 2))
