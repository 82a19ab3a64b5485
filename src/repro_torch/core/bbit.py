"""b-bit minwise hashing (Li & Koenig, 2011) on top of C-MinHash
signatures: keep the lowest b bits of each hash, and expand them into
one-hot features for linear models.  Counterparts of ``repro.core.bbit``.
"""

from __future__ import annotations

import torch

from .estimators import match_mean


def lowest_b_bits(sig: torch.Tensor, b: int) -> torch.Tensor:
    """(..., K) int32 signatures -> (..., K) int32 values in [0, 2^b)."""
    return (sig & ((1 << b) - 1)).to(torch.int32)


def bbit_features(sig: torch.Tensor, b: int) -> torch.Tensor:
    """One-hot expansion: (B, K) -> (B, K * 2^b) float32 in {0, 1}."""
    codes = lowest_b_bits(sig, b).long()
    onehot = torch.nn.functional.one_hot(codes, 1 << b).to(torch.float32)
    return onehot.reshape(sig.shape[0], -1)


def bbit_collision_fraction(sig_a: torch.Tensor, sig_b: torch.Tensor,
                            b: int) -> torch.Tensor:
    """Fraction of matching b-bit codes, the float32 mean as the reference
    computes it (biased up against J; see Li & Koenig)."""
    return match_mean(lowest_b_bits(sig_a, b) == lowest_b_bits(sig_b, b))
