"""Random permutations and circulant shifts — the paper's two-permutation
substrate, in torch.

Conventions follow ``repro.core.permutations``: a permutation is an int32
vector ``p`` of length D with ``p[i]`` the value at position ``i``; the
circulant right-shift by ``k`` is ``p_{->k}[i] = p[(i - k) mod D]``; and
applying ``sigma`` moves position ``i`` to ``sigma[i]``: ``v'[sigma[i]] =
v[i]``.
"""

from __future__ import annotations

import torch

from ..device import DEFAULT_DEVICE, resolve_device


def make_two_permutations(generator: torch.Generator, d: int, *,
                          device: str | torch.device = DEFAULT_DEVICE,
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sigma, pi): two uniformly random int32 permutations of [0, d), on
    ``device`` (the card unless the caller asks for the CPU).

    Drawn with ``torch.randperm`` from ``generator`` (a CPU generator), so
    the numbers differ from the JAX package's PRNG for the same seed.  To
    sign with the reference's own permutations, carry them across with
    ``repro_torch.convert.permutations_from_jax``.
    """
    dev = resolve_device(device)
    sigma = torch.randperm(d, generator=generator).to(torch.int32)
    pi = torch.randperm(d, generator=generator).to(torch.int32)
    return sigma.to(dev), pi.to(dev)


def circulant_shift(p: torch.Tensor, k: int) -> torch.Tensor:
    """p_{->k}[i] = p[(i - k) mod d] == torch.roll(p, k)."""
    return torch.roll(p, k)


def apply_permutation_dense(v: torch.Tensor,
                            sigma: torch.Tensor) -> torch.Tensor:
    """v'[..., sigma[i]] = v[..., i] along the last axis (a scatter)."""
    out = torch.zeros_like(v)
    out[..., sigma.long()] = v
    return out


def apply_permutation_sparse(idx: torch.Tensor,
                             sigma: torch.Tensor) -> torch.Tensor:
    """New non-zero positions for (B, NNZ) index lists; padding (< 0) stays."""
    safe = idx.clamp(0, sigma.shape[0] - 1).long()
    return torch.where(idx >= 0, sigma[safe], idx)


def invert_permutation(p: torch.Tensor) -> torch.Tensor:
    """q with q[p[i]] = i, int32."""
    q = torch.empty_like(p, dtype=torch.int32)
    q[p.long()] = torch.arange(p.shape[0], dtype=torch.int32,
                               device=p.device)
    return q
