"""Random permutations — the paper's two-permutation substrate, in torch.

Conventions follow ``repro.core.permutations``: a permutation is an int32
vector ``p`` of length D with ``p[i]`` the value at position ``i``, and
applying ``sigma`` moves position ``i`` to ``sigma[i]``.
"""

from __future__ import annotations

import torch


def make_two_permutations(generator: torch.Generator, d: int, *,
                          device: str | torch.device = "cpu",
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sigma, pi): two uniformly random int32 permutations of [0, d).

    Drawn with ``torch.randperm`` from ``generator`` (a CPU generator), so
    the numbers differ from the JAX package's PRNG for the same seed.  To
    sign with the reference's own permutations, carry them across with
    ``repro_torch.convert.permutations_from_jax``.
    """
    sigma = torch.randperm(d, generator=generator).to(torch.int32)
    pi = torch.randperm(d, generator=generator).to(torch.int32)
    return sigma.to(device), pi.to(device)


def apply_permutation_sparse(idx: torch.Tensor,
                             sigma: torch.Tensor) -> torch.Tensor:
    """New non-zero positions for (B, NNZ) index lists; padding (< 0) stays."""
    safe = idx.clamp(0, sigma.shape[0] - 1).long()
    return torch.where(idx >= 0, sigma[safe], idx)
