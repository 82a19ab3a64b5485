"""Carrying the JAX package's parameters across to the port.

``torch.randperm`` cannot reproduce JAX's PRNG, so a port service that must
answer like a reference service takes the reference's two permutations as
host arrays (``np.asarray(engine.sigma)``, ``np.asarray(engine.pi)``) and
signs with exactly those; classical MinHash takes the reference's (K, D)
permutation set the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def _as_permutation(p: np.ndarray, name: str) -> np.ndarray:
    p = np.asarray(p)
    if p.ndim != 1 or not np.issubdtype(p.dtype, np.integer):
        raise ValueError(f"{name} must be a 1-D integer array")
    if not np.array_equal(np.sort(p), np.arange(len(p))):
        raise ValueError(f"{name} is not a permutation of [0, {len(p)})")
    return p.astype(np.int32)


def permutations_from_jax(sigma: np.ndarray, pi: np.ndarray,
                          device: str | torch.device,
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference (sigma, pi) host arrays -> the port's int32 tensors on
    ``device``; pass the pair as ``params=`` to ``SketchEngine`` or
    ``SimilaritySearchService``."""
    sigma = _as_permutation(sigma, "sigma")
    pi = _as_permutation(pi, "pi")
    if len(sigma) != len(pi):
        raise ValueError(f"sigma and pi differ in length: {len(sigma)} vs "
                         f"{len(pi)}")
    dev = resolve_device(device)
    return torch.tensor(sigma, device=dev), torch.tensor(pi, device=dev)


def k_permutations_from_jax(perms: np.ndarray, device: str | torch.device,
                            ) -> torch.Tensor:
    """Reference (K, D) permutation set (``repro.core.minhash.
    make_k_permutations``, as a host array) -> the port's int32 tensor on
    ``device``, for ``core.minhash``."""
    perms = np.asarray(perms)
    if perms.ndim != 2:
        raise ValueError(f"perms must be (K, D) (got shape {perms.shape})")
    rows = [_as_permutation(p, f"perms[{i}]") for i, p in enumerate(perms)]
    out = np.stack(rows) if rows else np.zeros(perms.shape, np.int32)
    return torch.tensor(out, device=resolve_device(device))
