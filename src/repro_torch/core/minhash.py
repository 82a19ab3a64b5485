"""Classical K-permutation MinHash (the paper's Algorithm 1), its baseline.

Kept as the paper describes it: K independent permutations of length D,
K*D int32 of parameters, the cost C-MinHash removes.  Plain torch on both
devices, as the reference computes it in jnp outside any Pallas kernel;
temporaries are cut into chunks of at most ``_BUDGET`` elements.
"""

from __future__ import annotations

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .cminhash import _BUDGET, SENTINEL, _chunks


def make_k_permutations(generator: torch.Generator, d: int, k: int, *,
                        device: str | torch.device = DEFAULT_DEVICE,
                        ) -> torch.Tensor:
    """(K, D) int32: K uniformly random permutations of [0, d) drawn with
    ``torch.randperm`` from ``generator`` (a CPU generator).  To compare
    with the reference under its own permutations, carry them across with
    ``repro_torch.convert.k_permutations_from_jax``."""
    dev = resolve_device(device)
    perms = torch.stack([torch.randperm(d, generator=generator)
                         for _ in range(k)]).to(torch.int32)
    return perms.to(dev)


def minhash_dense(v: torch.Tensor, perms: torch.Tensor) -> torch.Tensor:
    """(B, D) binary rows (set where > 0) and (K, D) permutations -> (B, K)
    int32, h_k(v) = min_{i : v_i > 0} perms[k, i] (SENTINEL for an empty
    row)."""
    mask = v > 0
    b, d = mask.shape
    k = perms.shape[0]
    perms = perms.to(torch.int32)
    out = torch.empty((b, k), dtype=torch.int32, device=v.device)
    rows, kc = _chunks(b, k, d)
    for r0 in range(0, b, rows):
        m = mask[r0: r0 + rows, None, :]
        for k0 in range(0, k, kc):
            out[r0: r0 + rows, k0: k0 + kc] = torch.where(
                m, perms[None, k0: k0 + kc], SENTINEL).amin(dim=-1)
    return out


def minhash_sparse(idx: torch.Tensor, perms: torch.Tensor) -> torch.Tensor:
    """(B, NNZ) padded index lists (padding < 0) and (K, D) permutations ->
    (B, K) int32."""
    b, nnz = idx.shape
    k, d = perms.shape
    out = torch.full((b, k), SENTINEL, dtype=torch.int32, device=idx.device)
    if nnz == 0:
        return out
    valid = idx >= 0
    safe = idx.clamp(0, d - 1).long()
    perms = perms.to(torch.int32)
    kc = max(1, min(k, _BUDGET // max(1, b * nnz)))
    for k0 in range(0, k, kc):
        vals = perms[k0: k0 + kc][:, safe]                    # (kc, B, NNZ)
        vals = torch.where(valid[None], vals, SENTINEL)
        out[:, k0: k0 + kc] = vals.amin(dim=-1).T
    return out
