"""C-MinHash — the paper's Algorithms 2 and 3 as plain torch.

Two variants:
  * ``sigma=None``  -> C-MinHash-(0,pi)   (location-dependent variance)
  * ``sigma`` given -> C-MinHash-(sigma,pi) (uniformly better than MinHash)

The identity every path uses (``repro.core.cminhash``):

    h_k(v) = min_{i : v'_i != 0} pi[(i - k) mod D]
           = min_{m : v'[(m + k) mod D] != 0} pi[m]

``cminhash_dense`` is the second form (a masked min of the fixed vector pi
against a circulantly rolled window of the data), ``cminhash_sparse`` the
first (a gather per non-zero).  K <= D is required; ``shift_offset=1``
gives k = 1..K.  Both keep every temporary under ``_BUDGET`` elements by
cutting rows and hashes into chunks, so they run at a serving batch on the
card as well as on the CPU.
"""

from __future__ import annotations

import torch

from .permutations import apply_permutation_dense, apply_permutation_sparse

SENTINEL = 2 ** 31 - 1
_BUDGET = 1 << 24     # elements in the largest temporary


def _check(d: int, k: int) -> None:
    if k > d:
        raise ValueError(f"C-MinHash requires K <= D (got K={k}, D={d})")


def _chunks(n_rows: int, n_cols: int, width: int) -> tuple[int, int]:
    """Rows and columns per chunk so that rows * cols * width <= _BUDGET
    (at least one of each)."""
    rows = max(1, min(n_rows, _BUDGET // max(1, width)))
    cols = max(1, min(n_cols, _BUDGET // max(1, rows * width)))
    return rows, cols


def cminhash_dense(v: torch.Tensor, pi: torch.Tensor, k: int,
                   sigma: torch.Tensor | None = None, *,
                   shift_offset: int = 1) -> torch.Tensor:
    """Signatures for dense binary vectors: (B, D) -> (B, K) int32.  An
    entry counts as set when it is > 0."""
    d = v.shape[-1]
    _check(d, k)
    if sigma is not None:
        v = apply_permutation_dense(v, sigma)
    mask = v > 0
    b = mask.shape[0]
    pi = pi.to(torch.int32)
    out = torch.empty((b, k), dtype=torch.int32, device=v.device)
    rows, qc = _chunks(b, k, d)
    for r0 in range(0, b, rows):
        m = mask[r0: r0 + rows]
        ext = torch.cat([m, m[:, : k + shift_offset]], dim=1)
        # win[:, q] is ext[:, q + off : q + off + D], a view
        win = ext.unfold(1, d, 1)[:, shift_offset: shift_offset + k]
        for q0 in range(0, k, qc):
            out[r0: r0 + rows, q0: q0 + qc] = torch.where(
                win[:, q0: q0 + qc], pi, SENTINEL).amin(dim=-1)
    return out


def cminhash_sparse(idx: torch.Tensor, pi: torch.Tensor, k: int,
                    sigma: torch.Tensor | None = None, *,
                    shift_offset: int = 1) -> torch.Tensor:
    """Signatures for padded sparse index lists: (B, NNZ) -> (B, K) int32.

    h_k = min_{j valid} pi[(idx_j - k) mod D]: O(B * NNZ * K) gathers, the
    economical form when NNZ << D.  Padding entries are < 0; a row without
    a valid entry signs to SENTINEL."""
    d = pi.shape[0]
    _check(d, k)
    if sigma is not None:
        idx = apply_permutation_sparse(idx, sigma)
    b, nnz = idx.shape
    out = torch.full((b, k), SENTINEL, dtype=torch.int32, device=idx.device)
    if nnz == 0:
        return out
    valid = idx >= 0
    safe = torch.where(valid, idx, 0).long()
    pi = pi.to(torch.int32)
    ks = shift_offset + torch.arange(k, device=idx.device)
    rows, kc = _chunks(b, k, nnz)
    for r0 in range(0, b, rows):
        s, ok = safe[r0: r0 + rows], valid[r0: r0 + rows]
        for q0 in range(0, k, kc):
            pos = (s[:, None, :] - ks[q0: q0 + kc, None]) % d  # (r, kc, NNZ)
            vals = torch.where(ok[:, None, :], pi[pos], SENTINEL)
            out[r0: r0 + rows, q0: q0 + kc] = vals.amin(dim=-1)
    return out


def compute_signatures(data: torch.Tensor, pi: torch.Tensor, k: int,
                       sigma: torch.Tensor | None = None, *,
                       layout: str = "dense",
                       shift_offset: int = 1) -> torch.Tensor:
    """Layout-dispatching front door (the examples' entry)."""
    if layout == "dense":
        return cminhash_dense(data, pi, k, sigma, shift_offset=shift_offset)
    if layout == "sparse":
        return cminhash_sparse(data, pi, k, sigma, shift_offset=shift_offset)
    raise ValueError(f"unknown layout {layout!r}")
