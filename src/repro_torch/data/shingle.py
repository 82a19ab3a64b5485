"""Documents -> n-gram shingles -> sparse index lists in a D-dim universe.

A numpy copy of ``repro.data.shingle``.
"""

from __future__ import annotations

import numpy as np

_P1 = np.uint64(11400714819323198485)
_P2 = np.uint64(14029467366897019727)


def shingle_indices(tokens: np.ndarray, *, n: int = 3, d: int = 1 << 16,
                    max_nnz: int | None = None) -> np.ndarray:
    """n-gram rolling hash of a token array -> sorted unique indices in [0, d).

    Returns an int32 array; pad with -1 to ``max_nnz`` if given.
    """
    t = np.asarray(tokens, np.uint64)
    if t.size < n:
        h = np.zeros(1, np.uint64)
    else:
        h = np.zeros(t.size - n + 1, np.uint64)
        for i in range(n):
            h = (h * _P1 + t[i: t.size - n + 1 + i] * _P2)
    idx = np.unique((h % np.uint64(d)).astype(np.int64)).astype(np.int32)
    if max_nnz is not None:
        out = np.full(max_nnz, -1, np.int32)
        out[: min(len(idx), max_nnz)] = idx[:max_nnz]
        return out
    return idx


def batch_shingles(docs: list[np.ndarray], *, n: int = 3, d: int = 1 << 16,
                   max_nnz: int | None = None) -> np.ndarray:
    """(B, max_nnz) padded sparse index matrix for a list of documents."""
    idxs = [shingle_indices(doc, n=n, d=d) for doc in docs]
    width = max_nnz or max(len(i) for i in idxs)
    out = np.full((len(docs), width), -1, np.int32)
    for row, idx in enumerate(idxs):
        out[row, : min(len(idx), width)] = idx[:width]
    return out
