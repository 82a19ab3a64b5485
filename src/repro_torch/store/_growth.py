"""Shared amortized-doubling growth for the store's numpy buffers."""

from __future__ import annotations

import numpy as np


def grown(arr: np.ndarray, need: int, axis: int = 0) -> np.ndarray:
    """Return ``arr`` if it already has ``need`` capacity along ``axis``,
    else a doubled-capacity reallocation with the old contents copied in
    (tail stays zero)."""
    cap = arr.shape[axis]
    if cap >= need:
        return arr
    while cap < need:
        cap *= 2
    shape = list(arr.shape)
    shape[axis] = cap
    out = np.zeros(shape, arr.dtype)
    sl = [slice(None)] * arr.ndim
    sl[axis] = slice(0, arr.shape[axis])
    out[tuple(sl)] = arr
    return out
