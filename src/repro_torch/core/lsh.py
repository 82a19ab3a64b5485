"""Banded LSH bucket keys on the host (numpy uint64, wrapping).

A copy of ``repro.core.lsh``'s fold: the ingest path hashes packed words
on the host before the numpy open-addressing insert.
"""

from __future__ import annotations

import numpy as np

_BASE = np.uint64(0x9E3779B97F4A7C15)  # Fibonacci hashing multiplier


def _poly_fold(rows: np.ndarray) -> np.ndarray:
    """(B, n_bands, R) uint64 -> (B, n_bands) uint64 polynomial-fold keys:
    ``h = h * BASE + x + 1; h ^= h >> 29`` over the R rows of each band."""
    with np.errstate(over="ignore"):
        h = np.zeros(rows.shape[:2], np.uint64)
        for r in range(rows.shape[2]):
            h = h * _BASE + rows[:, :, r] + np.uint64(1)
            h ^= h >> np.uint64(29)
    return h


def band_hashes(sig, n_bands: int, rows_per_band: int) -> np.ndarray:
    """(B, K) int32 signatures -> (B, n_bands) uint64 bucket keys (negative
    codes sign-extend, as ``astype(np.uint64)`` does)."""
    sig = np.asarray(sig)
    b, k = sig.shape
    if n_bands * rows_per_band != k:
        raise ValueError(
            f"K={k} != n_bands*rows_per_band={n_bands * rows_per_band}")
    return _poly_fold(sig.reshape(b, n_bands, rows_per_band)
                      .astype(np.uint64))


def band_hashes_packed(words: np.ndarray, n_bands: int) -> np.ndarray:
    """(B, W) packed uint32 words -> (B, n_bands) uint64 bucket keys; needs
    W % n_bands == 0 (bands start on word boundaries)."""
    words = np.asarray(words)
    b, w = words.shape
    if w % n_bands:
        raise ValueError(
            f"W={w} not divisible by n_bands={n_bands}: rows_per_band must "
            "be a multiple of 32/b for packed banding")
    return _poly_fold(words.reshape(b, n_bands, w // n_bands)
                      .astype(np.uint64))
