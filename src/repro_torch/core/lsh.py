"""Banded LSH on the host: bucket keys (numpy uint64, wrapping), candidate
pairs, union-find and the S-curve.

A copy of ``repro.core.lsh``: the ingest path hashes packed words on the
host before the numpy open-addressing insert, and dedup clusters its
verified pairs with ``UnionFind``.  Bucketing is index bookkeeping, not
device work.
"""

from __future__ import annotations

from collections import defaultdict

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


def candidate_pairs(bands: np.ndarray) -> set[tuple[int, int]]:
    """All (i, j) i<j sharing at least one band bucket (host-side dict
    grouping, as the reference's; the store's vectorized
    ``SketchStore.candidate_pairs`` gives the same pairs)."""
    bands = np.asarray(bands)
    cands: set[tuple[int, int]] = set()
    for col in range(bands.shape[1]):
        buckets: dict[int, list[int]] = defaultdict(list)
        for i, h in enumerate(bands[:, col]):
            buckets[int(h)].append(i)
        for members in buckets.values():
            if len(members) > 1:
                for ai in range(len(members)):
                    for bi in range(ai + 1, len(members)):
                        cands.add((members[ai], members[bi]))
    return cands


class UnionFind:
    """Host-side union-find for duplicate clustering.  ``union`` roots the
    merged set at the smaller root, so ``find(i)`` is the smallest index of
    i's component."""

    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, i: int) -> int:
        while self.parent[i] != i:
            self.parent[i] = self.parent[self.parent[i]]
            i = self.parent[i]
        return i

    def union(self, i: int, j: int) -> None:
        ri, rj = self.find(i), self.find(j)
        if ri != rj:
            self.parent[max(ri, rj)] = min(ri, rj)

    def clusters(self) -> dict[int, list[int]]:
        out: dict[int, list[int]] = defaultdict(list)
        for i in range(len(self.parent)):
            out[self.find(i)].append(i)
        return dict(out)


def candidate_probability(j: float, n_bands: int, rows_per_band: int) -> float:
    """The LSH S-curve: P = 1 - (1 - J^r)^b."""
    return 1.0 - (1.0 - j ** rows_per_band) ** n_bands
