"""Synthetic corpora: Zipf token streams, document sets with planted
near-duplicates, and binary datasets with text- and image-like sparsity
(the paper's Fig. 6/7 setups).  A numpy copy of ``repro.data.synthetic``'s:
the same seed gives the same arrays.
"""

from __future__ import annotations

import numpy as np


def zipf_tokens(rng: np.random.Generator, n: int, vocab: int,
                alpha: float = 1.2) -> np.ndarray:
    """Zipf-distributed token ids in [2, vocab) (0/1 reserved for pad/bos)."""
    ranks = rng.zipf(alpha, size=n)
    return (2 + (ranks - 1) % (vocab - 2)).astype(np.int32)


def corpus_with_duplicates(n_docs: int, *, vocab: int = 50_000,
                           doc_len: int = 256, dup_fraction: float = 0.3,
                           cluster_size: int = 3, edit_fraction: float = 0.05,
                           seed: int = 0):
    """Documents (list of int32 arrays) + ground-truth duplicate clusters.

    A ``dup_fraction`` of docs are near-copies: each cluster shares a base doc
    with ``edit_fraction`` of tokens resampled.
    Returns (docs, cluster_id per doc: -1 for unique docs).
    """
    rng = np.random.default_rng(seed)
    n_clustered = int(n_docs * dup_fraction)
    n_clusters = max(n_clustered // cluster_size, 1)
    docs: list[np.ndarray] = []
    labels: list[int] = []
    for c in range(n_clusters):
        base = zipf_tokens(rng, doc_len, vocab)
        for _ in range(cluster_size):
            doc = base.copy()
            n_edit = int(doc_len * edit_fraction)
            if n_edit:
                pos = rng.choice(doc_len, n_edit, replace=False)
                doc[pos] = zipf_tokens(rng, n_edit, vocab)
            docs.append(doc)
            labels.append(c)
    while len(docs) < n_docs:
        docs.append(zipf_tokens(rng, doc_len, vocab))
        labels.append(-1)
    order = rng.permutation(len(docs))
    return [docs[i] for i in order], np.asarray(labels)[order]


def binary_pairs(rng: np.random.Generator, n_pairs: int, d: int, f: int,
                 a: int, *, structured: bool = True):
    """(v, w) batches that are exact (D, f, a)-data pairs (paper Fig. 6).

    ``structured=True`` uses the paper's pattern (runs of O / x / -), the
    case where C-MinHash-(0,pi) degrades; False scatters uniformly.
    """
    v = np.zeros((n_pairs, d), np.int8)
    w = np.zeros((n_pairs, d), np.int8)
    for i in range(n_pairs):
        idx = np.arange(d) if structured else rng.permutation(d)
        both = idx[:a]
        only = idx[a:f]
        v[i, both] = 1
        w[i, both] = 1
        half = (f - a) // 2
        v[i, only[:half]] = 1
        w[i, only[half:]] = 1
    return v, w


def textlike_binary_dataset(rng: np.random.Generator, n: int, d: int,
                            mean_nnz: int) -> np.ndarray:
    """Sparse docs with Zipf-weighted feature popularity (text statistics)."""
    popularity = 1.0 / np.arange(1, d + 1) ** 1.1
    popularity /= popularity.sum()
    out = np.zeros((n, d), np.int8)
    for i in range(n):
        nnz = max(1, int(rng.poisson(mean_nnz)))
        feats = rng.choice(d, size=min(nnz, d), replace=False, p=popularity)
        out[i, feats] = 1
    return out


def imagelike_binary_dataset(rng: np.random.Generator, n: int, d: int,
                             block: int = 16,
                             p_on: float = 0.35) -> np.ndarray:
    """Binarized-image statistics: spatially correlated runs of on-pixels
    (the structured data where the initial permutation sigma matters)."""
    out = np.zeros((n, d), np.int8)
    n_blocks = d // block
    for i in range(n):
        on = rng.random(n_blocks) < p_on
        base = np.repeat(on, block)
        noise = rng.random(d) < 0.03
        out[i, : n_blocks * block] = (base ^ noise[: n_blocks * block])
    return out
