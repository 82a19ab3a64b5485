"""Synthetic corpora: Zipf token streams and document sets with planted
near-duplicates.  A numpy copy of ``repro.data.synthetic``'s.
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
