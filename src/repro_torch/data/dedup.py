"""Near-duplicate removal with C-MinHash + banded LSH — the corpus use of
the paper's technique, and a training pipeline's first stage.  The
counterpart of ``repro.data.dedup``, answering as it does.

Stages, in the reference's order:
  docs -> shingles (host, ``data.shingle``)
       -> C-MinHash signatures (``SketchEngine.signatures_sparse``: one
          launch of the sparse signing kernel over the corpus on a card)
       -> the signatures' host copy
       -> banded LSH candidate pairs (an index-only ``SketchStore``: host
          band fold and insert, ``candidate_pairs``)
       -> verification: the fraction of equal codes of each pair, an
          aligned gather and count on the signatures' device
       -> union-find clusters (host) -> keep one representative per cluster.

Each stage's seconds go to the registry's ``dedup.<stage>`` histogram.

Over a mesh the signing stage signs each rank's block of the documents
and all-gathers the words (``SketchEngine`` with ``mesh``), so the call is
collective: every rank passes the same documents and gets the whole
result back.  Every stage after signing runs on each rank as it does on
one device.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.engine import SketchConfig, SketchEngine
from ..core.lsh import UnionFind
from ..device import DEFAULT_DEVICE
from ..obs import metrics as obs_metrics
from ..store import SketchStore, StoreConfig
from .shingle import batch_shingles

STAGES = ("shingle", "sign", "copy", "index", "pairs", "verify", "union")
VERIFY_CHUNK = 1 << 16          # pairs gathered at a time


@dataclasses.dataclass(frozen=True)
class DedupConfig:
    d: int = 1 << 16            # shingle universe
    k: int = 256                # signature length
    shingle_n: int = 3
    n_bands: int = 64           # b=64, r=4: P[candidate] ~= 1-(1-J^4)^64,
    rows_per_band: int = 4      # >99% for J >= 0.5, <2% for J <= 0.15
    threshold: float = 0.5      # verified Jaccard-estimate cut
    seed: int = 0               # torch.Generator seed when no params given


@dataclasses.dataclass
class DedupResult:
    keep: np.ndarray            # indices of retained docs
    cluster_of: np.ndarray      # cluster id per doc (singletons included)
    n_candidates: int
    n_verified: int
    signatures: np.ndarray      # (n_docs, K)


def verify_pairs(sigs: torch.Tensor, pairs: np.ndarray,
                 threshold: float) -> np.ndarray:
    """(P,) bool: does pair (i, j) have a fraction of equal codes
    ``>= threshold``?  The count is exact on the signatures' device and the
    fraction is ``count / K`` in float64, as numpy's ``mean`` of the
    reference's 0/1 matches gives it, compared with the Python float."""
    k = sigs.shape[1]
    ok = []
    for lo in range(0, len(pairs), VERIFY_CHUNK):
        p = torch.from_numpy(pairs[lo: lo + VERIFY_CHUNK]).to(sigs.device)
        count = (sigs[p[:, 0]] == sigs[p[:, 1]]).sum(dim=1)
        ok.append(count.double() / k >= threshold)
    if not ok:
        return np.zeros(0, bool)
    return torch.cat(ok).cpu().numpy()


def dedup_corpus(docs: list[np.ndarray], cfg: DedupConfig, mesh=None, *,
                 device: str | torch.device = DEFAULT_DEVICE,
                 params: tuple[torch.Tensor, torch.Tensor] | None = None
                 ) -> DedupResult:
    """Dedup ``docs`` on ``device``, signing over ``mesh`` where given (a
    collective call; a corpus the batch axes do not divide raises
    ``ValueError``).  ``params=(sigma, pi)`` signs with given permutations
    (``convert.permutations_from_jax`` for the reference's); otherwise
    they are drawn from ``cfg.seed``."""
    if cfg.n_bands * cfg.rows_per_band != cfg.k:
        raise ValueError("n_bands * rows_per_band must equal k")
    reg = obs_metrics.default()
    t0 = time.perf_counter()

    def stage(name: str) -> None:
        nonlocal t0
        t1 = time.perf_counter()
        reg.histogram(f"dedup.{name}").observe(t1 - t0)
        t0 = t1

    idx = batch_shingles(docs, n=cfg.shingle_n, d=cfg.d)
    stage("shingle")
    engine = SketchEngine(SketchConfig(d=cfg.d, k=cfg.k, seed=cfg.seed),
                          mesh, device=device, params=params)
    sigs_dev = engine.signatures_sparse(idx)
    if sigs_dev.is_cuda:            # the copy below would wait here anyway
        torch.cuda.synchronize(sigs_dev.device)
    stage("sign")
    sigs = sigs_dev.cpu().numpy()
    stage("copy")

    # an index-only store: dedup needs candidate pairs, not stored codes;
    # its candidate_pairs() is exact (spilled entries pair through their
    # recorded band keys), so pairs equal the reference's dict grouping
    store = SketchStore(StoreConfig.sized_for(
        len(docs), k=cfg.k, n_bands=cfg.n_bands,
        rows_per_band=cfg.rows_per_band, store_signatures=False),
        device=engine.device)
    store.add(sigs)
    stage("index")
    pairs = store.candidate_pairs()                 # (P, 2) sorted unique
    stage("pairs")
    ok = verify_pairs(sigs_dev, pairs, cfg.threshold)
    stage("verify")

    # the reference unions the verified pairs in this (sorted) order
    uf = UnionFind(len(docs))
    for i, j in pairs[ok].tolist():
        uf.union(i, j)
    cluster_of = np.asarray([uf.find(i) for i in range(len(docs))])
    keep = np.unique(cluster_of)
    stage("union")
    return DedupResult(keep=keep, cluster_of=cluster_of,
                       n_candidates=len(pairs), n_verified=int(ok.sum()),
                       signatures=sigs)


def _pairs_within(*keys: np.ndarray) -> int:
    """Sum over the groups of equal key tuples of C(n, 2)."""
    _, n = np.unique(np.stack(keys, axis=1), axis=0, return_counts=True)
    return int((n * (n - 1) // 2).sum())


def dedup_metrics(result: DedupResult, truth_labels: np.ndarray) -> dict:
    """Pair-level precision/recall against planted duplicate clusters.

    The reference's counts over all pairs (i < j), from contingency counts
    instead of its O(n^2) loop: a pair is predicted when both documents
    share a cluster and true when both carry the same label >= 0, so tp
    sums C(n, 2) over the (cluster, label >= 0) cells."""
    cluster = np.asarray(result.cluster_of, np.int64)
    labels = np.asarray(truth_labels, np.int64)
    n = len(cluster)
    lab = labels >= 0
    predicted = _pairs_within(cluster)
    true = _pairs_within(labels[lab])
    tp = _pairs_within(cluster[lab], labels[lab])
    fp, fn = predicted - tp, true - tp
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    return {"precision": precision, "recall": recall, "tp": tp, "fp": fp,
            "fn": fn, "kept": len(result.keep), "total": n}
