"""The port's dedup pipeline against the JAX package's, on the CPU.

``dedup_corpus`` with the reference's two permutations (carried across by
``permutations_from_jax``) must return the reference's result in every
field: keep, cluster_of, the candidate and verified counts and the
signatures, tolerance 0.  ``dedup_metrics`` counts by contingency and must
give the reference's O(n^2) loop's dict in every key.  Also the host LSH
bookkeeping (``candidate_pairs``, ``UnionFind``, ``candidate_probability``)
and the loader (``PrefetchIterator``, ``deduped_token_batches``).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import lsh as ref_lsh
from repro.core import permutations as ref_perm
from repro.data import dedup as ref_dedup
from repro.data import loader as ref_loader
from repro.data.synthetic import corpus_with_duplicates
from repro_torch import convert
from repro_torch.core import lsh as t_lsh
from repro_torch.data import dedup as t_dedup
from repro_torch.data import loader as t_loader

ROOT = Path(__file__).resolve().parent.parent
FIELDS = [f.name for f in dataclasses.fields(ref_dedup.DedupResult)]


def _params(cfg):
    sigma, pi = ref_perm.make_two_permutations(jax.random.PRNGKey(cfg.seed),
                                               cfg.d)
    return convert.permutations_from_jax(np.asarray(sigma), np.asarray(pi),
                                         "cpu")


def _both(docs, **kw):
    ref_cfg = ref_dedup.DedupConfig(**kw)
    cfg = t_dedup.DedupConfig(**kw)
    want = ref_dedup.dedup_corpus(docs, ref_cfg)
    got = t_dedup.dedup_corpus(docs, cfg, device="cpu", params=_params(cfg))
    return got, want


def _assert_same_result(got, want):
    assert [f.name for f in dataclasses.fields(got)] == FIELDS
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert np.array_equal(a, b), name
        else:
            assert type(a) is type(b) and a == b, name


# the reference tests' sizes (test_dedup_search.py), with and without
# planted duplicates, and the example's configuration
@pytest.mark.parametrize("n,dup,seed,kw", [
    (60, 0.4, 3, dict(d=1 << 12, k=128, n_bands=32, rows_per_band=4)),
    (30, 0.0, 4, dict(d=1 << 12, k=128, n_bands=32, rows_per_band=4)),
    (120, 0.3, 0, dict(d=1 << 14, k=256, n_bands=64, rows_per_band=4)),
    (80, 0.5, 7, dict(d=1 << 12, k=64, n_bands=8, rows_per_band=8,
                      threshold=0.3, seed=5)),
])
def test_dedup_corpus_matches_reference(n, dup, seed, kw):
    docs, labels = corpus_with_duplicates(n, vocab=5000, doc_len=128,
                                          dup_fraction=dup, seed=seed)
    got, want = _both(docs, **kw)
    _assert_same_result(got, want)
    assert t_dedup.dedup_metrics(got, labels) == \
        ref_dedup.dedup_metrics(want, labels)


def _edited(base, n_changed, rng, vocab=5000):
    doc = base.copy()
    pos = rng.choice(len(doc), n_changed, replace=False)
    doc[pos] = rng.integers(vocab, 2 * vocab, n_changed)
    return doc


def test_threshold_edge_exactly_seventy_of_a_hundred():
    """K = 100, threshold 0.7, with candidate pairs at exactly 70 matches:
    70/100 is 0.7 in float64 and passes, but a float32 fraction
    (0.699999988) held against the float64 threshold fails, and one held
    against a float32 threshold passes 0.7 + 1e-9 too."""
    docs, _ = corpus_with_duplicates(40, vocab=5000, doc_len=128,
                                     dup_fraction=0.5, seed=9)
    rng = np.random.default_rng(0)
    docs = docs + [_edited(docs[i], c, rng)
                   for i in range(len(docs)) for c in (6, 7, 8)]
    kw = dict(d=1 << 12, k=100, n_bands=25, rows_per_band=4, threshold=0.7)
    got, want = _both(docs, **kw)
    _assert_same_result(got, want)
    sigs = got.signatures
    cands = t_lsh.candidate_pairs(t_lsh.band_hashes(sigs, 25, 4))
    matches = [int((sigs[i] == sigs[j]).sum()) for i, j in cands]
    assert matches.count(70) >= 2, sorted(matches)
    # the rule on one pair: 70 of 100 passes 0.7, 69 does not
    sig = torch.zeros((2, 100), dtype=torch.int32)
    sig[1, :30] = 1
    pair = np.array([[0, 1]])
    assert t_dedup.verify_pairs(sig, pair, 0.7)[0]
    assert not t_dedup.verify_pairs(sig, pair, 0.7 + 1e-9)[0]
    sig[1, 30] = 1
    assert not t_dedup.verify_pairs(sig, pair, 0.7)[0]
    assert float(np.float32(70) / np.float32(100)) < 0.7 <= 70 / 100


def test_verify_pairs_matches_numpy_mean_over_every_count():
    """Every count 0..K against numpy's float64 mean, at thresholds that
    land between, on and off the representable fractions."""
    for k in (100, 128, 37):
        sig = torch.zeros((k + 1, k), dtype=torch.int32)
        for c in range(k + 1):
            sig[c, c:] = 1                      # row c matches row 0 at c
        pairs = np.stack([np.zeros(k + 1, np.int64),
                          np.arange(k + 1, dtype=np.int64)], 1)
        pairs = pairs[1:]
        s = sig.numpy()
        for thr in (0.0, 0.3, 0.5, 0.7, 0.7 + 1e-9, 0.7 - 1e-9, 0.71, 0.9,
                    1.0, 1 / 3, 2 / 3):
            want = (s[pairs[:, 0]] == s[pairs[:, 1]]).mean(axis=1) >= thr
            got = t_dedup.verify_pairs(sig, pairs, thr)
            assert np.array_equal(got, want), (k, thr)
    assert t_dedup.verify_pairs(sig, np.zeros((0, 2), np.int64),
                                0.5).shape == (0,)


def test_dedup_single_document_and_identical_corpus():
    doc = np.arange(60, dtype=np.int32)
    kw = dict(d=1 << 12, k=128, n_bands=32, rows_per_band=4)
    got, want = _both([doc], **kw)
    _assert_same_result(got, want)
    assert got.n_candidates == 0 and list(got.keep) == [0]
    got, want = _both([doc] * 5, **kw)
    _assert_same_result(got, want)
    assert list(got.keep) == [0] and got.n_verified == 10


def test_dedup_refuses_bands_that_do_not_cover_k():
    with pytest.raises(ValueError, match="n_bands"):
        t_dedup.dedup_corpus([np.arange(10)], t_dedup.DedupConfig(
            k=100, n_bands=30, rows_per_band=3), device="cpu")


def test_dedup_default_config_is_the_reference_one():
    assert dataclasses.asdict(t_dedup.DedupConfig()) == \
        dataclasses.asdict(ref_dedup.DedupConfig())


def test_dedup_records_each_stage():
    from repro_torch.obs import metrics as obs_metrics
    reg = obs_metrics.default()
    before = {s: reg.histogram(f"dedup.{s}").count for s in t_dedup.STAGES}
    docs, _ = corpus_with_duplicates(20, vocab=500, doc_len=64, seed=1)
    t_dedup.dedup_corpus(docs, t_dedup.DedupConfig(
        d=1 << 10, k=32, n_bands=8, rows_per_band=4), device="cpu")
    for s in t_dedup.STAGES:
        assert reg.histogram(f"dedup.{s}").count == before[s] + 1, s


# -- dedup_metrics ------------------------------------------------------------

def _result(cluster_of):
    cluster_of = np.asarray(cluster_of)
    return ref_dedup.DedupResult(keep=np.unique(cluster_of),
                                 cluster_of=cluster_of, n_candidates=0,
                                 n_verified=0,
                                 signatures=np.zeros((len(cluster_of), 1)))


@pytest.mark.parametrize("seed", range(6))
def test_dedup_metrics_match_reference_loop(seed):
    """Random clusterings against random labels, unlabeled documents
    (label -1) included; every key equal."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 90))
    labels = rng.integers(-1, max(2, n // 4), n)
    labels[rng.random(n) < 0.3] = -1
    roots = rng.integers(0, n, n)
    cluster_of = np.minimum(roots, np.arange(n))
    res = _result(cluster_of)
    assert t_dedup.dedup_metrics(res, labels) == \
        ref_dedup.dedup_metrics(res, labels)


@pytest.mark.parametrize("cluster_of,labels", [
    ([0], [-1]), ([0], [3]), ([0, 0], [-1, -1]), ([0, 1], [2, 2]),
    ([0, 0, 0], [-1, 1, 1]), ([0, 1, 2, 3], [-1, -1, -1, -1]),
])
def test_dedup_metrics_small_and_unlabeled_corpora(cluster_of, labels):
    res = _result(cluster_of)
    labels = np.asarray(labels)
    got = t_dedup.dedup_metrics(res, labels)
    want = ref_dedup.dedup_metrics(res, labels)
    assert got == want
    assert all(type(got[k]) is int for k in ("tp", "fp", "fn", "kept",
                                             "total"))


# -- host LSH bookkeeping ---------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_candidate_pairs_match_reference(seed):
    rng = np.random.default_rng(seed)
    bands = rng.integers(0, 6, (40, 5)).astype(np.uint64)
    bands[:, 2] = np.uint64(2**64 - 1)          # one band: all collide
    assert t_lsh.candidate_pairs(bands) == ref_lsh.candidate_pairs(bands)
    assert t_lsh.candidate_pairs(bands[:1]) == set()


@pytest.mark.parametrize("seed", range(4))
def test_union_find_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = 50
    ours, ref = t_lsh.UnionFind(n), ref_lsh.UnionFind(n)
    for i, j in rng.integers(0, n, (30, 2)).tolist():
        ours.union(i, j)
        ref.union(i, j)
    assert ours.clusters() == ref.clusters()
    assert ours.parent == ref.parent
    # the root is the smallest index of each component
    for root, members in ours.clusters().items():
        assert root == min(members)


@pytest.mark.parametrize("j", [0.0, 0.1, 0.37, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("b,r", [(32, 4), (64, 4), (25, 4), (1, 1)])
def test_candidate_probability_matches_reference(j, b, r):
    assert t_lsh.candidate_probability(j, b, r) == \
        ref_lsh.candidate_probability(j, b, r)


# -- loader -------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2, 5])
def test_prefetch_iterator_matches_reference(depth):
    items = [{"x": np.arange(i)} for i in range(9)]
    got = list(t_loader.PrefetchIterator(iter(items), depth=depth,
                                         place=lambda d: d["x"].sum()))
    want = list(ref_loader.PrefetchIterator(iter(items), depth=depth,
                                            place=lambda d: d["x"].sum()))
    assert got == want == [int(d["x"].sum()) for d in items]
    assert list(t_loader.PrefetchIterator(iter([]))) == []


@pytest.mark.parametrize("batch,seq,seed", [(2, 16, 0), (3, 50, 1),
                                            (4, 128, 2)])
def test_deduped_token_batches_match_reference(batch, seq, seed):
    docs, labels = corpus_with_duplicates(40, vocab=3000, doc_len=64,
                                          dup_fraction=0.4, seed=seed)
    keep = np.arange(0, 40, 3)
    got = t_loader.deduped_token_batches(docs, keep, batch, seq, vocab=2000,
                                         seed=seed)
    want = ref_loader.deduped_token_batches(docs, keep, batch, seq,
                                            vocab=2000, seed=seed)
    for _ in range(12):                         # crosses an epoch boundary
        a, b = next(got), next(want)
        assert a.keys() == b.keys() == {"tokens"}
        assert a["tokens"].dtype == b["tokens"].dtype == np.int32
        assert np.array_equal(a["tokens"], b["tokens"])


def test_dedup_then_batches_through_prefetch_as_the_reference():
    """The pipeline's first stages end to end: dedup, pack the kept
    documents, prefetch; the same batches as the reference's."""
    docs, _ = corpus_with_duplicates(60, vocab=5000, doc_len=128,
                                     dup_fraction=0.4, seed=3)
    got, want = _both(docs, d=1 << 12, k=128, n_bands=32, rows_per_band=4)
    a = t_loader.PrefetchIterator(t_loader.deduped_token_batches(
        docs, got.keep, 4, 64, vocab=4000))
    b = ref_loader.PrefetchIterator(ref_loader.deduped_token_batches(
        docs, want.keep, 4, 64, vocab=4000))
    for _ in range(5):
        assert np.array_equal(next(a)["tokens"], next(b)["tokens"])


def test_dedup_example_on_the_cpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "dedup_pipeline_torch.py"),
         "--device", "cpu", "--docs", "200"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "pair precision = 1.000, recall = 1.000" in out.stdout, out.stdout
