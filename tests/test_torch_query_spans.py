"""The spans inside a query batch's legs, on a small in-process service
on the CPU: one shard, a table with spilled entries (bucket width 1) and
query rows that fall back to brute force.

Each leg nests where the layer map puts it, the fallback's spans appear
only in a batch with fallback rows and carry its padding, tracing off
records nothing and changes no answer, and under ``torch.profiler`` each
sampled span is one ``user_annotation`` of the profile."""

import collections
import gc
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.data.shingle import batch_shingles
from repro_torch.data.synthetic import corpus_with_duplicates
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.search import SearchConfig, SimilaritySearchService

D, K, NB, R = 1 << 12, 64, 16, 4
TOP_K = 5

# new span -> its parent
PARENT = {
    "query.sign.upload": "query.sign",
    "query.candidates": "store.query",
    "query.probe": "query.partial",
    "query.spill": "query.partial",
    "query.spill.copy_out": "query.spill",
    "query.score": "query.partial",
    "query.copy_out": "query.partial",
    "query.fallback": "store.query",
    "query.fallback.pad": "query.partial",
    "query.fallback.count": "query.partial",
    "query.fallback.sort": "query.partial",
    "query.fallback.copy_out": "query.partial",
}


@pytest.fixture(scope="module")
def plane():
    """(tracer, service, indexed query rows, rows with fresh ones)."""
    tracer = obs_trace.Tracer(max_finished=1 << 16)
    before = obs_trace.set_default(tracer)
    try:
        docs, _ = corpus_with_duplicates(192, vocab=3000, doc_len=64,
                                         dup_fraction=0.5, seed=0)
        fresh, _ = corpus_with_duplicates(11, vocab=3000, doc_len=64,
                                          seed=99)
        idx = batch_shingles(docs, n=3, d=D, max_nnz=64)
        mixed = np.concatenate([idx[:24], batch_shingles(fresh, n=3, d=D,
                                                         max_nnz=64)])
        svc = SimilaritySearchService(SearchConfig(
            device="cpu", d=D, k=K, n_bands=NB, rows_per_band=R,
            n_shards=1, bucket_width=1))
        tracer.sample_rate = 1.0      # ingest opens no query span
        svc.add_sparse(idx)
        assert tracer.drain() == []
        tracer.sample_rate = 0.0
        assert svc.store.n_spilled > 0
        yield tracer, svc, idx[:24], mixed
    finally:
        obs_trace.set_default(before)


def _traced(tracer, svc, rows):
    tracer.drain()
    tracer.sample_rate = 1.0
    try:
        out = svc.query_sparse(rows, top_k=TOP_K)
    finally:
        tracer.sample_rate = 0.0
    return out, tracer.drain()


def _tree(spans):
    """name -> [(span, its parent's name)]."""
    by_id = {s["span"]: s for s in spans}
    out = collections.defaultdict(list)
    for s in spans:
        parent = by_id.get(s["parent"])
        out[s["name"]].append((s, parent["name"] if parent else None))
    return out


def test_each_leg_nests_under_its_layer(plane):
    tracer, svc, _, mixed = plane
    _, spans = _traced(tracer, svc, mixed)
    n_fallback = svc.store.last_timings["n_fallback"]
    assert n_fallback > 0
    tree = _tree(spans)
    assert set(PARENT) <= set(tree)
    for name, parent in PARENT.items():
        assert [p for _, p in tree[name]] == [parent], name
    # the candidate round holds the first partial, the brute round the
    # second, and each round's legs sit under its own partial
    (cand, _), = tree["query.candidates"]
    (brute, _), = tree["query.fallback"]
    partials = {s["span"]: s for s, _ in tree["query.partial"]}
    by_id = {s["span"]: s for s in spans}
    for leg in ("query.probe", "query.spill", "query.score",
                "query.copy_out"):
        (s, _), = tree[leg]
        assert by_id[partials[s["parent"]]["parent"]] is cand, leg
    for leg in ("pad", "count", "sort", "copy_out"):
        (s, _), = tree[f"query.fallback.{leg}"]
        assert by_id[partials[s["parent"]]["parent"]] is brute, leg
    (pad, _), = tree["query.fallback.pad"]
    assert pad["tags"] == {"rows": n_fallback,
                           "padded": 1 << (n_fallback - 1).bit_length()}
    (spill, _), = tree["query.spill"]
    assert set(spill["tags"]) == {"hits"} and spill["tags"]["hits"] > 0
    (upload, _), = tree["query.sign.upload"]
    assert upload["tags"] == {"bytes": mixed.nbytes}


def test_no_fallback_span_without_fallback_rows(plane):
    tracer, svc, indexed, _ = plane
    _, spans = _traced(tracer, svc, indexed)
    assert svc.store.last_timings == {"n_fallback": 0}
    names = {s["name"] for s in spans}
    assert "query.candidates" in names and "query.probe" in names
    assert not any(n.startswith("query.fallback") for n in names)


def test_tracing_off_records_nothing_and_answers_alike(plane):
    tracer, svc, _, mixed = plane
    tracer.drain()
    off = svc.query_sparse(mixed, top_k=TOP_K)
    assert tracer.drain() == []
    on, spans = _traced(tracer, svc, mixed)
    assert spans
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_the_ring_holds_nothing_the_collector_tracks(plane):
    """A traced window keeps every span: the ring's records must not grow
    the collector's oldest generation, or its full collections stall the
    host the more often the more spans a batch opens."""
    tracer, svc, _, mixed = plane
    tracer.drain()
    tracer.sample_rate = 1.0
    try:
        svc.query_sparse(mixed, top_k=TOP_K)
    finally:
        tracer.sample_rate = 0.0
    gc.collect()
    assert tracer.finished
    assert not any(gc.is_tracked(r) for r in tracer.finished)
    assert any(s["tags"] for s in tracer.drain())


def test_child_span_is_never_a_root():
    tracer = obs_trace.Tracer(sample_rate=1.0)
    assert tracer.child("leg") is obs_trace.NULL_SPAN
    with tracer.span("root") as root:
        with tracer.child("leg") as leg:
            assert leg.sampled and leg.parent_id == root.span_id
    assert [s["name"] for s in tracer.drain()] == ["leg", "root"]


def test_a_leading_dot_names_a_leg_of_the_ambient_span():
    tracer = obs_trace.Tracer(sample_rate=1.0)
    assert tracer.child(".leg") is obs_trace.NULL_SPAN
    with tracer.span("root"):
        with tracer.child(".leg"):
            with tracer.child(".copy"):
                pass
    assert [s["name"] for s in tracer.drain()] == [
        "root.leg.copy", "root.leg", "root"]


def test_signing_outside_a_query_names_its_own_upload(plane):
    tracer, svc, indexed, _ = plane
    tracer.drain()
    tracer.sample_rate = 1.0
    try:
        with tracer.span("dedup.sign"):
            svc.engine.signatures_sparse(indexed)
    finally:
        tracer.sample_rate = 0.0
    assert [s["name"] for s in tracer.drain()] == ["dedup.sign.upload",
                                                   "dedup.sign"]


def test_each_sampled_span_is_one_profiler_range(plane, tmp_path):
    tracer, svc, _, mixed = plane
    path = tmp_path / "trace.json"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, spans = _traced(tracer, svc, mixed)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = collections.Counter(e["name"] for e in events
                                 if e.get("cat") == "user_annotation")
    assert ranges == collections.Counter(s["name"] for s in spans)


def test_no_profiler_range_outside_a_profile(plane, monkeypatch):
    tracer, svc, _, mixed = plane

    def refuse(name):
        raise AssertionError(f"a profiler range for {name} with no profile")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _, spans = _traced(tracer, svc, mixed)
    assert spans
