"""The port's streaming front end against the JAX service, on the CPU.

A query answered through the port's ``StreamingQueryService`` must equal,
bit for bit, the JAX package's ``SimilaritySearchService`` answering the
same row under the same two permutations (``convert.permutations_from_
jax``): whatever batch it was coalesced into, at any pipeline depth and
shard count, with mixed per-query top_k, for rows that take the
brute-force fallback, for dense rows and for the raw-signature path (b =
2).  Rows are independent on both sides, so the reference answers each
row inside one batch.  The cases mirror ``tests/test_stream.py`` (the
admission rules: a full batch flushes at once, a lone query at its
deadline, an incompatible arrival flushes the prefix, close answers
everything admitted, a failed batch rejects only its own tickets) and the
stream cases of ``tests/test_overload.py`` (shedding, expired tickets,
retries within the budget and the deadline).  Over tcp: one slowed,
hedged shard; and the replicated plane (S = 2, R = 2) with shard 1's
primary killed by a ``FaultPlan`` mid-stream.
"""

import threading
import time
import types

import numpy as np
import pytest

from repro.serve.search import SearchConfig as RefSearchConfig
from repro.serve.search import SimilaritySearchService as RefService
from repro_torch import convert
from repro_torch.obs import metrics as obs_metrics
from repro_torch.replica import (IngestJournal, connect_replicated,
                                 spawn_replicated)
from repro_torch.serve.search import SearchConfig, SimilaritySearchService
from repro_torch.serve.stream import StreamConfig, StreamingQueryService
from repro_torch.store import StoreConfig
from repro_torch.transport import (DeadlineExceeded, FaultEvent, FaultPlan,
                                   HedgePolicy, Overloaded, RetryBudget,
                                   connect_sharded, spawn_workers)

D, K, NB, R = 1 << 13, 64, 16, 4
NNZ = 32


def _docs(n, seed=0, lo=0, hi=D):
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(lo, hi, (n, NNZ), np.int32), axis=1)


def _pair(n_shards=2, **kw):
    """The JAX service and the port's, with the same permutations."""
    common = dict(d=D, k=K, n_bands=NB, rows_per_band=R, n_shards=n_shards,
                  **kw)
    ref = RefService(RefSearchConfig(**common))
    params = convert.permutations_from_jax(np.asarray(ref.engine.sigma),
                                           np.asarray(ref.engine.pi), "cpu")
    return ref, SimilaritySearchService(SearchConfig(device="cpu", **common),
                                        params=params)


class _Want:
    """The reference's answer for row i of ``q`` at each top_k asked."""

    def __init__(self, ref, q, layout="sparse"):
        self._fn = ref.query_sparse if layout == "sparse" else ref.query_dense
        self._q = q
        self._got: dict = {}

    def __call__(self, i: int, top_k: int):
        if top_k not in self._got:
            ids, scores = self._fn(self._q, top_k=top_k)
            self._got[top_k] = (np.asarray(ids), np.asarray(scores))
        ids, scores = self._got[top_k]
        return ids[i], scores[i]


def _check(results, want, top_k) -> None:
    for i, (ids, scores) in enumerate(results):
        k = top_k(i) if callable(top_k) else top_k
        want_ids, want_scores = want(i, k)
        assert ids.shape == (k,) and ids.dtype == np.int64
        assert scores.dtype == np.float32
        assert np.array_equal(ids, want_ids), f"ids diverge at query {i}"
        assert np.array_equal(scores, want_scores), f"scores at query {i}"


@pytest.fixture(scope="module")
def plane():
    """256 indexed docs in both services + queries mixing indexed rows
    with novel rows (over a tiny corpus, novel rows take the fallback)."""
    ref, svc = _pair()
    docs = _docs(256, seed=3)
    ref.add_sparse(docs)
    svc.add_sparse(docs)
    q = np.concatenate([docs[:12], _docs(4, seed=7)])
    svc.query_sparse(q, top_k=5)
    assert svc.store.last_timings["n_fallback"] > 0     # novel rows
    yield svc, q, _Want(ref, q)
    svc.close()


def test_coalesced_equals_reference(plane):
    """Every ticket equals the reference's row, across mixed top_k and
    fallback rows, whatever the batch composition."""
    svc, q, want = plane
    with svc.stream(max_batch=8, max_delay_ms=5.0) as st:
        tickets = [st.submit_sparse(q[i], top_k=(3 if i % 2 else 7))
                   for i in range(len(q))]
        results = [t.result(timeout=60) for t in tickets]
    _check(results, want, lambda i: 3 if i % 2 else 7)
    assert st.n_batches >= 2


@pytest.mark.parametrize("s", [1, 2, 4])
def test_shard_counts_never_change_answers(s):
    ref, svc = _pair(n_shards=s)
    try:
        docs = _docs(128, seed=s)
        ref.add_sparse(docs)
        svc.add_sparse(docs)
        q = np.concatenate([docs[:6], _docs(2, seed=s + 50)])
        with svc.stream(max_batch=4, max_delay_ms=2.0) as st:
            tickets = [st.submit_sparse(row, top_k=4) for row in q]
            results = [t.result(timeout=60) for t in tickets]
        _check(results, _Want(ref, q), 4)
    finally:
        svc.close()


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_depth_never_changes_answers(plane, depth):
    svc, q, want = plane
    with svc.stream(max_batch=4, max_delay_ms=1.0, depth=depth) as st:
        tickets = [st.submit_sparse(row, top_k=5) for row in q]
        results = [t.result(timeout=60) for t in tickets]
    _check(results, want, 5)


def test_full_batch_flushes_without_deadline(plane):
    """max_batch arrivals flush at once, not at the (absurd) deadline."""
    svc, q, want = plane
    reg = obs_metrics.default()
    full0 = reg.counter("stream.flush.full").value
    t0 = time.perf_counter()
    with svc.stream(max_batch=8, max_delay_ms=60_000.0) as st:
        tickets = [st.submit_sparse(q[i]) for i in range(8)]
        results = [t.result(timeout=60) for t in tickets]
    assert time.perf_counter() - t0 < 30
    assert reg.counter("stream.flush.full").value == full0 + 1
    assert st.n_batches == 1
    _check(results, want, 10)


def test_lone_query_flushes_at_deadline(plane):
    """A single query is answered after max_delay_ms with no further
    arrivals."""
    svc, q, want = plane
    reg = obs_metrics.default()
    dl0 = reg.counter("stream.flush.deadline").value
    with svc.stream(max_batch=64, max_delay_ms=20.0) as st:
        t = st.submit_sparse(q[0], top_k=4)
        res = t.result(timeout=60)
    assert reg.counter("stream.flush.deadline").value == dl0 + 1
    assert t.latency_s >= 0.020
    _check([res], want, 4)


def test_incompatible_shape_flushes_prefix(plane):
    """A row of another nnz cannot stack with the queue in front of it:
    the prefix flushes, and both answer as the reference does."""
    svc, q, want = plane
    ref_fn = want._fn
    wide = np.sort(np.random.default_rng(9).integers(
        0, D, (NNZ * 2,), np.int32))
    reg = obs_metrics.default()
    sh0 = reg.counter("stream.flush.shape").value
    with svc.stream(max_batch=64, max_delay_ms=50.0) as st:
        a = st.submit_sparse(q[0], top_k=5)
        b = st.submit_sparse(wide, top_k=5)
        ra = a.result(timeout=60)
        rb = b.result(timeout=60)
    assert reg.counter("stream.flush.shape").value == sh0 + 1
    _check([ra], want, 5)
    w_ids, w_scores = ref_fn(wide[None], top_k=5)
    assert np.array_equal(rb[0], np.asarray(w_ids)[0])
    assert np.array_equal(rb[1], np.asarray(w_scores)[0])


def test_close_flushes_everything_and_rejects_late(plane):
    svc, q, want = plane
    st = svc.stream(max_batch=64, max_delay_ms=60_000.0)
    tickets = [st.submit_sparse(row, top_k=3) for row in q[:5]]
    st.close()                      # no deadline fired: close drains
    assert all(t.done for t in tickets)
    _check([t.result(timeout=0) for t in tickets], want, 3)
    with pytest.raises(RuntimeError, match="closed"):
        st.submit_sparse(q[0])
    st.close()                      # idempotent


def test_batch_failure_rejects_only_its_tickets():
    """Queries against an empty index fail with the service's error; the
    coalescer keeps serving afterwards."""
    ref, svc = _pair(n_shards=1)
    try:
        docs = _docs(64, seed=5)
        with svc.stream(max_batch=4, max_delay_ms=2.0) as st:
            bad = st.submit_sparse(docs[0], top_k=3)
            with pytest.raises(ValueError, match="empty"):
                bad.result(timeout=60)
            ref.add_sparse(docs)
            svc.add_sparse(docs)
            good = st.submit_sparse(docs[0], top_k=3)
            res = good.result(timeout=60)
        _check([res], _Want(ref, docs[:1]), 3)
    finally:
        svc.close()


def test_submit_rejects_batches(plane):
    svc, _, _ = plane
    with svc.stream() as st:
        with pytest.raises(ValueError, match="ONE query"):
            st.submit_sparse(_docs(2, seed=1))


def test_concurrent_submitters_every_ticket_answered(plane):
    """Eight threads submit at once into one stream, the interpreter
    switching threads every microsecond: every ticket is answered with the
    reference's row and ``stream.queries`` counts each once."""
    import sys
    svc, q, want = plane
    reg = obs_metrics.default()
    n0 = reg.counter("stream.queries").value
    got: dict = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with svc.stream(max_batch=8, max_delay_ms=1.0) as st:
            def submit(t):
                for j in range(len(q)):
                    i = (t + j) % len(q)
                    got[(t, j)] = (i, st.submit_sparse(q[i], top_k=5))
            threads = [threading.Thread(target=submit, args=(t,))
                       for t in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(60)
            assert not any(th.is_alive() for th in threads)
            results = [(i, t.result(timeout=60)) for i, t in got.values()]
    finally:
        sys.setswitchinterval(old)
    assert len(results) == 8 * len(q)
    for i, (ids, scores) in results:
        want_ids, want_scores = want(i, 5)
        assert np.array_equal(ids, want_ids)
        assert np.array_equal(scores, want_scores)
    assert reg.counter("stream.queries").value - n0 == 8 * len(q)


@pytest.mark.parametrize("kw,match", [
    (dict(max_batch=0), "max_batch"), (dict(max_delay_ms=-1), "max_delay"),
    (dict(depth=0), "depth"), (dict(retries=-1), "retries"),
    (dict(max_queue=-1), "max_queue"),
    (dict(query_timeout_s=-1), "query_timeout_s")])
def test_stream_config_refuses_bad_knobs(kw, match):
    with pytest.raises(ValueError, match=match):
        StreamConfig(**kw)


def test_dense_and_raw_streams_equal_reference():
    """Dense rows (``submit_dense`` against ``query_dense``) on the fused
    path, and sparse rows at b = 2, whose signatures the stream copies to
    the host for the store's host band fold."""
    docs = _docs(96, seed=21)
    q = np.concatenate([docs[:6], _docs(2, seed=22)])
    dense = np.zeros((len(q), D), np.int8)
    dense[np.repeat(np.arange(len(q)), NNZ), q.reshape(-1)] = 1
    ref, svc = _pair()
    ref_b2, svc_b2 = _pair(b=2)
    assert svc.packed_ingest and not svc_b2.packed_ingest
    try:
        for r, s in ((ref, svc), (ref_b2, svc_b2)):
            r.add_sparse(docs)
            s.add_sparse(docs)
        with svc.stream(max_batch=4, max_delay_ms=2.0) as st:
            tickets = [st.submit_dense(row, top_k=5) for row in dense]
            _check([t.result(timeout=60) for t in tickets],
                   _Want(ref, dense, "dense"), 5)
        with svc_b2.stream(max_batch=4, max_delay_ms=2.0) as st:
            tickets = [st.submit_sparse(row, top_k=5) for row in q]
            _check([t.result(timeout=60) for t in tickets],
                   _Want(ref_b2, q), 5)
    finally:
        svc.close()
        svc_b2.close()


def test_stream_over_tcp_with_hedged_slow_shard():
    """Port workers on the CPU, shard 1 sleeping on most reads, hedged
    twin connections: streamed answers equal the reference's and the
    hedges fire."""
    docs = _docs(200, seed=11)
    q = np.concatenate([docs[:8], _docs(3, seed=13)])
    ref, _ = _pair()
    ref.add_sparse(docs)
    want = _Want(ref, q)
    cfg = SearchConfig(d=D, k=K, n_bands=NB, rows_per_band=R, n_shards=2,
                       transport="tcp", device="cpu")
    store_cfg = StoreConfig(k=K, n_bands=NB, rows_per_band=R)
    workers = spawn_workers(store_cfg, 2, device="cpu",
                            slow_shards={1: (0.8, 0.02)})
    try:
        store = connect_sharded([h.address for h in workers], store_cfg,
                                timeout=60, hedge=HedgePolicy(delay_s=0.004),
                                device="cpu")
        svc = SimilaritySearchService(
            cfg, store=store, workers=workers,
            params=convert.permutations_from_jax(
                np.asarray(ref.engine.sigma), np.asarray(ref.engine.pi),
                "cpu"))
        svc.add_sparse(docs)
        with svc.stream(max_batch=4, max_delay_ms=2.0) as st:
            for _ in range(4):      # several rounds so hedges get chances
                tickets = [st.submit_sparse(row, top_k=5) for row in q]
                _check([t.result(timeout=120) for t in tickets], want, 5)
        assert store.shards[0].group.n_hedges > 0, "no hedge fired"
        svc.close()
        assert not any(h.alive for h in workers)
    finally:
        for h in workers:
            h.terminate()


def test_stream_over_replicated_plane_with_a_killed_lane(tmp_path):
    """S = 2 x R = 2 port workers on the CPU, shard 1's primary killed by
    its plan on its 3rd QUERY while tickets stream with
    ``StreamConfig(retries=2)``: every admitted ticket still answers as
    the reference does, and the lane is down."""
    docs = _docs(160, seed=31)
    q = np.concatenate([docs[:16], _docs(4, seed=32)])
    ref, _ = _pair()
    ref.add_sparse(docs)
    want = _Want(ref, q)
    store_cfg = StoreConfig(k=K, n_bands=NB, rows_per_band=R)
    grid = spawn_replicated(store_cfg, 2, 2, device="cpu", faults={
        (1, 0): FaultPlan([FaultEvent("kill", 2, "query")])})
    journal = IngestJournal(str(tmp_path / "ingest.journal"))
    svc = None
    try:
        store = connect_replicated(grid, store_cfg, journal=journal,
                                   timeout=60, device="cpu")
        svc = SimilaritySearchService(
            SearchConfig(d=D, k=K, n_bands=NB, rows_per_band=R, n_shards=2,
                         transport="tcp", n_replicas=2, device="cpu"),
            store=store, workers=[h for row in grid for h in row],
            params=convert.permutations_from_jax(
                np.asarray(ref.engine.sigma), np.asarray(ref.engine.pi),
                "cpu"))
        svc.add_sparse(docs)
        with svc.stream(max_batch=4, max_delay_ms=2.0, retries=2) as st:
            tickets = [st.submit_sparse(row, top_k=5) for row in q]
            _check([t.result(timeout=120) for t in tickets], want, 5)
        assert st.n_batches >= 3
        assert not grid[1][0].alive     # the kill landed mid-stream
    finally:
        if svc is not None:
            svc.close()
        for row in grid:
            for h in row:
                h.terminate()
        journal.close()


# -- overload: the stream cases of tests/test_overload.py -----------------------

class _FakeService:
    """Stand-in for the service: instant sign, pluggable query."""

    packed_ingest = False

    def __init__(self, query_fn):
        self.cfg = types.SimpleNamespace(query_impl="host")
        self.store = types.SimpleNamespace(shards=[])
        self._query_fn = query_fn

    def _sign(self, rows, layout):
        return rows

    def _query(self, signed, top_k):
        return self._query_fn(signed, top_k)


def _ok_answer(signed, top_k):
    n = len(np.asarray(signed))
    return (np.zeros((n, top_k), np.int64),
            np.zeros((n, top_k), np.float32))


def _attach_budget(svc, budget):
    svc.store = types.SimpleNamespace(shards=[types.SimpleNamespace(
        group=types.SimpleNamespace(budget=budget))])


def test_stream_sheds_newest_when_queue_full():
    release = threading.Event()

    def slow(signed, top_k):
        release.wait(5.0)
        return _ok_answer(signed, top_k)

    s = StreamingQueryService(_FakeService(slow), StreamConfig(
        max_batch=1, depth=1, max_delay_ms=0.0, max_queue=2))
    try:
        admitted, shed = [], None
        for _ in range(50):
            t = s.submit_dense(np.arange(4.0))
            if t.done:                  # came back already rejected
                shed = t
                break
            admitted.append(t)
        assert shed is not None, "bounded queue never shed"
        with pytest.raises(Overloaded) as ei:
            shed.result(0)
        assert ei.value.retryable and ei.value.retry_after_s > 0
        release.set()
        for t in admitted:
            ids, scores = t.result(30)
            assert ids.shape == (s.cfg.top_k,)
    finally:
        release.set()
        s.close()


def test_stream_drops_expired_ticket_before_dispatch():
    release = threading.Event()

    def slow(signed, top_k):
        release.wait(5.0)
        return _ok_answer(signed, top_k)

    s = StreamingQueryService(_FakeService(slow), StreamConfig(
        max_batch=1, depth=1, max_delay_ms=0.0))
    try:
        t1 = s.submit_dense(np.arange(4.0))              # occupies the pipe
        t2 = s.submit_dense(np.arange(4.0), query_timeout_s=0.05)
        time.sleep(0.15)                # t2's deadline passes while queued
        release.set()
        t1.result(30)
        with pytest.raises(DeadlineExceeded):
            t2.result(30)
    finally:
        release.set()
        s.close()


def test_stream_retries_overloaded_within_budget():
    calls = []

    def flaky(signed, top_k):
        calls.append(time.monotonic())
        if len(calls) < 3:
            raise Overloaded("worker shed it", retry_after_s=0.01)
        return _ok_answer(signed, top_k)

    svc = _FakeService(flaky)
    budget = RetryBudget()
    _attach_budget(svc, budget)
    s = StreamingQueryService(svc, StreamConfig(
        max_batch=1, retries=3, query_timeout_s=30.0))
    try:
        s.submit_dense(np.arange(4.0)).result(30)
        assert len(calls) == 3
        assert budget.n_spent == 2      # each retry spent one token
    finally:
        s.close()


def test_stream_never_retries_past_deadline():
    def always_shedding(signed, top_k):
        raise Overloaded("worker shed it", retry_after_s=5.0)

    svc = _FakeService(always_shedding)
    budget = RetryBudget()
    _attach_budget(svc, budget)
    s = StreamingQueryService(svc, StreamConfig(max_batch=1, retries=8))
    try:
        t = s.submit_dense(np.arange(4.0), query_timeout_s=0.3)
        t0 = time.monotonic()
        with pytest.raises(Overloaded):
            t.result(30)
        assert time.monotonic() - t0 < 2.0
        assert budget.n_spent == 0
    finally:
        s.close()


def test_stream_retry_exhausted_budget_stops_retrying():
    calls = []

    def always_failing(signed, top_k):
        calls.append(1)
        raise Overloaded("worker shed it", retry_after_s=0.0)

    svc = _FakeService(always_failing)
    budget = RetryBudget(ratio=0.0, cap=0.0, floor_per_s=0.0)  # always empty
    _attach_budget(svc, budget)
    s = StreamingQueryService(svc, StreamConfig(
        max_batch=1, retries=5, query_timeout_s=30.0))
    try:
        with pytest.raises(Overloaded):
            s.submit_dense(np.arange(4.0)).result(30)
        assert len(calls) == 1          # no budget -> primary only
        assert budget.n_denied >= 1
    finally:
        s.close()


def test_stream_demo_never_sleeps_a_negative_length(plane, monkeypatch,
                                                    capsys):
    """The launcher's open-loop demo reads the clock once a wait step: on
    a clock that moves 0.7 ms a read, the time left runs out between two
    reads, and a second read would hand ``sleep`` a negative length (the
    reference's loop, ``repro/launch/serve.py``, reads it twice)."""
    from repro_torch.launch import serve as launch
    svc, q, _ = plane
    clock = [0.0]

    def perf_counter():
        clock[0] += 0.0007
        return clock[0]

    def sleep(s):
        if s < 0:
            raise ValueError("sleep length must be non-negative")
        clock[0] += s

    monkeypatch.setattr(launch, "time", types.SimpleNamespace(
        perf_counter=perf_counter, sleep=sleep))
    args = types.SimpleNamespace(stream_queries=24, stream_qps=2000.0,
                                 max_batch=4, max_delay_ms=1.0,
                                 stream_depth=2, hedge=False)
    launch.stream_demo(svc, q, args)
    assert "[serve] stream: 24 queries" in capsys.readouterr().out
