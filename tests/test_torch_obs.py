"""The port's observability plane against the JAX package's.

Every case of ``tests/test_obs.py`` runs on the port's ``obs``, and the
port's snapshots, merges, deltas, quantiles and dump lines are held equal
to the reference's on the same observations (tolerance 0: snapshots are
dicts of ints, and quantiles come from the same arithmetic).  Each
package's dump checker accepts the other's dump.  The trace case spawns
real tcp shard workers of the port on the CPU and checks that one
query's coordinator and worker spans share a trace id.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.obs import dump as ref_dump
from repro.obs import metrics as ref_metrics
from repro.obs import trace as ref_trace
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.dump import MetricsDumper, check_dump, main as dump_main

K, NB, R = 64, 16, 4
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _both(fn):
    """``fn(metrics_module)`` run on the port's and the reference's."""
    return fn(obs_metrics), fn(ref_metrics)


# -- histogram merge: exact, associative, commutative -------------------------

@settings(max_examples=30)
@given(st.data())
def test_hist_merge_exact_over_random_shard_splits(data):
    """Observing a stream into one histogram == splitting it across S
    'shard' histograms and merging the snapshots, in any order/grouping;
    and the port's snapshots and merges equal the reference's."""
    seed = data.draw(st.integers(0, 2**31 - 1), "seed")
    s = data.draw(st.integers(2, 5), "shards")
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 200))
    values = rng.uniform(0.0, 10.0, n) ** 3        # spans many buckets
    owner = rng.integers(0, s, n)
    perm = rng.permutation(s)
    cut = int(rng.integers(1, s))

    def run(m):
        whole = m.Histogram("h")
        parts = [m.Histogram("h") for _ in range(s)]
        for v, o in zip(values, owner):
            whole.observe(float(v))
            parts[int(o)].observe(float(v))
        snaps = [{"hists": {"h": p.to_snapshot()}} for p in parts]
        merged = m.merge_snapshots(*[snaps[i] for i in perm])
        left = m.merge_snapshots(*snaps[:cut])
        right = m.merge_snapshots(*snaps[cut:])
        return (whole.to_snapshot(), merged["hists"]["h"],
                m.merge_snapshots(left, right)["hists"]["h"])

    port, ref = _both(run)
    assert port == ref
    want, merged, grouped = port
    assert merged == want and grouped == want


def test_merge_counters_gauges_and_quantiles():
    def run(m):
        reg_a, reg_b = m.Registry(), m.Registry()
        reg_a.counter("c").inc(3)
        reg_b.counter("c").inc(4)
        reg_a.gauge("g").set(10)
        reg_b.gauge("g").set(5)
        for v in (0.001, 0.002, 0.004, 0.1):
            reg_a.histogram("h").observe(v)
        merged = m.merge_snapshots(reg_a.snapshot(), reg_b.snapshot())
        h = merged["hists"]["h"]
        return (merged, m.hist_quantile(h, 0.5), m.hist_quantile(h, 1.0),
                m.hist_sum(h))

    port, ref = _both(run)
    assert port == ref
    merged, p50, p100, total = port
    assert merged["counters"]["c"] == 7
    assert merged["gauges"]["g"] == 15          # gauges are summable levels
    assert merged["hists"]["h"]["count"] == 4
    assert p50 == pytest.approx(0.002, rel=0.3)
    assert p100 == pytest.approx(0.1, rel=0.3)
    assert total == pytest.approx(0.107, rel=1e-6)


def test_quantiles_interpolate_within_one_bucket():
    """With one log bucket holding all the mass, p50/p90/p99 spread
    monotonically inside it, the same numbers as the reference's."""
    def run(m):
        h = m.Histogram("h")
        h.observe_n(0.0015, 100)
        lo = m.Histogram("lo")
        lo.observe_n(0.0, 10)
        return ([h.quantile(q) for q in (0.0, 0.5, 0.9, 0.99)],
                m.hist_quantile(h.to_snapshot(), 0.9),
                [lo.quantile(q) for q in (0.5, 0.99)], h.mean)

    port, ref = _both(run)
    assert port == ref
    (p0, p50, p90, p99), snap_p90, (lo50, lo99), _ = port
    assert p50 < p90 < p99
    for p in (p50, p90, p99):
        assert p == pytest.approx(0.0015, rel=0.3)
    assert snap_p90 == pytest.approx(p90)
    assert 0.0 <= lo50 <= lo99
    assert p0 <= p50
    with pytest.raises(ValueError):
        obs_metrics._quantile_from_counts([1], 1, 1.5)


def test_snapshot_delta_scopes_a_window():
    def run(m):
        reg = m.Registry()
        reg.counter("c").inc(5)
        reg.histogram("h").observe(0.5)
        reg.gauge("g").set(2)
        before = reg.snapshot()
        reg.counter("c").inc(2)
        reg.histogram("h").observe(0.25)
        reg.histogram("new").observe(1e-3)
        return m.snapshot_delta(before, reg.snapshot())

    port, ref = _both(run)
    assert port == ref
    assert port["counters"] == {"c": 2}
    assert port["gauges"] == {"g": 2.0}
    assert port["hists"]["h"]["count"] == 1
    assert obs_metrics.hist_sum(port["hists"]["h"]) == \
        pytest.approx(0.25, rel=1e-9)


def test_label_snapshot_and_reset_match_reference():
    def run(m):
        reg = m.Registry()
        reg.counter("worker.bytes_in").inc(10)
        reg.gauge("worker.admission.depth").set(1)
        reg.histogram("worker.handle.query").observe(3e-3)
        snap = reg.snapshot()
        labelled = m.label_snapshot(snap, "shard1.replica0.")
        plane = m.merge_snapshots(snap, labelled)
        reg.reset()
        return labelled, plane, reg.snapshot(), m.empty_snapshot()

    port, ref = _both(run)
    assert port == ref
    labelled, plane, after_reset, empty = port
    assert set(labelled["counters"]) == {"shard1.replica0.worker.bytes_in"}
    assert plane["counters"]["worker.bytes_in"] == 10
    assert after_reset == empty


def test_set_default_swaps_the_process_registry():
    reg = obs_metrics.Registry()
    old = obs_metrics.set_default(reg)
    try:
        assert obs_metrics.default() is reg
    finally:
        assert obs_metrics.set_default(old) is reg
    assert obs_metrics.default() is old


# -- the disabled fast path ---------------------------------------------------

def test_disabled_registry_is_noop_and_cheap():
    reg = obs_metrics.Registry(enabled=False)
    c = reg.counter("a")
    assert c is reg.counter("b") is obs_metrics.NULL_COUNTER
    assert reg.histogram("a") is obs_metrics.NULL_HISTOGRAM
    assert reg.gauge("a") is obs_metrics.NULL_GAUGE
    c.inc(10**6)
    reg.histogram("a").observe(1.0)
    reg.gauge("a").set(5.0)
    assert reg.snapshot() == obs_metrics.empty_snapshot()
    assert obs_metrics.NULL_HISTOGRAM.to_snapshot() == \
        ref_metrics.NULL_HISTOGRAM.to_snapshot()

    n = 50_000
    h = reg.histogram("x")
    t0 = time.perf_counter()
    for _ in range(n):
        c.inc()
        h.observe_n(2.0, 3)
    per_op = (time.perf_counter() - t0) / (2 * n)
    assert per_op < 5e-6, f"null instrument op cost {per_op * 1e9:.0f}ns"


# -- traces -------------------------------------------------------------------

def test_tracer_ring_matches_reference_shape():
    """Span dicts carry the reference's keys; absorb/drain/for_trace and
    last_trace_id read a ring the same way, and a span opened under a
    wire-propagated ``TraceCtx`` joins that trace."""
    tr = obs_trace.Tracer(sample_rate=1.0, proc="coord")
    rtr = ref_trace.Tracer(sample_rate=1.0, proc="coord")
    with tr.span("root") as root:
        assert tr.current() == root.ctx()
        with tr.span("child"):
            pass
    with rtr.span("root"):
        pass
    port_span = tr.for_trace(root.trace_id)[0]
    assert set(port_span) == set(rtr.drain()[0])
    assert tr.last_trace_id() == root.trace_id
    worker = obs_trace.Tracer(proc="shard0")     # samples nothing itself
    assert worker.span("alone") is obs_trace.NULL_SPAN
    with worker.span("worker.query", parent=root.ctx()):
        pass
    tr.absorb_json(json.dumps(worker.drain()))
    spans = tr.for_trace(root.trace_id)
    assert {s["name"] for s in spans} == {"root", "child", "worker.query"}
    assert {s["parent"] for s in spans if s["proc"] == "shard0"} == \
        {root.span_id}
    assert len(tr.drain()) == 3 and tr.drain() == []
    old = obs_trace.set_default(tr)
    try:
        assert obs_trace.default() is tr and obs_trace.current() is None
    finally:
        obs_trace.set_default(old)


# -- dump files ---------------------------------------------------------------

def test_metrics_dumper_and_checker(tmp_path):
    path = str(tmp_path / "dump.jsonl")
    reg = obs_metrics.Registry()
    tr = obs_trace.Tracer(sample_rate=1.0, proc="t")
    with MetricsDumper(path, interval_s=0.05, registry=reg, tracer=tr):
        reg.counter("events").inc(3)
        reg.histogram("query.shard0.partial").observe(0.01)
        reg.histogram("query.shard1.partial").observe(0.02)
        with tr.span("op"):
            pass
        time.sleep(0.15)            # at least one periodic line
    out = check_dump(path, require_shard_hists=True)
    assert out["lines"] >= 2        # periodic + final
    assert out["spans"] == 1        # spans are incremental: exactly once
    assert out["shard_hists"] == ["query.shard0.partial",
                                  "query.shard1.partial"]
    # the reference's checker reads the port's dump the same way
    assert ref_dump.check_dump(path, require_shard_hists=True) == out
    assert dump_main(["--check", path, "--require-shard-hists"]) == 0


def test_port_checker_reads_the_reference_dump(tmp_path):
    path = str(tmp_path / "ref.jsonl")
    reg = ref_metrics.Registry()
    with ref_dump.MetricsDumper(path, interval_s=10.0, registry=reg,
                                tracer=ref_trace.Tracer()):
        reg.histogram("query.shard0.partial").observe(0.01)
        reg.histogram("query.shard2.partial").observe(0.01)
    assert check_dump(path, require_shard_hists=True) == \
        ref_dump.check_dump(path, require_shard_hists=True)


def test_dump_checker_rejects_garbage(tmp_path):
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"t": 1, "seq": 0}\n')
    with pytest.raises(ValueError, match="missing"):
        check_dump(str(bad))
    assert dump_main(["--check", str(bad)]) == 1
    empty_hists = tmp_path / "nohists.jsonl"
    empty_hists.write_text(json.dumps(
        {"t": 1, "seq": 0, "spans": [],
         "metrics": obs_metrics.empty_snapshot()}) + "\n")
    check_dump(str(empty_hists))
    with pytest.raises(ValueError, match="per-shard"):
        check_dump(str(empty_hists), require_shard_hists=True)
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    with pytest.raises(ValueError, match="empty"):
        check_dump(str(empty))


def test_dump_checker_overload_families(tmp_path):
    """``--require-overload`` passes only when the retry budget, a breaker
    and a shedding surface are all wired; worker snapshots folded in by
    an ``extra`` callable count."""
    reg = obs_metrics.Registry()
    reg.gauge("transport.retry_budget.tokens").set(100.0)
    reg.gauge("transport.breaker.127.0.0.1:9000.state").set(0.0)
    partial = tmp_path / "partial.jsonl"
    partial.write_text(json.dumps(
        {"t": 1, "seq": 0, "spans": [], "metrics": reg.snapshot()}) + "\n")
    with pytest.raises(ValueError, match="shed_surface"):
        check_dump(str(partial), require_overload=True)

    wreg = obs_metrics.Registry()
    wreg.gauge("shard0.replica1.worker.admission.depth").set(0.0)
    wreg.counter("shard0.replica1.worker.overloaded").inc()
    full = tmp_path / "full.jsonl"
    full.write_text(json.dumps(
        {"t": 1, "seq": 0, "spans": [], "metrics": reg.snapshot(),
         "workers": {"shard0.replica1": wreg.snapshot()}}) + "\n")
    out = check_dump(str(full), require_overload=True)
    assert set(out["overload_families"]) == {"retry_budget", "breaker",
                                             "shed_surface"}
    assert out == ref_dump.check_dump(str(full), require_overload=True)


# -- wire-propagated traces + STATS snapshots (real tcp workers) --------------

def test_trace_and_stats_roundtrip_through_tcp_workers():
    """One sampled query over a 2-shard tcp plane of port workers (on the
    CPU) yields one trace whose spans cover the coordinator and both
    worker processes; worker STATS carries a parseable registry snapshot,
    and obs_snapshot() folds the plane into one view with nonzero
    per-shard partial histograms."""
    from repro_torch.store import StoreConfig
    from repro_torch.transport import (connect_sharded, shutdown_plane,
                                       spawn_workers)

    rng = np.random.default_rng(3)
    sigs = rng.integers(0, 1 << 16, (80, K), dtype=np.int32)
    cfg = StoreConfig(k=K, n_bands=NB, rows_per_band=R)
    tracer = obs_trace.default()
    old_rate = tracer.sample_rate
    tracer.sample_rate = 1.0
    tracer.drain()                  # a clean ring for last_trace_id()
    handles = spawn_workers(cfg, 2, device="cpu")
    try:
        tcp = connect_sharded([h.address for h in handles], cfg, timeout=60,
                              device="cpu")
        tcp.add(sigs)
        before = obs_metrics.default().snapshot()
        ids, _ = tcp.query(sigs[:6], top_k=3)
        assert np.array_equal(ids[:, 0], np.arange(6))

        tid = tracer.last_trace_id()
        assert tid is not None
        spans = tracer.for_trace(tid)
        procs = {s["proc"] for s in spans}
        assert {"shard0", "shard1"} <= procs, procs
        assert any(s["proc"] not in ("shard0", "shard1") for s in spans)
        assert {s["name"] for s in spans} >= \
            {"query.fold", "query.broadcast", "query.partial", "query.merge",
             "worker.query"}
        by_id = {s["span"] for s in spans}
        for s in spans:
            if s["proc"].startswith("shard"):
                assert s["parent"] in by_id, "worker span not stitched"

        delta = obs_metrics.snapshot_delta(before,
                                           obs_metrics.default().snapshot())
        for i in range(2):
            assert delta["hists"][f"query.shard{i}.partial"]["count"] > 0

        for i, sh in enumerate(tcp.shards):
            st_ = sh.stats()
            assert st_["shard"] == i and st_["device"] == "cpu"
            snap = json.loads(st_["obs"])
            assert set(snap) == {"counters", "gauges", "hists"}
            assert snap["hists"]["worker.handle.query"]["count"] > 0
            assert snap["counters"]["worker.bytes_in"] > 0
            # the CPU worker ran the plain versions: no kernel launched
            assert set(json.loads(st_["launches"]).values()) == {0}
        plane = tcp.obs_snapshot()
        assert plane["hists"]["worker.handle.query"]["count"] >= 2
        assert plane["hists"]["shard1.replica0.worker.handle.query"][
            "count"] >= 1
        assert shutdown_plane(tcp, handles)
    finally:
        tracer.sample_rate = old_rate
        for h in handles:
            h.terminate()


def test_serve_cli_tcp_self_hit_and_metrics_dump(tmp_path):
    """The launcher's tcp plane on the CPU: 100% top-1 self-hit, and a
    metrics dump carrying per-shard partial histograms that both packages'
    checkers accept."""
    dump = str(tmp_path / "metrics.jsonl")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode",
         "search", "--transport", "tcp", "--shards", "3", "--docs", "400",
         "--device", "cpu", "--metrics-dump", dump],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "transport=tcp" in out.stdout
    assert "top-1 self-hit 100%" in out.stdout
    for checker in ("repro_torch.obs.dump", "repro.obs.dump"):
        chk = subprocess.run(
            [sys.executable, "-m", checker, "--check", dump,
             "--require-shard-hists", "--require-overload"], env=env,
            capture_output=True, text=True, timeout=120)
        assert chk.returncode == 0, chk.stderr
        assert "query.shard2.partial" in chk.stdout
