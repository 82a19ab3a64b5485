"""The port's tcp shard plane against the JAX package's, on the CPU.

A tcp-backed ``ShardedSketchStore`` of the port (shard worker processes on
localhost, ``device="cpu"``, the framed wire protocol) answers bit for bit
like the port's in-process plane, the JAX package's in-process and tcp
planes and a single reference store, for S in {1, 2, 4}, fallback rows
included (tolerance 0: ids are integers, scores count.float32 / k on both
sides).  The planes cross: a port coordinator serves over reference
workers and a reference coordinator over port workers, workers boot from
the other package's snapshots, and both packages' ``_handle`` answer the
same frames with the same bytes.  Then the cases of ``tests/test_transport.py``
(killed workers, poisoning, stale replies, hedging, deadlines, worker
errors) and the non-stream cases of ``tests/test_overload.py`` (retry
budget, breaker, fault plan, expired-deadline drop, admission gate) on the
port, and the seam to the card: one host copy of a batch's hashes and
words whatever S is, one upload of each a worker QUERY, no fold in a
worker, and workers that refuse to serve from the CPU when asked for a
card.

Spawning a worker costs a process importing torch (or jax), so the workers
most cases need are spawned together once, in a module fixture, and each
case takes fresh ones from it.
"""

import contextlib
import json
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ops as ref_ops
from repro.store import ShardedSketchStore as RefSharded
from repro.store import SketchStore as RefStore
from repro.store import StoreConfig as RefStoreConfig
from repro.transport import connect_sharded as ref_connect_sharded
from repro.transport import faults as ref_faults
from repro.transport import server as ref_server
from repro.transport import shutdown_plane as ref_shutdown_plane
from repro.transport import spawn_workers as ref_spawn_workers
from repro.transport import wire as ref_wire
from repro_torch.kernels.query_fused import BandHashes, QueryWords
from repro_torch.store import ShardedSketchStore, SketchStore, StoreConfig
from repro_torch.transport import (CircuitBreaker, DeadlineExceeded,
                                   FaultEvent, FaultPlan, HedgePolicy,
                                   Overloaded, RetryBudget, ShardConnection,
                                   TransportError, WorkerError,
                                   connect_sharded, deadline_scope,
                                   read_fired_log, shutdown_plane,
                                   spawn_workers)
from repro_torch.transport import faults as t_faults
from repro_torch.transport import server as t_server
from repro_torch.transport import wire
from repro_torch.transport.client import FanoutGroup, RemoteShard
from repro_torch.transport.wire import (DEADLINE_FIELD, Message, MsgType,
                                        deadline_us, message_bytes,
                                        recv_message, send_message)

K, NB, R = 64, 16, 4
SHARD_COUNTS = [1, 2, 4]

# the port workers the cases take: (group, workers, slow_shards by index
# within the group)
PORT_GROUPS = [("s1", 1, None), ("s2", 2, None), ("s4", 4, None),
               ("ref_coordinator", 2, None), ("killed", 2, None),
               ("killed_mid_add", 2, None), ("failed_query", 1, None),
               ("hangup", 1, None), ("worker_error", 1, None),
               ("expired", 1, None),
               ("hedged", 2, {1: (0.8, 0.03)}),
               ("never_hedge", 2, {0: (1.0, 0.02)}),
               ("timeout", 1, {0: (1.0, 2.0)})]
REF_GROUPS = [("s1", 1), ("s2", 2), ("s4", 4), ("port_coordinator", 2)]


def _cfg(**kw) -> StoreConfig:
    return StoreConfig(k=K, n_bands=NB, rows_per_band=R, **kw)


def _ref_cfg(**kw) -> RefStoreConfig:
    return RefStoreConfig(k=K, n_bands=NB, rows_per_band=R, **kw)


class _Pools:
    """Workers spawned together, handed out by group, each to one case."""

    def __init__(self):
        self.port: dict[str, list] = {}
        self.ref: dict[str, list] = {}
        self.gate: list = []

    def all(self) -> list:
        return [h for hs in (*self.port.values(), *self.ref.values(),
                             self.gate) for h in hs]


def _spawn_port_pool() -> dict:
    shards, slow, names = [], {}, []
    for name, n, slow_g in PORT_GROUPS:
        for j in range(n):
            if slow_g and j in slow_g:
                slow[len(shards)] = slow_g[j]
            shards.append(j)
            names.append(name)
    handles = spawn_workers(_cfg(), len(shards), device="cpu",
                            shards=shards, slow_shards=slow)
    out: dict[str, list] = {}
    for name, h in zip(names, handles):
        out.setdefault(name, []).append(h)
    return out


def _spawn_ref_pool() -> dict:
    shards = [j for _, n in REF_GROUPS for j in range(n)]
    handles = ref_spawn_workers(_ref_cfg(), len(shards), shards=shards)
    out, i = {}, 0
    for name, n in REF_GROUPS:
        out[name] = handles[i: i + n]
        i += n
    return out


@pytest.fixture(scope="module")
def pools():
    p = _Pools()
    with ThreadPoolExecutor(3) as ex:
        futs = [ex.submit(_spawn_port_pool), ex.submit(_spawn_ref_pool),
                ex.submit(spawn_workers, _cfg(), 1, device="cpu",
                          gate_limit=0)]
        try:
            p.port, p.ref, p.gate = (f.result() for f in futs)
        except BaseException:
            for f in futs:
                if f.exception() is None:
                    res = f.result()
                    for h in (res if isinstance(res, list)
                              else [h for hs in res.values() for h in hs]):
                        h.terminate()
            raise
    yield p
    for h in p.all():
        h.terminate()


def _corpus(n=120, k=K, seed=0, dup_pairs=3):
    rng = np.random.default_rng(seed)
    sigs = rng.integers(0, 1 << 16, (n, k), dtype=np.int32)
    for t in range(dup_pairs):          # planted exact duplicates
        sigs[n - 1 - t] = sigs[t]
    return sigs


def _queries(sigs, n_strangers=2, seed=1):
    """Indexed rows + strangers that hit no bucket anywhere (the global
    brute-force fallback leg over the wire)."""
    rng = np.random.default_rng(seed)
    strangers = rng.integers(1 << 20, 1 << 24,
                             (n_strangers, sigs.shape[1]), dtype=np.int32)
    return np.concatenate([sigs[:10], strangers])


def _pack(sigs) -> np.ndarray:
    return np.asarray(ref_ops.pack_codes(jnp.asarray(sigs), 32))


def _equal(got, want) -> bool:
    return np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def _shutdown(store, handles, down=shutdown_plane):
    assert down(store, handles, join_timeout=15)
    for h in handles:
        assert not h.alive, f"worker {h.shard} survived graceful shutdown"


def _addresses(handles) -> list:
    return [h.address for h in handles]


# -- the planes, bit for bit --------------------------------------------------

@pytest.mark.parametrize("s", SHARD_COUNTS)
def test_tcp_plane_bit_identical(s, pools, tmp_path):
    """Port tcp == port inproc == reference inproc == reference tcp ==
    one reference store: ids, scores, fallback rows, sizes; and a snapshot
    the workers write reloads in process in either package."""
    sigs = _corpus(seed=s)
    q = _queries(sigs, seed=s + 1)
    single = RefStore(_ref_cfg())
    single.add(sigs)
    ref_in = RefSharded(_ref_cfg(), s)
    ref_in.add(sigs)
    port_in = ShardedSketchStore(_cfg(), s, device="cpu")
    port_in.add(sigs)
    ph, rh = pools.port[f"s{s}"], pools.ref[f"s{s}"]
    tcp = connect_sharded(_addresses(ph), _cfg(), timeout=60, device="cpu")
    ref_tcp = ref_connect_sharded(_addresses(rh), _ref_cfg(), timeout=60)
    assert np.array_equal(tcp.add(sigs), np.arange(len(sigs)))
    ref_tcp.add(sigs)
    for top_k in (1, 5):
        want = single.query(q, top_k=top_k)
        for plane in (ref_in, port_in, ref_tcp, tcp):
            got = plane.query(q, top_k=top_k)
            assert got[0].dtype == np.int64 and got[1].dtype == np.float32
            assert _equal(got, want), (type(plane), top_k)
    assert tcp.last_timings["n_fallback"] == 2
    assert set(tcp.last_timings) == {"fold_s", "broadcast_s", "partial_s",
                                     "merge_s", "n_fallback"}
    assert np.array_equal(tcp.shard_sizes(), port_in.shard_sizes())
    assert np.array_equal(tcp.shard_sizes(), ref_in.shard_sizes())
    assert tcp.n_spilled == port_in.n_spilled == ref_in.n_spilled
    for sh in tcp.shards:
        st_ = sh.stats()
        # workers resolve probe_impl="auto" against their own device
        assert (st_["probe_impl"], st_["query_impl"], st_["device"]) == \
            ("numpy", "auto", "cpu")
    snap = str(tmp_path / "plane")
    tcp.save(snap)
    want = single.query(q, top_k=4)
    assert _equal(ShardedSketchStore.load(snap, device="cpu").query(
        q, top_k=4), want)
    assert _equal(RefSharded.load(snap).query(q, top_k=4), want)
    _shutdown(tcp, ph)
    _shutdown(ref_tcp, rh, down=ref_shutdown_plane)


def test_port_coordinator_over_reference_workers(pools):
    """The port's coordinator over the JAX package's workers answers like
    both in-process planes; its trace stitches the reference workers'
    spans, and its plane snapshot merges their registries."""
    from repro_torch.obs import trace as obs_trace
    sigs = _corpus(seed=31)
    q = _queries(sigs, seed=32)
    rh = pools.ref["port_coordinator"]
    tcp = connect_sharded(_addresses(rh), _cfg(), timeout=60, device="cpu")
    tcp.add(sigs)
    port_in = ShardedSketchStore(_cfg(), 2, device="cpu")
    port_in.add(sigs)
    ref_in = RefSharded(_ref_cfg(), 2)
    ref_in.add(sigs)
    tracer = obs_trace.default()
    old_rate, tracer.sample_rate = tracer.sample_rate, 1.0
    tracer.drain()
    try:
        for top_k in (1, 5):
            want = port_in.query(q, top_k=top_k)
            assert _equal(want, ref_in.query(q, top_k=top_k))
            assert _equal(tcp.query(q, top_k=top_k), want)
        spans = tracer.for_trace(tracer.last_trace_id())
        assert {"shard0", "shard1"} <= {s["proc"] for s in spans}
    finally:
        tracer.sample_rate = old_rate
    plane = tcp.obs_snapshot()
    assert plane["hists"]["shard1.replica0.worker.handle.query"]["count"] \
        >= 2
    _shutdown(tcp, rh)


def test_reference_coordinator_over_port_workers(pools):
    """The JAX package's coordinator over the port's workers answers like
    both in-process planes, on the raw and the packed path."""
    sigs = _corpus(seed=41)
    q = _queries(sigs, seed=42)
    ph = pools.port["ref_coordinator"]
    ref_tcp = ref_connect_sharded(_addresses(ph), _ref_cfg(), timeout=60)
    ref_tcp.add(sigs)
    ref_tcp.add_packed(_pack(_corpus(n=30, seed=43, dup_pairs=0)))
    port_in = ShardedSketchStore(_cfg(), 2, device="cpu")
    ref_in = RefSharded(_ref_cfg(), 2)
    for plane in (port_in, ref_in):
        plane.add(sigs)
        plane.add_packed(_pack(_corpus(n=30, seed=43, dup_pairs=0)))
    for top_k in (1, 5):
        got = ref_tcp.query(q, top_k=top_k)
        assert _equal(got, port_in.query(q, top_k=top_k))
        assert _equal(got, ref_in.query(q, top_k=top_k))
        got = ref_tcp.query_packed(_pack(q), top_k=top_k)
        assert _equal(got, port_in.query_packed(_pack(q), top_k=top_k))
    _shutdown(ref_tcp, ph, down=ref_shutdown_plane)


def test_tcp_packed_path_and_snapshot_boot(tmp_path):
    """Port workers boot from a snapshot the JAX package wrote, and the
    JAX package's workers from one the port wrote: both planes answer the
    packed path like one reference store, and the port's keeps ingesting
    with gids in arrival order.  Forgetting ``snapshot_dir`` is refused."""
    sigs = _corpus(seed=9)
    words, qw = _pack(sigs), _pack(_queries(sigs, seed=10))
    single = RefStore(_ref_cfg())
    single.add_packed(words)
    want = single.query_packed(qw, top_k=6)
    ref_in = RefSharded(_ref_cfg(), 2, partition="hash")
    ref_in.add_packed(words)
    ref_snap = str(tmp_path / "ref_plane")
    ref_in.save(ref_snap)
    port_in = ShardedSketchStore(_cfg(), 2, partition="hash", device="cpu")
    port_in.add_packed(words)
    port_snap = str(tmp_path / "port_plane")
    port_in.save(port_snap)

    with ThreadPoolExecutor(2) as ex:
        fp = ex.submit(spawn_workers, None, 2, device="cpu",
                       snapshot_dir=ref_snap)
        fr = ex.submit(ref_spawn_workers, None, 2, snapshot_dir=port_snap)
        handles = []
        with contextlib.ExitStack() as stack:
            stack.callback(lambda: [h.terminate() for h in handles])
            ph = fp.result()
            handles += ph
            rh = fr.result()
            handles += rh
            with pytest.raises(WorkerError, match="gid map"):
                connect_sharded(_addresses(ph), _cfg(), timeout=60,
                                device="cpu")
            tcp = connect_sharded(_addresses(ph), snapshot_dir=ref_snap,
                                  timeout=60, device="cpu")
            assert tcp.n_items == ref_in.n_items
            assert tcp.partition == "hash"
            assert _equal(tcp.query_packed(qw, top_k=6), want)
            ref_tcp = ref_connect_sharded(_addresses(rh),
                                          snapshot_dir=port_snap, timeout=60)
            assert _equal(ref_tcp.query_packed(qw, top_k=6), want)
            more = _pack(_corpus(n=30, seed=11, dup_pairs=0))
            assert np.array_equal(tcp.add_packed(more),
                                  np.arange(len(sigs), len(sigs) + 30))
            single.add_packed(more)
            port_in.add_packed(more)
            want2 = single.query_packed(qw, top_k=6)
            assert _equal(tcp.query_packed(qw, top_k=6), want2)
            assert _equal(port_in.query_packed(qw, top_k=6), want2)
            _shutdown(tcp, ph)
            _shutdown(ref_tcp, rh, down=ref_shutdown_plane)


@pytest.mark.parametrize("mode,bw", [("sig", 8), ("sig", 1), ("packed", 8),
                                     ("packed", 1)])
def test_handle_replies_byte_identical_to_reference(mode, bw):
    """Given equal stores and the same ADD, QUERY and BRUTE frames, the
    port's ``_handle`` and the reference's reply with the same bytes
    (bw = 1 with no rebuild keeps spilled keys, so QUERY runs the spill
    leg too)."""
    from repro.core.lsh import band_hashes, band_hashes_packed
    sigs = _corpus(n=150, seed=bw)
    port = SketchStore(_cfg(bucket_width=bw, auto_rebuild=False), device="cpu")
    ref = RefStore(_ref_cfg(bucket_width=bw, auto_rebuild=False))
    add = {"rows": sigs} if mode == "sig" else {"words": _pack(sigs)}
    q = _queries(sigs, n_strangers=3, seed=bw + 7)
    qwords = _pack(q)
    hashes = band_hashes(q, NB, R) if mode == "sig" \
        else band_hashes_packed(qwords, NB)
    lo, hi = wire.split_u64(hashes)
    frames = [(MsgType.ADD, add),
              (MsgType.QUERY, {"hash_lo": lo, "hash_hi": hi,
                               "qwords": qwords, "top_k": 5, "mode": mode}),
              (MsgType.BRUTE, {"qwords": qwords[-3:], "top_k": 4}),
              (MsgType.DIGEST, {})]
    for mtype, fields in frames:
        got, keep = t_server._handle(port, Message(mtype, dict(fields)))
        want, rkeep = ref_server._handle(
            ref, ref_wire.Message(ref_wire.MsgType(int(mtype)),
                                  dict(fields)))
        assert keep and rkeep
        assert message_bytes(got) == ref_wire.message_bytes(want), mtype
    assert port.n_spilled == ref.n_spilled and (port.n_spilled > 0) == \
        (bw == 1)
    got, _ = t_server._handle(port, Message(MsgType.STATS, {}))
    want, _ = ref_server._handle(ref, ref_wire.Message(
        ref_wire.MsgType.STATS, {}))
    assert set(want.fields) <= set(got.fields)
    assert got["size"] == want["size"] and got["n_spilled"] == \
        want["n_spilled"]


# -- the seam to the card -----------------------------------------------------

@pytest.mark.parametrize("bw", [8, 1])
def test_worker_uploads_each_query_operand_once(monkeypatch, bw):
    """A worker QUERY uploads the hashes once and the words once, launches
    no fold and probes with kernel 3's wrapper from the uploaded hashes;
    the spill leg (bw = 1) reads the wire's host hashes, with no copy
    back.  BRUTE uploads the fallback rows' words once."""
    from repro_torch.kernels import dispatch as t_dispatch
    from repro_torch.kernels import lsh_probe as t_probe
    from repro_torch.kernels import query_fused as t_qf
    from repro_torch.store import planner as t_planner
    from repro.core.lsh import band_hashes
    calls = {"hashes": 0, "words": 0, "probe": 0}

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    def refuse(*a, **kw):
        raise AssertionError("a worker folded or copied hashes back")
    store = SketchStore(_cfg(bucket_width=bw, auto_rebuild=False), device="cpu")
    sigs = _corpus(n=150, seed=bw)
    store.add(sigs)
    q = _queries(sigs, seed=3)
    lo, hi = wire.split_u64(band_hashes(q, NB, R))
    monkeypatch.setattr(t_server, "hashes_to_device",
                        count("hashes", t_server.hashes_to_device))
    monkeypatch.setattr(t_server, "u32_to_device",
                        count("words", t_server.u32_to_device))
    monkeypatch.setattr(t_probe, "lsh_probe_hashes_kernel",
                        count("probe", t_probe.lsh_probe_hashes_kernel))
    for name in ("fold_rows_kernel", "fold_probe_kernel", "hashes_to_host"):
        monkeypatch.setattr(t_qf, name, refuse)
    monkeypatch.setattr(t_dispatch, "fold_hashes", refuse)
    reply, _ = t_server._handle(store, Message(MsgType.QUERY, {
        "hash_lo": lo, "hash_hi": hi, "qwords": _pack(q), "top_k": 5,
        "mode": "sig"}))
    assert calls == {"hashes": 1, "words": 1, "probe": 1}
    assert (store.n_spilled > 0) == (bw == 1)
    want = RefStore(_ref_cfg(bucket_width=bw, auto_rebuild=False))
    want.add(sigs)
    part = want.partial_topk_packed_hashed(band_hashes(q, NB, R), _pack(q),
                                           5, mode="sig")
    assert np.array_equal(reply["ids"], part.ids)
    assert np.array_equal(reply["scores"], part.scores)
    assert np.array_equal(reply["has"], part.has_candidates)
    uploads = []
    to_device = t_planner.as_device_words

    def counted(w, dev):
        if isinstance(w, np.ndarray):          # a host -> device copy
            uploads.append(w.shape)
        return to_device(w, dev)
    monkeypatch.setattr(t_planner, "as_device_words", counted)
    t_server._handle(store, Message(MsgType.BRUTE, {
        "qwords": _pack(q[-2:]), "top_k": 3}))
    assert uploads == [(2, K)]


def test_tcp_service_copies_hashes_and_words_once_where_they_lie(
        monkeypatch):
    """``SimilaritySearchService(transport="tcp")`` at S = 3 answers like
    the JAX service with ``transport="tcp"`` (fallback rows included), and
    a query batch's hashes and words come to the host once each, shared
    by the three remote shards and the fallback leg."""
    from repro.data.shingle import batch_shingles
    from repro.data.synthetic import corpus_with_duplicates
    from repro.serve.search import SearchConfig as RefSearchConfig
    from repro.serve.search import SimilaritySearchService as RefService
    from repro_torch import convert
    from repro_torch.kernels import query_fused as t_qf
    from repro_torch.serve.search import (SearchConfig,
                                          SimilaritySearchService)
    docs, _ = corpus_with_duplicates(96, vocab=3000, doc_len=64,
                                     dup_fraction=0.5, seed=5)
    idx = batch_shingles(docs, n=3, d=1 << 12, max_nnz=64)
    fresh = np.sort(np.random.default_rng(5).integers(0, 1 << 12, (4, 64),
                                                      np.int32), axis=1)
    qidx = np.concatenate([idx[:12], fresh])
    common = dict(d=1 << 12, k=K, n_bands=NB, rows_per_band=R, n_shards=3,
                  transport="tcp", query_timeout_s=60.0)
    with ThreadPoolExecutor(1) as ex:
        fref = ex.submit(RefService, RefSearchConfig(**common))
        ref = None
        try:
            ref = fref.result()
            port = SimilaritySearchService(
                SearchConfig(device="cpu", **common),
                params=convert.permutations_from_jax(
                    np.asarray(ref.engine.sigma), np.asarray(ref.engine.pi),
                    "cpu"))
        except BaseException:
            if ref is not None:
                ref.close()
            raise
    with ref, port:
        assert len(port._workers) == 3
        for svc in (ref, port):
            with svc.pipeline(depth=2) as pipe:
                for lo in range(0, len(idx), 32):
                    pipe.submit(idx[lo: lo + 32])
        copies = {"hashes": 0, "words": 0}

        def count(key, fn):
            def wrapped(*a):
                copies[key] += 1
                return fn(*a)
            return wrapped
        monkeypatch.setattr(t_qf, "hashes_to_host",
                            count("hashes", t_qf.hashes_to_host))
        monkeypatch.setattr(t_qf, "u32_to_host",
                            count("words", t_qf.u32_to_host))
        for _ in range(2):
            got = port.query_sparse(qidx, top_k=5)
            assert _equal(got, ref.query_sparse(qidx, top_k=5))
        assert port.store.last_timings["n_fallback"] > 0
        assert (got[0][:12, 0] == np.arange(12)).all()
        assert copies == {"hashes": 2, "words": 2}
        assert np.array_equal(port.store.shard_sizes(),
                              ref.store.shard_sizes())
    assert not any(h.alive for h in port._workers or [])


def test_workers_refuse_cuda_without_a_card(monkeypatch):
    """A worker asked for the card where it sees none fails at boot and
    ``spawn_workers`` says so; nothing serves from the CPU unless asked."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="failed at boot.*device='cpu'"):
        spawn_workers(_cfg(), 1)
    assert time.monotonic() - t0 < 60


# -- failure semantics (tests/test_transport.py) -------------------------------

def test_killed_worker_raises_within_timeout(pools):
    sigs = _corpus(n=60, dup_pairs=0)
    handles = pools.port["killed"]
    tcp = connect_sharded(_addresses(handles), _cfg(), timeout=5,
                          device="cpu")
    tcp.add(sigs)
    tcp.query(sigs[:4], top_k=3)           # plane is healthy first
    handles[1].proc.kill()                 # SIGKILL: no goodbye frame
    handles[1].proc.join(10)
    t0 = time.monotonic()
    with pytest.raises(TransportError):
        tcp.query(sigs[:4], top_k=3)
    assert time.monotonic() - t0 < 30
    t0 = time.monotonic()
    with pytest.raises(TransportError):
        tcp.add(sigs)                      # blocking path fails too
    assert time.monotonic() - t0 < 30


def test_killed_worker_mid_add_poisons_plane(pools):
    """A worker killed under the ADD fan-out raises within the deadline and
    poisons the plane (the surviving shard may have indexed its slice)."""
    sigs = _corpus(n=60, dup_pairs=0)
    handles = pools.port["killed_mid_add"]
    tcp = connect_sharded(_addresses(handles), _cfg(), timeout=5,
                          device="cpu")
    tcp.add(sigs)
    handles[0].proc.kill()
    handles[0].proc.join(10)
    t0 = time.monotonic()
    with pytest.raises(TransportError):
        tcp.add(sigs)
    assert time.monotonic() - t0 < 30
    with pytest.raises(RuntimeError, match="inconsistent"):
        tcp.add(sigs)
    with pytest.raises(RuntimeError, match="inconsistent"):
        tcp.query(sigs[:4], top_k=3)


def test_failed_query_fanout_does_not_poison_writes(pools):
    sigs = _corpus(n=40, dup_pairs=0)
    handles = pools.port["failed_query"]
    tcp = connect_sharded(_addresses(handles), _cfg(), timeout=5,
                          device="cpu")
    tcp.add(sigs)
    handles[0].proc.kill()
    handles[0].proc.join(10)
    with pytest.raises(TransportError):
        tcp.query(sigs[:4], top_k=3)
    assert tcp._failed is None             # reads never poison


def test_stale_reply_discarded():
    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)

    def serve():
        conn, _ = lsock.accept()
        with conn:
            msg = recv_message(conn)
            send_message(conn, Message(MsgType.OK, {"n": 99}, seq=0xDEAD))
            send_message(conn, Message(MsgType.OK, {"n": 7}, seq=msg.seq))

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        c = ShardConnection(lsock.getsockname(), timeout=10)
        assert int(c.request(Message(MsgType.STATS, {}))["n"]) == 7
        assert c.n_stale == 1 and c.last_stale_seq == 0xDEAD
        c.close()
        t.join(10)
    finally:
        lsock.close()


def _fake_worker(handler):
    """A scripted tcp shard 'worker': ``handler(conn)`` for one accepted
    connection on a daemon thread.  Returns the listening socket."""
    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)

    def serve():
        conn, _ = lsock.accept()
        with conn:
            handler(conn)

    threading.Thread(target=serve, daemon=True).start()
    return lsock


def test_one_shard_error_does_not_brick_the_group():
    def ok_partial(conn, rounds=2):
        for _ in range(rounds):
            msg = recv_message(conn)
            q = msg["qwords"].shape[0]
            send_message(conn, Message(MsgType.PARTIAL, {
                "ids": np.full((q, 3), -1, np.int64),
                "scores": np.full((q, 3), -np.inf, np.float32),
                "has": np.zeros(q, bool)}, seq=msg.seq))

    def error_then_ok(conn):
        msg = recv_message(conn)
        send_message(conn, Message(MsgType.ERROR, {"error": "boom"},
                                   seq=msg.seq))
        ok_partial(conn, rounds=1)

    l0 = _fake_worker(error_then_ok)
    l1 = _fake_worker(lambda c: ok_partial(c, rounds=2))
    try:
        conns = [ShardConnection(l0.getsockname(), timeout=10),
                 ShardConnection(l1.getsockname(), timeout=10)]
        group = FanoutGroup(conns, timeout=10)
        shards = [RemoteShard(c, group) for c in conns]
        hashes = BandHashes(host=np.zeros((2, NB), np.uint64))
        qw = QueryWords(np.zeros((2, K), np.uint32))
        pend = [sh.start_query(hashes, qw, 3, "sig") for sh in shards]
        with pytest.raises(WorkerError, match="boom"):
            for p in pend:
                p.result()
        pend = [sh.start_query(hashes, qw, 3, "sig") for sh in shards]
        for p in pend:
            part = p.result()
            assert part.ids.shape == (2, 3) and p.latency_s is not None
        for c in conns:
            c.close()
    finally:
        l0.close()
        l1.close()


def test_midframe_timeout_poisons_connection():
    def half_reply(conn):
        msg = recv_message(conn)
        frame = message_bytes(Message(MsgType.OK, {"n": 1}, seq=msg.seq))
        conn.sendall(frame[: len(frame) - 4])      # cut mid-frame
        time.sleep(3)                              # past the client timeout

    lsock = _fake_worker(half_reply)
    try:
        c = ShardConnection(lsock.getsockname(), timeout=1)
        with pytest.raises(TransportError):
            c.request(Message(MsgType.STATS, {}))
        assert c.broken
        with pytest.raises(WorkerError, match="unusable"):
            c.request(Message(MsgType.STATS, {}))
    finally:
        lsock.close()


def test_worker_survives_client_hangup_mid_reply(pools):
    handles = pools.port["hangup"]
    rude = socket.create_connection(handles[0].address, timeout=30)
    send_message(rude, Message(
        MsgType.BRUTE,
        {"qwords": np.zeros((2000, K), np.uint32), "top_k": 50}, seq=1))
    rude.close()
    tcp = connect_sharded(_addresses(handles), _cfg(), timeout=60,
                          device="cpu")
    sigs = _corpus(n=30, dup_pairs=0)
    tcp.add(sigs)
    ids, _ = tcp.query(sigs[:3], top_k=2)
    assert np.array_equal(ids[:, 0], np.arange(3))
    assert handles[0].alive
    _shutdown(tcp, handles)


def test_hedged_reads_bit_identical_and_win(pools):
    """With one shard sleeping on most reads, hedged twin reads fire, win
    some races, and never change a bit of any answer."""
    sigs = _corpus(seed=21)
    q = _queries(sigs, seed=22)
    single = RefStore(_ref_cfg())
    single.add(sigs)
    want = single.query(q, top_k=5)
    handles = pools.port["hedged"]
    tcp = connect_sharded(_addresses(handles), _cfg(), timeout=60,
                          hedge=HedgePolicy(delay_s=0.005), device="cpu")
    tcp.add(sigs)
    for _ in range(15):
        assert _equal(tcp.query(q, top_k=5), want)
    g = tcp.shards[0].group
    assert g.n_hedges > 0, "slow shard never triggered a hedge"
    assert g.n_hedge_wins > 0, "no hedge ever beat a 30 ms stall"
    _shutdown(tcp, handles)


def test_hedge_delay_derives_from_peer_skew():
    """The adaptive delay for a shard comes from its peers' reply-skew
    histograms, never its own; a lone shard never hedges adaptively."""
    slow, fast1, fast2 = object(), object(), object()
    g = FanoutGroup([slow, fast1, fast2], hedge=HedgePolicy(),
                    hedge_conns={slow: object(), fast1: object(),
                                 fast2: object()})
    for _ in range(40):
        g._lat_h[fast1].observe(0.002)
        g._lat_h[fast2].observe(0.002)
        g._lat_h[slow].observe(0.5)
    g._msgs = {slow: object(), fast1: object()}
    d = g._hedge_delay(slow)
    assert d is not None and d < 0.05, d
    assert g._hedge_delay(fast1) is not None
    assert g._hedge_delay(fast2) is None
    lone = FanoutGroup([slow], hedge=HedgePolicy(),
                       hedge_conns={slow: object()})
    lone._msgs = {slow: object()}
    for _ in range(40):
        lone._lat_h[slow].observe(0.002)
    assert lone._hedge_delay(slow) is None


def test_writes_never_hedge(pools):
    sigs = _corpus(n=80, dup_pairs=0)
    handles = pools.port["never_hedge"]
    tcp = connect_sharded(_addresses(handles), _cfg(), timeout=60,
                          hedge=HedgePolicy(delay_s=0.0), device="cpu")
    g = tcp.shards[0].group
    tcp.add(sigs)
    tcp.add(_corpus(n=40, seed=5, dup_pairs=0))
    assert g.n_hedges == 0, "a write was hedged"
    tcp.query(sigs[:4], top_k=3)
    assert g.n_hedges > 0
    _shutdown(tcp, handles)


def test_query_timeout_error_names_the_knob(pools):
    sigs = _corpus(n=60, dup_pairs=0)
    handles = pools.port["timeout"]
    tcp = connect_sharded(_addresses(handles), _cfg(), timeout=0.5,
                          device="cpu")
    tcp.add(sigs)                          # writes are never slowed
    with pytest.raises(TransportError, match="query_timeout_s"):
        tcp.query(sigs[:2], top_k=3)


def test_worker_error_propagates_with_message(pools):
    handles = pools.port["worker_error"]
    tcp = connect_sharded(_addresses(handles), _cfg(), timeout=60,
                          device="cpu")
    with pytest.raises(WorkerError, match="expected"):
        tcp.add(np.zeros((2, K + 1), np.int32))     # wrong K
    assert tcp._failed is None             # provably clean: not poisoned
    sigs = _corpus(n=40, dup_pairs=0)
    tcp.add(sigs)
    ids, _ = tcp.query(sigs[:3], top_k=2)
    assert np.array_equal(ids[:, 0], np.arange(3))
    _shutdown(tcp, handles)


def test_shutdown_plane_is_safe_on_an_inproc_plane():
    plane = ShardedSketchStore(_cfg(), 2, device="cpu")
    assert shutdown_plane(plane, [])


# -- overload (the non-stream cases of tests/test_overload.py) ----------------

def test_retry_budget_caps_storm_unbudgeted_amplifies():
    b = RetryBudget(ratio=0.2, cap=5.0, floor_per_s=0.0)
    while b.try_spend():
        pass                            # drain the startup burst
    granted = 0
    for _ in range(100):
        b.note_primary()
        if b.try_spend():
            granted += 1
    assert 0 < granted <= 0.2 * 100 + 1
    u = RetryBudget(unlimited=True)
    ugranted = sum(u.try_spend() for _ in range(100))
    assert ugranted == 100
    assert ugranted >= 2 * granted
    assert b.n_denied == 100 - granted + 1


def test_retry_budget_floor_refills_a_quiet_plane():
    b = RetryBudget(ratio=0.0, cap=2.0, floor_per_s=50.0)
    while b.try_spend():
        pass
    assert not b.try_spend()
    time.sleep(0.05)                    # floor trickles ~2.5 tokens back
    assert b.try_spend()


def test_circuit_breaker_state_machine():
    br = CircuitBreaker(fail_threshold=3, reset_s=0.05)
    assert br.healthy and br.allow()
    br.record_failure()
    br.record_success()
    assert br.state == CircuitBreaker.CLOSED
    for _ in range(3):
        br.record_failure()
    assert br.state == CircuitBreaker.OPEN and not br.healthy
    assert not br.allow()
    time.sleep(0.06)
    assert br.allow()                   # half-open: a single probe
    assert not br.allow()
    br.record_failure()
    assert br.state == CircuitBreaker.OPEN
    time.sleep(0.06)
    assert br.allow()
    br.record_success()
    assert br.state == CircuitBreaker.CLOSED and br.healthy


def test_fault_plan_counts_per_type_and_fires_once(tmp_path):
    """The plan fires each event once on its per-type count, logs it, and
    encodes like the reference's, so one plan drives either package."""
    log = str(tmp_path / "fired.jsonl")
    plan = FaultPlan([FaultEvent("kill", 2, "add"),
                      FaultEvent("delay", 0, None, 5.0)],
                     lane="0.0", log_path=log)
    assert [e.kind for e in plan.on_message("query")] == ["delay"]
    assert plan.on_message("add") == []
    assert plan.on_message("add") == []
    assert [e.kind for e in plan.on_message("add")] == ["kill"]
    assert plan.on_message("add") == []
    recs = read_fired_log(log)
    assert [(r["kind"], r["on"]) for r in recs] == \
        [("delay", "query"), ("kill", "add")]
    assert recs == ref_faults.read_fired_log(log)
    again = FaultPlan.decode(plan.encode())
    assert again.encode() == plan.encode()
    assert ref_faults.FaultPlan.decode(plan.encode()).encode() == \
        plan.encode()
    a = FaultPlan.from_seed(7, n_events=3, horizon=10)
    assert a.encode() == FaultPlan.from_seed(7, n_events=3,
                                             horizon=10).encode()
    assert a.encode() == ref_faults.FaultPlan.from_seed(
        7, n_events=3, horizon=10).encode()
    assert (t_faults.FAULTS_ENV, t_faults.FAULT_LOG_ENV,
            t_faults.KILL_EXIT_CODE) == (ref_faults.FAULTS_ENV,
                                         ref_faults.FAULT_LOG_ENV,
                                         ref_faults.KILL_EXIT_CODE)
    assert t_faults.faults_env_value({"0.0": plan}) == \
        ref_faults.faults_env_value({"0.0": plan.encode()})
    t_faults.install_client_plan(FaultPlan([FaultEvent("delay", 0, "stats",
                                                       1.0)]))
    try:
        assert [e.kind for e in t_faults.client_events("stats")] == ["delay"]
    finally:
        t_faults.install_client_plan(None)
    assert t_faults.client_events("stats") == []


def test_worker_drops_expired_answers_near_deadline_exactly(pools):
    """An expired-on-arrival request is dropped before any scoring; one
    with a live deadline answers bit-identically to the reference."""
    sigs = _corpus(n=80, dup_pairs=0)
    ref = RefStore(_ref_cfg())
    ref.add(sigs)
    handles = pools.port["expired"]
    store = connect_sharded(_addresses(handles), _cfg(), timeout=30,
                            device="cpu")
    store.add(sigs)
    conn = store.shards[0].conn
    expired = Message(MsgType.BRUTE, {
        "qwords": np.zeros((1, K), np.uint32), "top_k": 3,
        DEADLINE_FIELD: deadline_us(time.time() - 5.0)})
    with pytest.raises(DeadlineExceeded):
        conn.request(expired)
    stats = dict(conn.request(Message(MsgType.STATS, {})).fields)
    assert int(stats["n_expired"]) == 1
    obs = json.loads(stats["obs"])
    assert obs["hists"].get("worker.handle.brute", {}).get("count", 0) == 0
    with deadline_scope(time.time() + 30.0):
        got = store.query(sigs[:8], top_k=5)
    assert _equal(got, ref.query(sigs[:8], top_k=5))
    stats = dict(conn.request(Message(MsgType.STATS, {})).fields)
    assert int(stats["n_expired"]) == 1
    shutdown_plane(store, handles, join_timeout=15)


def test_worker_admission_gate_sheds_clean_and_retryable(pools):
    """gate_limit=0 sheds every read with a clean, retryable OVERLOADED;
    writes are not gated and the lane stays intact after shedding."""
    sigs = _corpus(n=80, dup_pairs=0)
    handles = pools.gate
    store = connect_sharded(_addresses(handles), _cfg(), timeout=30,
                            device="cpu")
    store.add(sigs)
    with pytest.raises(Overloaded) as ei:
        store.query(sigs[:4], top_k=3)
    assert ei.value.retryable
    assert ei.value.retry_after_s >= 0
    conn = ShardConnection(handles[0].address, timeout=30, shard=0,
                           replica=0)
    stats = dict(conn.request(Message(MsgType.STATS, {})).fields)
    assert int(stats["gate_limit"]) == 0
    assert int(stats["n_overloaded"]) >= 1
    assert int(stats["size"]) == len(sigs)
    store.add(_corpus(n=10, seed=3))
    conn.close()
    shutdown_plane(store, handles, join_timeout=15)
