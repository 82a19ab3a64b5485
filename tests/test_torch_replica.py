"""The port's replicated plane against the JAX package, on the CPU.

The cases of ``tests/test_replica.py`` on the port, with every answer held
against the reference's single ``repro.store.SketchStore`` (ids and scores
equal exactly: integers, and count.float32 / k on both sides):

  * in process: the write-ahead journal (the same bytes as the reference
    plane's journal on the same batches), snapshot + tail replay,
    ``snapshot_journal_seq``, ``compact``, and the rollback of a scatter
    that landed nowhere;
  * the chaos scenario with the port's CPU workers, S = 2 x R = 2: four
    ``FaultPlan`` kills (mid-ingest, mid-query, then both original
    survivors) and seeded query jitter, run twice on one
    ``REPRO_FAULT_SEED`` with identical fired logs; the supervisor
    (``device="cpu"``) restores R = 2 with no failed recovery, every
    respawned worker reports device ``cpu`` in its STATS, and the resynced
    replicas then carry their shards alone;
  * a shard with every replica down raises within its deadline;
  * snapshots and journals cross between packages both ways: a plane
    snapshot plus journal tail written by one package's
    ``ReplicatedSketchStore`` boots in the other's with ``replay_tail``,
    with equal answers and per-shard digests; and port workers boot from
    the reference plane's snapshot through ``connect_replicated``.
"""

import os
import time

import numpy as np
import pytest

from repro.replica import IngestJournal as RefJournal
from repro.replica import ReplicatedSketchStore as RefReplicated
from repro.store import SketchStore as RefStore
from repro.store import StoreConfig as RefStoreConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.replica import (IngestJournal, ReplicatedSketchStore,
                                 Supervisor, connect_replicated,
                                 snapshot_journal_seq, spawn_replicated)
from repro_torch.store import StoreConfig
from repro_torch.transport import (FAULT_LOG_ENV, FaultEvent, FaultPlan,
                                   WorkerError, read_fired_log,
                                   shutdown_plane)
from repro_torch.transport.wire import Message, MsgType

K, NB, RPB = 64, 16, 4
CFG = dict(k=K, n_bands=NB, rows_per_band=RPB, n_slots=256, bucket_width=8)


def _cfg() -> StoreConfig:
    return StoreConfig(**CFG)


def _ref_cfg() -> RefStoreConfig:
    return RefStoreConfig(**CFG)


def _corpus(n=180, k=K, seed=0, dup_pairs=3):
    rng = np.random.default_rng(seed)
    sigs = rng.integers(0, 1 << 16, (n, k), dtype=np.int32)
    for t in range(dup_pairs):
        sigs[n - 1 - t] = sigs[t]
    return sigs


def _queries(sigs, n_strangers=2, seed=1):
    """Indexed rows + strangers with no bucket hit anywhere (the global
    brute-force leg must survive failover too)."""
    rng = np.random.default_rng(seed)
    strangers = rng.integers(1 << 20, 1 << 24,
                             (n_strangers, sigs.shape[1]), dtype=np.int32)
    return np.concatenate([sigs[:10], strangers])


def _assert_parity(ref: RefStore, store, q, top_k=5):
    want_ids, want_scores = ref.query(q, top_k=top_k)
    got_ids, got_scores = store.query(q, top_k=top_k)
    np.testing.assert_array_equal(got_ids, np.asarray(want_ids))
    np.testing.assert_array_equal(got_scores, np.asarray(want_scores))


def _counter(name: str) -> int:
    return obs_metrics.default().counter(name).value


def _hist(name: str):
    return obs_metrics.default().histogram(name)


def _stop_plane(store, grid) -> None:
    if store is not None:
        handles = [l.handle for rs in store.shards for l in rs.lanes
                   if l.handle is not None]
        shutdown_plane(store, handles, join_timeout=15)
    for row in grid:
        for h in row:
            h.terminate()


# -- in process: the journal around the scatter ---------------------------------

def test_journal_write_ahead_and_reboot_replay(tmp_path):
    """Every accepted batch is journalled before it scatters (the same
    bytes as the reference plane's journal); a plane rebooted from
    snapshot + journal tail answers like the reference store, and
    ``compact`` empties the journal."""
    sigs = _corpus(n=120)
    batches = np.array_split(sigs, 4)
    journal = IngestJournal(str(tmp_path / "ingest.journal"))
    ref_journal = RefJournal(str(tmp_path / "ref.journal"))
    ref = RefStore(_ref_cfg())
    ref_plane = RefReplicated(_ref_cfg(), 2, journal=ref_journal)
    store = ReplicatedSketchStore(_cfg(), 2, journal=journal, device="cpu")
    for b in batches[:2]:
        ref.add(b)
        ref_plane.add(b)
        store.add(b)
    assert journal.last_seq == 1
    snap = str(tmp_path / "snap")
    store.save(snap)
    assert snapshot_journal_seq(snap) == 1
    for b in batches[2:]:
        ref.add(b)
        ref_plane.add(b)
        store.add(b)
    assert journal.last_seq == 3
    assert open(journal.path, "rb").read() == \
        open(ref_journal.path, "rb").read()
    store2 = ReplicatedSketchStore.load(snap, device="cpu")
    store2.journal = journal
    assert store2.n_items == len(batches[0]) + len(batches[1])
    assert store2.replay_tail() == 2
    assert store2.replay_tail() == 0           # nothing past the plane now
    assert store2.n_items == len(sigs)
    _assert_parity(ref, store2, _queries(sigs))
    snap2 = str(tmp_path / "snap2")
    assert store2.compact(snap2) == 4
    assert journal.records() == []
    assert snapshot_journal_seq(snap2) == 3
    assert snapshot_journal_seq(str(tmp_path)) == -1
    journal.close()
    ref_journal.close()


def test_scatter_failure_rolls_back_journal_record(tmp_path):
    """A scatter that provably lands nowhere leaves no record behind."""
    journal = IngestJournal(str(tmp_path / "ingest.journal"))
    store = ReplicatedSketchStore(_cfg(), 2, journal=journal, device="cpu")
    store.add(_corpus(n=20))
    assert journal.last_seq == 0
    with pytest.raises(Exception):
        store.add(np.zeros((3, K + 1), np.int32))    # bad width: clean fail
    assert store._failed is None                     # plane still usable
    assert journal.last_seq == 0                     # record rolled back
    store.add(_corpus(n=10, seed=3))
    assert journal.last_seq == 1
    assert [r.seq for r in journal.records()] == [0, 1]
    journal.close()


# -- the chaos scenario: the port's workers, plan-scheduled kills ----------------

def _chaos_plans(seed: int):
    """The reference's schedule: lane (0,1) dies on its 4th ADD, lane
    (1,0) (shard 1's primary) on its 3rd QUERY, lanes (0,0) and (1,1) on
    their 6th ADD; plus seed-derived delay jitter on lane (0,0)'s first
    queries."""
    jitter = FaultPlan.from_seed(seed, n_events=2, horizon=3,
                                 kinds=("delay",), msg_type="query",
                                 delay_ms=15.0).events
    return {
        (0, 0): FaultPlan([FaultEvent("kill", 5, "add")] + list(jitter)),
        (0, 1): FaultPlan([FaultEvent("kill", 3, "add")]),
        (1, 0): FaultPlan([FaultEvent("kill", 2, "query")]),
        (1, 1): FaultPlan([FaultEvent("kill", 5, "add")]),
    }


def _chaos_once(tmp_path, seed: int) -> list[dict]:
    """One full chaos scenario; returns the fired-event log."""
    os.makedirs(tmp_path, exist_ok=True)
    sigs = _corpus(n=180)
    batches = np.array_split(sigs, 6)
    q = _queries(sigs)
    ref = RefStore(_ref_cfg())
    log_path = str(tmp_path / "faults.jsonl")
    journal = IngestJournal(str(tmp_path / "ingest.journal"))
    os.environ[FAULT_LOG_ENV] = log_path
    try:
        grid = spawn_replicated(_cfg(), 2, 2, device="cpu",
                                faults=_chaos_plans(seed))
    finally:
        os.environ.pop(FAULT_LOG_ENV, None)
    originals = {id(h) for row in grid for h in row}
    fail0 = _counter("replica.recover_failures")
    failovers0 = _counter("replica.failovers")
    hists = ("replica.resync", "replica.respawn", "replica.replay")
    hists0 = {n: (_hist(n).count, _hist(n).sum) for n in hists}
    store = sup = None
    try:
        store = connect_replicated(grid, _cfg(), journal=journal, timeout=60,
                                   device="cpu")
        sup = Supervisor(store, device="cpu", heartbeat_timeout_s=10)
        for b in batches[:3]:
            ref.add(b)
            store.add(b)
        _assert_parity(ref, store, q)
        snap = store.obs_snapshot()
        assert [n for n in snap["hists"] if n.startswith("shard0.replica0.")]
        assert [n for n in snap["hists"] if n.startswith("shard1.replica1.")]
        assert snap["hists"]["worker.handle.query"]["count"] >= 2

        # batch 3 is lane (0,1)'s 4th ADD: killed mid-ingest, the write
        # lands on reduced redundancy and the plane stays consistent
        for b in batches[3:5]:
            ref.add(b)
            store.add(b)
        assert not store.shards[0].lanes[1].up
        assert store._failed is None
        _assert_parity(ref, store, q)

        # lane (1,0)'s 3rd QUERY kills shard 1's primary mid-query: the
        # read fails over to its sibling
        _assert_parity(ref, store, q)
        assert not store.shards[1].lanes[0].up

        # the supervisor heals: respawn on the CPU, replay, digest, rejoin
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            sup.check_once()
            if all(l.up for rs in store.shards for l in rs.lanes):
                break
            time.sleep(0.2)
        assert all(l.up for rs in store.shards for l in rs.lanes), \
            [(l.shard, l.replica, l.why_down)
             for rs in store.shards for l in rs.lanes if not l.up]
        assert _counter("replica.failovers") - failovers0 >= 2
        assert _counter("replica.recover_failures") == fail0
        # each resync observed once, split into its respawn and replay parts
        d = {n: (_hist(n).count - hists0[n][0], _hist(n).sum - hists0[n][1])
             for n in hists}
        assert d["replica.resync"][0] == _counter("replica.failovers") \
            - failovers0
        assert d["replica.respawn"][0] == d["replica.replay"][0] \
            == d["replica.resync"][0]
        assert 0 < d["replica.respawn"][1] + d["replica.replay"][1] \
            <= d["replica.resync"][1]
        respawned = [l for rs in store.shards for l in rs.lanes
                     if id(l.handle) not in originals]
        assert {(l.shard, l.replica) for l in respawned} == {(0, 1), (1, 0)}
        for l in respawned:
            stats = l.conn.request(Message(MsgType.STATS, {}))
            assert str(stats["device"]) == "cpu"
            assert int(stats["size"]) == store._gid_len[l.shard]
        _assert_parity(ref, store, q)

        # batch 5 is the 6th ADD of both original survivors: they die and
        # the resynced replicas carry their shards alone
        ref.add(batches[5])
        store.add(batches[5])
        _assert_parity(ref, store, q)
        assert all(l.up == (id(l.handle) not in originals)
                   for rs in store.shards for l in rs.lanes)
        assert journal.last_seq == 5
    finally:
        if sup is not None:
            sup.stop()
        _stop_plane(store, grid)
        journal.close()
    return read_fired_log(log_path)


def test_chaos_failover_bit_identical(tmp_path):
    """S = 2 x R = 2 port workers on the CPU, every kill a FaultPlan event:
    answers equal the reference store's throughout; the supervisor
    restores R = 2 on the CPU; the resynced replicas carry the plane
    alone.  Two runs on one seed fire identical logs with four kills."""
    seed = int(os.environ.get("REPRO_FAULT_SEED", "1234"))
    fired_a = _chaos_once(tmp_path / "a", seed)
    fired_b = _chaos_once(tmp_path / "b", seed)
    assert fired_a, "no fault events fired"
    assert sum(1 for r in fired_a if r["kind"] == "kill") == 4
    assert fired_a == fired_b, (fired_a, fired_b)


def test_all_replicas_down_is_an_error_not_a_hang(tmp_path):
    """Killing EVERY replica of a shard surfaces as an exception within
    the deadline."""
    sigs = _corpus(n=60)
    journal = IngestJournal(str(tmp_path / "ingest.journal"))
    grid = spawn_replicated(_cfg(), 1, 2, device="cpu")
    store = None
    try:
        store = connect_replicated(grid, _cfg(), journal=journal, timeout=30,
                                   device="cpu")
        store.add(sigs)
        for h in grid[0]:
            h.terminate()
        time.sleep(0.5)
        t0 = time.monotonic()
        with pytest.raises(Exception):
            store.query(sigs[:4], top_k=3)
        assert time.monotonic() - t0 < 30
    finally:
        _stop_plane(store, grid)
        journal.close()


# -- snapshots and journals across the packages -----------------------------------

def _write_plane(cls, cfg, journal, snap, batches, **kw):
    """Two batches, a snapshot, two more batches (the journal tail)."""
    plane = cls(cfg, 2, journal=journal, **kw)
    for b in batches[:2]:
        plane.add(b)
    plane.save(snap)
    for b in batches[2:]:
        plane.add(b)
    return plane


def _digests(plane) -> list[dict]:
    return [{k: int(v) for k, v in sh.store.digest().items()}
            for sh in plane.shards]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_snapshot_and_journal_cross_boot(tmp_path, writer):
    """A plane snapshot + journal tail written by one package's
    ``ReplicatedSketchStore`` (in process) boots in the other's with
    ``replay_tail``: answers and per-shard digests equal the writer's."""
    sigs = _corpus(n=160, seed=5)
    batches = np.array_split(sigs, 4)
    q = _queries(sigs)
    snap = str(tmp_path / "snap")
    jpath = str(tmp_path / "ingest.journal")
    if writer == "reference":
        with RefJournal(jpath) as j:
            src = _write_plane(RefReplicated, _ref_cfg(), j, snap, batches)
        with IngestJournal(jpath) as j:
            dst = ReplicatedSketchStore.load(snap, device="cpu")
            dst.journal = j
            assert dst.replay_tail() == 2
    else:
        with IngestJournal(jpath) as j:
            src = _write_plane(ReplicatedSketchStore, _cfg(), j, snap,
                               batches, device="cpu")
        with RefJournal(jpath) as j:
            dst = RefReplicated.load(snap)
            dst.journal = j
            assert dst.replay_tail() == 2
    assert snapshot_journal_seq(snap) == 1
    assert dst.n_items == src.n_items == len(sigs)
    assert _digests(dst) == _digests(src)
    want = src.query(q, top_k=5)
    got = dst.query(q, top_k=5)
    assert np.array_equal(np.asarray(got[0]), np.asarray(want[0]))
    assert np.array_equal(np.asarray(got[1]), np.asarray(want[1]))


def test_port_workers_boot_from_reference_snapshot(tmp_path):
    """Port workers (S = 2 x R = 2, on the CPU) spawned from a reference
    plane's snapshot; ``connect_replicated`` without the snapshot refuses
    them (the lane-size check), and with it replays the reference journal's
    tail into every lane: answers equal the reference store's and every
    lane's digest its shard's in the reference plane."""
    sigs = _corpus(n=160, seed=9)
    batches = np.array_split(sigs, 4)
    q = _queries(sigs)
    snap = str(tmp_path / "snap")
    jpath = str(tmp_path / "ingest.journal")
    ref = RefStore(_ref_cfg())
    for b in batches:
        ref.add(b)
    with RefJournal(jpath) as j:
        src = _write_plane(RefReplicated, _ref_cfg(), j, snap, batches)
    grid = spawn_replicated(None, 2, 2, device="cpu", snapshot_dir=snap)
    store = journal = None
    try:
        with pytest.raises(WorkerError, match="gid map"):
            connect_replicated(grid, _cfg(), timeout=30, device="cpu")
        journal = IngestJournal(jpath)
        store = connect_replicated(grid, journal=journal, snapshot_dir=snap,
                                   timeout=30, device="cpu")
        assert store.n_items == len(sigs) and journal.last_seq == 3
        _assert_parity(ref, store, q)
        want = _digests(src)
        for s, rs in enumerate(store.shards):
            for lane in rs.lanes:
                d = lane.conn.request(Message(MsgType.DIGEST, {}))
                assert {k: int(d[k]) for k in want[s]} == want[s]
    finally:
        _stop_plane(store, grid)
        if journal is not None:
            journal.close()
