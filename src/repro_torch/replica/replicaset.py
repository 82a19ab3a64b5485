"""ReplicaSet: R-way replicated shards behind the ``ShardBackend`` seam.

The port of ``repro.replica.replicaset``.  One ``ReplicaSet`` stands where
one shard backend stood: the coordinator (``ShardedSketchStore``) still
sees S shards, but each shard is now R worker processes holding
bit-identical copies of the same rows, each with its store on the plane's
device.  The seam keeps every layer above unchanged (partitioning, gid
maps, the merge, the service) while the plane underneath gains redundancy:

  * **Reads** (QUERY/BRUTE) are idempotent, so they are submitted on the
    shard's PRIMARY lane and protected twice over by the transport's hedge
    machinery: the replica set wires the primary's hedge twin to ANOTHER
    replica's connection (``FanoutGroup.set_twin``), so a slow primary is
    raced against a different worker and a primary that dies mid-round
    fails over in-round (the failure-triggered hedge).  Replies are
    bit-identical whichever lane answers, because writes reach every up
    lane before any later read.  If the whole round still dies,
    ``result()`` falls back to a blocking per-lane retry, marking lanes
    down only when their OWN request fails.  The batch's hashes and words
    cross to the host once (``BandHashes.host()``, ``QueryWords.host()``),
    as for ``RemoteShard``.

  * **Writes** (ADD) fan out to every up lane as TOLERANT legs
    (``FanoutGroup.submit(tolerate=True)``): a dead replica's leg fails
    alone, the lane is marked down for the supervisor to rebuild, and the
    sibling legs complete.  Only when EVERY lane of a shard fails does the
    write surface as the failure the unreplicated plane would have seen
    (dirty / unknown-outcome flags OR-reduced across lanes, so the
    coordinator's all-or-nothing scatter decision sees the worst case).

``ReplicatedSketchStore`` is the coordinator over replica sets: the same
scatter and merge as ``ShardedSketchStore`` plus (a) a write-ahead
``IngestJournal`` append before every scatter (rolled back when a scatter
provably landed nowhere), and (b) a plane ``lock`` serializing rounds
against the supervisor's atomic rejoin.
"""

from __future__ import annotations

import dataclasses
import os
import threading

import numpy as np

from ..device import DEFAULT_DEVICE
from ..kernels.query_fused import BandHashes, QueryWords
from ..obs import metrics as obs_metrics
from ..store.sharded import ShardedSketchStore
from ..transport import wire
from ..transport.client import (DeadlineExceeded, FanoutGroup, HedgePolicy,
                                RemoteShard, RetryBudget, ShardConnection,
                                TransportError, WorkerError, _partial_from)
from ..transport.server import WorkerHandle, spawn_workers
from ..transport.wire import Message, MsgType
from .journal import IngestJournal

#: beside the plane manifest: which journal seq the snapshot covers
REPLICA_STATE_FILE = "replica_state.npz"


@dataclasses.dataclass(eq=False)      # identity semantics: lanes key dicts
class ReplicaLane:
    """One replica of one shard: its worker and the coordinator's lane."""

    shard: int
    replica: int
    conn: ShardConnection
    handle: WorkerHandle | None = None     # None for externally-run workers
    up: bool = True
    why_down: str | None = None


# the ambient trace context and deadline as wire fields, as a remote
# shard sends them: worker spans join the coordinator's trace, and expired
# reads are dropped worker-side
_traced = RemoteShard._traced


class _ReplicaRead:
    """Pending read with failover: the fan-out leg when it lands, else a
    blocking per-lane retry (idempotent reads may re-ask any replica)."""

    lazy = False

    def __init__(self, rset: "ReplicaSet", pend, msg: Message, decode):
        self._rset = rset
        self._pend = pend
        self._msg = msg
        self._decode = decode

    def result(self):
        try:
            return self._pend.result()
        except DeadlineExceeded:
            raise          # the caller is gone: no lane can answer in time
        except TransportError as first:
            return self._failover(first)

    @property
    def latency_s(self) -> float | None:
        return getattr(self._pend, "latency_s", None)

    def _failover(self, first: TransportError):
        rs = self._rset
        rs._m_read_failover.inc()
        last: TransportError = first
        candidates = rs.breaker_ordered(rs.up_lanes())
        for i, lane in enumerate(candidates):
            # an open breaker means this lane has been flapping: skip it
            # (no probe due yet) unless it is the LAST candidate, so an
            # all-open shard still gets one attempt
            if i < len(candidates) - 1 \
                    and not lane.conn.breaker.allow():
                continue
            # every failover re-ask is retry traffic from the shared
            # budget; an exhausted budget surfaces the original failure
            if not rs.group.budget.try_spend():
                raise WorkerError(
                    f"shard {rs.shard}: read failover stopped — retry "
                    f"budget exhausted (original failure: "
                    f"{type(first).__name__}: {first})") from first
            try:
                rs.group.ensure_clean(lane.conn)
                reply = lane.conn.request(Message(self._msg.type,
                                                  dict(self._msg.fields)))
            except TransportError as e:
                if lane.conn.broken is None:
                    # an ERROR/OVERLOADED reply over an intact stream: the
                    # worker is alive and rejected the request; the
                    # caller's retry policy decides, and the lane stays up
                    raise
                last = e
                rs._mark_down(lane, f"read failover failed: {e}")
                continue
            return self._decode(reply)
        err = WorkerError(
            f"shard {rs.shard}: every replica lane failed the read "
            f"(last: {type(last).__name__}: {last})")
        raise err from last


class _ReplicaAdd:
    """Pending write over all up lanes: gathers every leg, downs the
    failed ones, and succeeds if at least one replica indexed the batch."""

    lazy = False

    def __init__(self, rset: "ReplicaSet", pend: dict, submit_errs: dict):
        self._rset = rset
        self._pend = pend              # lane -> _Pending
        self._errs = dict(submit_errs)  # lane -> submit-phase failure

    def result(self) -> int:
        rs = self._rset
        results: dict[ReplicaLane, int] = {}
        errors = dict(self._errs)
        for lane, p in self._pend.items():
            try:
                results[lane] = int(p.result())
            except Exception as e:
                errors[lane] = e
        if not results:
            # every replica failed this shard's slice: surface the worst
            # case so the coordinator's scatter decides as it would for an
            # unreplicated shard
            first = next(iter(errors.values()))
            legs = ", ".join(f"replica {l.replica}: {type(e).__name__}"
                             for l, e in errors.items())
            err = WorkerError(
                f"shard {rs.shard}: every replica lane failed the write "
                f"({legs}): {first}")
            err.dirty = any(getattr(e, "dirty", False)
                            for e in errors.values())
            err.unknown_outcome = any(getattr(e, "unknown_outcome", False)
                                      for e in errors.values())
            raise err from first
        # >= 1 replica landed the batch: the failed lanes are divergent;
        # down them (the supervisor rebuilds them from the journal) and
        # keep serving on reduced redundancy
        for lane, e in errors.items():
            rs._m_write_leg.inc()
            rs._mark_down(lane, f"write leg failed: {type(e).__name__}: {e}")
        counts = set(results.values())
        if len(counts) != 1:
            # replicas that all said OK disagree on rows indexed: the
            # copies have diverged and no lane is provably right
            per = {l.replica: n for l, n in results.items()}
            err = WorkerError(
                f"shard {rs.shard}: replicas disagree on rows indexed "
                f"({per})")
            err.dirty = True
            raise err
        return counts.pop()


class ReplicaSet:
    """``ShardBackend`` over R replica lanes of one shard (see module doc).

    Every membership change (lane down, rejoin, rewire) runs under the
    shared plane ``lock``, the lock the coordinator holds across a fan-out
    round, so the supervisor thread never mutates the group's lane tables
    while a round is in flight.
    """

    def __init__(self, shard: int, lanes: list[ReplicaLane],
                 group: FanoutGroup, lock: threading.RLock):
        if not lanes:
            raise ValueError("a ReplicaSet needs at least one lane")
        self.shard = shard
        self.lanes = list(lanes)
        self.group = group
        self.lock = lock
        reg = obs_metrics.default()
        self._m_up = reg.gauge(f"replica.shard{shard}.up")
        self._m_lane_down = reg.counter("replica.lanes_down")
        self._m_read_failover = reg.counter("replica.read_failovers")
        self._m_write_leg = reg.counter("replica.write_leg_failures")
        with self.lock:
            self._rewire()

    # -- membership ----------------------------------------------------------
    def up_lanes(self) -> list[ReplicaLane]:
        with self.lock:
            return [l for l in self.lanes if l.up]

    @staticmethod
    def breaker_ordered(lanes: list[ReplicaLane]) -> list[ReplicaLane]:
        """Stable order with breaker-healthy lanes first: a flapping lane
        is deprioritized, not banished."""
        return sorted(lanes, key=lambda l: not l.conn.breaker.healthy)

    def primary(self) -> ReplicaLane:
        with self.lock:
            for l in self.lanes:
                if l.up:
                    return l
        raise WorkerError(f"shard {self.shard}: no replica lane is up")

    def _rewire(self) -> None:
        """Recompute primary + hedge twin from the up set (lock held).
        The primary's twin is the NEXT up replica, so a hedge, timer- or
        failure-triggered, is a read failover to a different worker."""
        ups = [l for l in self.lanes if l.up]
        self._m_up.set(len(ups))
        for l in self.lanes:
            self.group.set_twin(l.conn, None)
        if len(ups) > 1:
            self.group.set_twin(ups[0].conn, ups[1].conn)

    def _mark_down(self, lane: ReplicaLane, why: str) -> None:
        with self.lock:
            if not lane.up:
                return
            lane.up = False
            lane.why_down = str(why)
            self._m_lane_down.inc()
            self.group.retire_conn(lane.conn)
            self._rewire()

    def rejoin(self, lane: ReplicaLane, conn: ShardConnection,
               handle: WorkerHandle | None) -> None:
        """Swap a rebuilt worker into the lane and bring it back up: the
        supervisor calls this AFTER the digest check, under the plane lock,
        so no round straddles the membership change."""
        with self.lock:
            old = lane.conn
            if old is not conn:
                self.group.retire_conn(old)
                old.close()
            lane.conn = conn
            lane.handle = handle
            lane.up = True
            lane.why_down = None
            self.group.adopt_conn(conn)
            self._rewire()

    # -- reads ---------------------------------------------------------------
    def _start_read(self, msg: Message, decode) -> _ReplicaRead:
        last: TransportError | None = None
        candidates = self.breaker_ordered(self.up_lanes())
        for i, lane in enumerate(candidates):
            if i < len(candidates) - 1 \
                    and not lane.conn.breaker.allow():
                continue       # breaker open and a sibling is available
            try:
                pend = self.group.submit(lane.conn, msg, decode=decode,
                                         reset_on_error=False,
                                         hedgeable=True,
                                         keep_round_on_error=True)
            except TransportError as e:
                # this lane cannot even carry the request: down it and
                # submit on the next replica; siblings already queued this
                # round stay live (keep_round_on_error)
                last = e
                self._mark_down(lane, f"submit failed: {e}")
                continue
            return _ReplicaRead(self, pend, msg, decode)
        raise last if last is not None else WorkerError(
            f"shard {self.shard}: no replica lane is up")

    def start_query(self, hashes: BandHashes, qwords: QueryWords,
                    top_k: int, mode: str) -> _ReplicaRead:
        lo, hi = wire.split_u64(hashes.host())
        msg = Message(MsgType.QUERY, _traced({
            "hash_lo": lo, "hash_hi": hi,
            "qwords": np.ascontiguousarray(qwords.host(), np.uint32),
            "top_k": int(top_k), "mode": mode}))
        return self._start_read(msg, lambda m: _partial_from(m))

    def start_brute(self, qwords: QueryWords, top_k: int) -> _ReplicaRead:
        msg = Message(MsgType.BRUTE, _traced({
            "qwords": np.ascontiguousarray(qwords.host(), np.uint32),
            "top_k": int(top_k)}))
        return self._start_read(msg, lambda m: _partial_from(m))

    # -- writes --------------------------------------------------------------
    def start_add(self, batch: np.ndarray, *,
                  packed: bool = False) -> _ReplicaAdd:
        lanes = self.up_lanes()
        if not lanes:
            raise WorkerError(f"shard {self.shard}: no replica lane is up")
        arr = np.ascontiguousarray(batch,
                                   np.uint32 if packed else np.int32)
        key = "words" if packed else "rows"
        pend: dict[ReplicaLane, object] = {}
        errs: dict[ReplicaLane, BaseException] = {}
        for lane in lanes:
            # one Message a leg: the group assigns seq per connection
            msg = Message(MsgType.ADD, _traced({key: arr}))
            try:
                pend[lane] = self.group.submit(
                    lane.conn, msg, decode=lambda m: int(m["n"]),
                    reset_on_error=False, tolerate=True,
                    keep_round_on_error=True)
            except Exception as e:
                errs[lane] = e
        if not pend:
            # no leg of this shard made it onto the wire: abandon the whole
            # round (sibling shards' queued-but-unsent frames included) so
            # the coordinator's submit-phase failure stays provably clean
            self.group.reset()
            first = next(iter(errs.values()))
            raise WorkerError(
                f"shard {self.shard}: every replica lane failed at submit: "
                f"{type(first).__name__}: {first}") from first
        for lane, e in errs.items():
            self._m_write_leg.inc()
            self._mark_down(lane,
                            f"write submit failed: {type(e).__name__}: {e}")
        return _ReplicaAdd(self, pend, {})

    def add(self, sigs: np.ndarray) -> int:
        return self.start_add(np.asarray(sigs), packed=False).result()

    def add_packed(self, words: np.ndarray) -> int:
        return self.start_add(np.asarray(words, np.uint32),
                              packed=True).result()

    # -- control -------------------------------------------------------------
    def stats(self) -> dict:
        return dict(self.primary().conn.request(
            Message(MsgType.STATS, {})).fields)

    def stats_all(self) -> list[tuple[int, dict]]:
        """Per-lane stats as ``(replica, stats)`` pairs: the hook
        ``ShardedSketchStore.obs_snapshot`` uses to label every worker's
        registry snapshot with its (shard, replica) coordinates."""
        out = []
        for lane in self.up_lanes():
            try:
                out.append((lane.replica, dict(lane.conn.request(
                    Message(MsgType.STATS, {})).fields)))
            except TransportError:
                continue               # a lane dying mid-stats is not fatal
        return out

    def digest(self) -> dict:
        return dict(self.primary().conn.request(
            Message(MsgType.DIGEST, {})).fields)

    def save(self, path: str) -> None:
        # replicas are bit-identical (the digest-checked invariant), so one
        # lane's snapshot IS the shard's snapshot
        self.primary().conn.request(
            Message(MsgType.SNAPSHOT, {"path": str(path)}))

    def shutdown(self) -> None:
        for lane in self.up_lanes():
            try:
                lane.conn.request(Message(MsgType.SHUTDOWN, {}))
            except TransportError:
                pass
        self.close()

    def close(self) -> None:
        for lane in self.lanes:
            lane.conn.close()


class ReplicatedSketchStore(ShardedSketchStore):
    """``ShardedSketchStore`` + write-ahead journal + plane lock.

    The journal append happens BEFORE the scatter (write-ahead), under the
    plane lock, so the journal's seq order IS the plane's batch order and a
    resynced replica replaying ``records(after=...)`` reproduces exactly
    the insertion sequence the live lanes saw.  A scatter that provably
    landed on no shard rolls its record back.
    """

    def __init__(self, cfg, n_shards: int = 1, *,
                 journal: IngestJournal | None = None,
                 lock: threading.RLock | None = None, **kw):
        super().__init__(cfg, n_shards, **kw)
        self.journal = journal
        self.lock = lock if lock is not None else threading.RLock()

    def _scatter(self, batch: np.ndarray, *, packed: bool) -> np.ndarray:
        with self.lock:
            if self.journal is None:
                return super()._scatter(batch, packed=packed)
            off = self.journal.append(np.asarray(batch), packed=packed,
                                      gid0=self.n_items)
            try:
                return super()._scatter(batch, packed=packed)
            except BaseException:
                if self._failed is None:
                    # provably-clean failure: no shard indexed the batch,
                    # so the record must not survive to be replayed
                    self.journal.rollback(off)
                raise

    def _merged_query(self, *args, **kw):
        with self.lock:
            return super()._merged_query(*args, **kw)

    def replay_tail(self) -> int:
        """Re-apply journal records beyond the coordinator's current state
        (a plane rebooted from a snapshot older than the journal tail).
        Returns the number of batches re-applied."""
        if self.journal is None:
            return 0
        n = 0
        with self.lock:
            for rec in self.journal.records(after=-1):
                if rec.gid0 < self.n_items:
                    continue           # already covered by the snapshot
                if rec.gid0 != self.n_items:
                    raise RuntimeError(
                        f"journal record seq={rec.seq} starts at gid "
                        f"{rec.gid0} but the plane holds {self.n_items} "
                        "items — journal/snapshot mismatch")
                # bypass the journal append: this batch is already recorded
                ShardedSketchStore._scatter(self, rec.batch,
                                            packed=rec.packed)
                n += 1
        return n

    def save(self, dirpath: str) -> None:
        with self.lock:
            super().save(dirpath)
            if self.journal is not None:
                np.savez(os.path.join(dirpath, REPLICA_STATE_FILE),
                         journal_seq=self.journal.last_seq)

    def compact(self, dirpath: str) -> int:
        """Snapshot the plane, then drop the journal prefix the snapshot
        covers (append -> snapshot -> truncate).  Returns records dropped."""
        with self.lock:
            seq = self.journal.last_seq if self.journal is not None else -1
            self.save(dirpath)
            if self.journal is None:
                return 0
            return self.journal.truncate_through(seq)


def snapshot_journal_seq(dirpath: str) -> int:
    """The journal seq a plane snapshot covers (-1: none recorded)."""
    path = os.path.join(dirpath, REPLICA_STATE_FILE)
    if not os.path.exists(path):
        return -1
    with np.load(path) as z:
        return int(z["journal_seq"])


def spawn_replicated(cfg, n_shards: int, n_replicas: int, *,
                     device: str = DEFAULT_DEVICE,
                     snapshot_dir: str | None = None,
                     probe_impl: str = "auto", query_impl: str = "auto",
                     host: str = "127.0.0.1", start_timeout: float = 120.0,
                     slow_lanes: dict[tuple[int, int],
                                      tuple[float, float]] | None = None,
                     gate_limit: int | None = None,
                     faults: dict[tuple[int, int], object] | None = None,
                     ) -> list[list[WorkerHandle]]:
    """Spawn an S x R worker grid, every store on ``device``; returns
    ``grid[shard][replica]``.

    Every replica of shard s boots from the SAME ``shard_{s}.npz`` when
    ``snapshot_dir`` is given, so replicas start bit-identical.
    ``slow_lanes`` maps ``(shard, replica)`` to the ``(prob, sleep_s)``
    injected read latency of ``spawn_workers``; ``faults`` maps
    ``(shard, replica)`` to that lane's ``FaultPlan`` (or encoded spec):
    plans are per spawn, so a supervisor respawn of the slot does NOT
    inherit the schedule.
    """
    shards = [s for s in range(n_shards) for _ in range(n_replicas)]
    replicas = [r for _ in range(n_shards) for r in range(n_replicas)]
    slow = None
    if slow_lanes:
        slow = {i: slow_lanes[(shards[i], replicas[i])]
                for i in range(len(shards))
                if (shards[i], replicas[i]) in slow_lanes}
    plans = None
    if faults:
        plans = {i: faults[(shards[i], replicas[i])]
                 for i in range(len(shards))
                 if (shards[i], replicas[i]) in faults}
    handles = spawn_workers(cfg, n_shards * n_replicas, device=device,
                            snapshot_dir=snapshot_dir,
                            probe_impl=probe_impl, query_impl=query_impl,
                            host=host, start_timeout=start_timeout,
                            slow_shards=slow, shards=shards,
                            replicas=replicas, gate_limit=gate_limit,
                            faults=plans)
    return [[handles[s * n_replicas + r] for r in range(n_replicas)]
            for s in range(n_shards)]


def connect_replicated(grid: list[list[WorkerHandle]], cfg=None, *,
                       journal: IngestJournal | None = None,
                       snapshot_dir: str | None = None,
                       partition: str = "round_robin",
                       query_impl: str = "auto", timeout: float = 30.0,
                       hedge: "HedgePolicy | bool | None" = True,
                       budget: RetryBudget | None = None,
                       device: str = DEFAULT_DEVICE,
                       ) -> ReplicatedSketchStore:
    """Build a ``ReplicatedSketchStore`` over a ``spawn_replicated`` grid,
    its coordinator on ``device`` (where a query batch is folded once).

    One ``FanoutGroup`` spans every lane of every shard; each shard's
    ``ReplicaSet`` wires its primary's hedge twin to the next replica, so
    the default ``hedge=True`` arms both tail-latency hedging and in-round
    read failover.  ``journal`` is the plane's write-ahead ingest journal
    (the supervisor's resync needs it); ``snapshot_dir`` restores
    coordinator state as ``connect_sharded`` does, then replays any journal
    tail past the snapshot.
    """
    if hedge is True:
        hedge = HedgePolicy()
    elif hedge is False:
        hedge = None
    conns: list[ShardConnection] = []
    lanes_by_shard: list[list[ReplicaLane]] = []
    try:
        for s, row in enumerate(grid):
            lanes = []
            for r, h in enumerate(row):
                conn = ShardConnection(h.address, timeout=timeout,
                                       deadline_name="query_timeout_s",
                                       shard=s, replica=r)
                conns.append(conn)
                lanes.append(ReplicaLane(s, r, conn, h))
            lanes_by_shard.append(lanes)
        group = FanoutGroup(conns, timeout=timeout, hedge=hedge,
                            deadline_name="query_timeout_s", budget=budget)
        lock = threading.RLock()
        rsets = [ReplicaSet(s, lanes, group, lock)
                 for s, lanes in enumerate(lanes_by_shard)]
        if snapshot_dir is not None:
            store = ReplicatedSketchStore.load(snapshot_dir, backends=rsets,
                                               query_impl=query_impl,
                                               device=device)
            store.journal = journal
            store.lock = lock
            store.replay_tail()
        elif cfg is None:
            raise ValueError("connect_replicated needs cfg or snapshot_dir")
        else:
            store = ReplicatedSketchStore(cfg, len(rsets),
                                          partition=partition,
                                          query_impl=query_impl,
                                          backends=rsets, journal=journal,
                                          lock=lock, device=device)
        # every lane of shard s must hold exactly the coordinator's count
        # for s: a stale or wrong-snapshot replica would serve shard-LOCAL
        # ids as global answers with no error
        for s, rset in enumerate(rsets):
            want = store._gid_len[s]
            for lane in rset.lanes:
                size = int(lane.conn.request(
                    Message(MsgType.STATS, {}))["size"])
                if size != want:
                    raise WorkerError(
                        f"worker {lane.conn._name} holds {size} items but "
                        f"the coordinator's gid map has {want} — wrong "
                        "snapshot_dir (or none) for these workers?")
        return store
    except BaseException:
        for c in conns:                # no fd leak on failure
            c.close()
        raise
