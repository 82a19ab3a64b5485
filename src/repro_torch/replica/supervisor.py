"""Supervisor: heartbeats, respawn, journal replay, digest-gated rejoin.

The port of ``repro.replica.supervisor``, with one parameter the reference
does not have: ``device``, where a respawned worker puts its store.  The
port's workers default to the card, so a supervisor of a CPU plane must be
told ``device="cpu"`` (the service passes its ``SearchConfig.device``); a
card plane whose respawn cannot reach the card leaves the lane down and
counts the failure, as any failed recovery does.

The supervisor is the plane's self-healing loop.  Each tick it walks every
``ReplicaSet`` lane and checks three liveness signals: the lane's marked
state (a write leg or read failover already downed it), the worker process
itself (``WorkerHandle.alive``), and a STATS heartbeat over a private
control connection (a process can be alive but wedged).  The heartbeat is
the worker's liveness probe (``wire.PING_FIELD``), answered beside the
handler it is running rather than behind it, so a long ADD (a table
rebuild takes seconds) never reads as a dead worker; the probe's reply
says how long that handler has held the worker, and a handler held past
``busy_timeout_s`` marks the lane down as wedged.  Each probe's round
trip is observed in the ``replica.heartbeat`` histogram.  A lane that
fails any check is recovered:

  1. **terminate** whatever is left of the old worker;
  2. **respawn** a fresh worker for the same (shard, replica) slot on
     ``device``, booted from the plane snapshot when one exists (then only
     the journal tail past ``replica_state.npz``'s seq needs replay), else
     empty;
  3. **replay** the ingest journal against it: each record's batch is
     sliced through the coordinator's own partitioner
     (``store._shard_of(gid0 + arange(B))``), so the worker re-applies
     exactly the slices its shard saw, in seq order, which makes the
     rebuilt signature buffer bit-identical, not just same-sized.  Replay
     loops outside the plane lock until it catches up (ingest may be
     racing it), then takes the lock for the final tail;
  4. **verify** the rebuilt worker's digest (``MsgType.DIGEST``: CRC-32 of
     the signature buffer + size) against a live peer replica: a corrupt
     snapshot, a lost journal record or a divergent peer all fail closed
     here, and the lane stays down rather than serve wrong answers;
  5. **rejoin** atomically (``ReplicaSet.rejoin`` under the plane lock).

A failed recovery counts ``replica.recover_failures``, tears down the
half-built worker and leaves the lane down; the next tick retries.  A
successful one counts ``replica.failovers`` and observes the
``replica.resync`` histogram (kill-to-rejoin wall time), and splits it
into ``replica.respawn`` (the dead worker's teardown, the new one's boot
and connection) and
``replica.replay`` (the journal replay, catch-up passes and final tail).

Crash-loop protection: a lane that dies again within ``stable_window_s``
of its last rejoin extends a per-lane streak, and each streak step delays
the next respawn by exponential backoff with jitter.  A lane whose streak
reaches ``max_respawns`` is capped: it stays down and counts once into
``replica.crash_loops``.  A lane that survives the stable window resets
its streak.
"""

from __future__ import annotations

import os
import random
import threading
import time
import traceback

import numpy as np

from ..device import DEFAULT_DEVICE
from ..obs import metrics as obs_metrics
from ..transport.client import ShardConnection, TransportError
from ..transport import wire
from ..transport.server import spawn_workers
from ..transport.wire import Message, MsgType
from .journal import JournalRecord
from .replicaset import (ReplicaLane, ReplicaSet, ReplicatedSketchStore,
                         snapshot_journal_seq)

#: replay passes outside the lock before forcing the final locked pass
_MAX_REPLAY_PASSES = 20


class Supervisor:
    """Background self-healing for a ``ReplicatedSketchStore`` plane whose
    workers hold their stores on ``device``."""

    def __init__(self, store: ReplicatedSketchStore, *,
                 device: str = DEFAULT_DEVICE,
                 interval_s: float = 0.5, heartbeat_timeout_s: float = 5.0,
                 busy_timeout_s: float = 30.0,
                 snapshot_dir: str | None = None,
                 probe_impl: str = "auto", query_impl: str = "auto",
                 start_timeout: float = 120.0,
                 backoff_base_s: float = 0.25, backoff_max_s: float = 30.0,
                 max_respawns: int = 5, stable_window_s: float = 30.0):
        self.store = store
        self.device = str(device)
        self.interval_s = float(interval_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.busy_timeout_s = float(busy_timeout_s)
        self.snapshot_dir = snapshot_dir
        self.probe_impl = probe_impl
        self.query_impl = query_impl
        self.start_timeout = float(start_timeout)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.max_respawns = int(max_respawns)
        self.stable_window_s = float(stable_window_s)
        reg = obs_metrics.default()
        self._m_failovers = reg.counter("replica.failovers")
        self._m_recover_fail = reg.counter("replica.recover_failures")
        self._m_heartbeats = reg.counter("replica.heartbeats")
        self._h_heartbeat = reg.histogram("replica.heartbeat")
        self._m_crash_loops = reg.counter("replica.crash_loops")
        self._h_resync = reg.histogram("replica.resync")
        self._h_respawn = reg.histogram("replica.respawn")
        self._h_replay = reg.histogram("replica.replay")
        # per-lane crash-loop state: streak of quick deaths, earliest next
        # respawn, last rejoin instant (-1 = none pending), capped flag
        self._backoff: dict[tuple[int, int], dict] = {}
        # private control conns, one per (shard, replica) slot: heartbeats
        # never ride the query lanes, so a stalled fan-out cannot fake a
        # dead worker and a heartbeat cannot queue behind a big ADD
        self._ctrl: dict[tuple[int, int], ShardConnection] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="replica-supervisor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(self.heartbeat_timeout_s + 30.0)
        for c in self._ctrl.values():
            c.close()
        self._ctrl.clear()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check_once()
            except Exception:
                # the healer must not die of one bad tick
                traceback.print_exc()

    # -- one tick ------------------------------------------------------------
    def check_once(self) -> int:
        """Walk every lane; recover the dead ones.  Returns lanes healed."""
        healed = 0
        for rset in self.store.shards:
            if not isinstance(rset, ReplicaSet):
                continue
            for lane in list(rset.lanes):
                if self._stop.is_set():
                    return healed
                if lane.up and lane.handle is not None \
                        and not lane.handle.alive:
                    rset._mark_down(lane, "worker process died")
                if lane.up:
                    why = self._heartbeat(lane)
                    if why is not None:
                        rset._mark_down(lane, why)
                if not lane.up:
                    healed += bool(self._recover(rset, lane))
        return healed

    def _heartbeat(self, lane: ReplicaLane) -> str | None:
        """Probe the lane's worker: None when it is live, else why not."""
        key = (lane.shard, lane.replica)
        conn = self._ctrl.get(key)
        target = lane.handle.address if lane.handle is not None \
            else lane.conn.address
        if conn is None or conn.broken or conn.address != tuple(target):
            if conn is not None:
                conn.close()
            try:
                conn = ShardConnection(target,
                                       timeout=self.heartbeat_timeout_s,
                                       deadline_name="heartbeat_timeout_s",
                                       shard=lane.shard,
                                       replica=lane.replica)
            except TransportError:
                self._ctrl.pop(key, None)
                return "heartbeat failed"
            self._ctrl[key] = conn
        t0 = time.perf_counter()
        try:
            reply = conn.request(Message(MsgType.STATS,
                                         {wire.PING_FIELD: 1}))
        except TransportError:
            return "heartbeat failed"
        self._h_heartbeat.observe(time.perf_counter() - t0)
        self._m_heartbeats.inc()
        # a worker that answers every STATS behind its lock sends no busy_us
        busy_s = int(reply.fields.get("busy_us", 0)) / 1e6
        if busy_s > self.busy_timeout_s:
            return f"wedged: a handler has held the worker {busy_s:.1f} s"
        return None

    # -- crash-loop gate -----------------------------------------------------
    def _crash_gate(self, lane: ReplicaLane) -> bool:
        """May this down lane be respawned *now*?  Advances the per-lane
        crash-loop streak the first time a post-rejoin death is seen; a
        capped lane never passes again."""
        key = (lane.shard, lane.replica)
        st = self._backoff.setdefault(
            key, {"streak": 0, "not_before": 0.0, "rejoined": -1.0,
                  "capped": False})
        if st["capped"]:
            return False
        now = time.monotonic()
        if st["rejoined"] >= 0.0:
            # first tick that sees this lane down again after a rejoin:
            # a quick death extends the streak, a long-stable lane resets it
            quick = (now - st["rejoined"]) < self.stable_window_s
            st["streak"] = st["streak"] + 1 if quick else 0
            st["rejoined"] = -1.0
            if st["streak"] >= self.max_respawns:
                st["capped"] = True
                self._m_crash_loops.inc()
                return False
            if st["streak"] > 0:
                delay = min(self.backoff_max_s,
                            self.backoff_base_s * 2.0 ** (st["streak"] - 1))
                st["not_before"] = now + delay * (0.5 + random.random())
        return now >= st["not_before"]

    # -- recovery ------------------------------------------------------------
    def _recover(self, rset: ReplicaSet, lane: ReplicaLane) -> bool:
        if not self._crash_gate(lane):
            return False               # backing off / capped: not a failure
        t0 = time.perf_counter()
        handle = None
        conn = None
        try:
            if lane.handle is not None:
                lane.handle.terminate()
            self._ctrl.pop((lane.shard, lane.replica), None)
            snap, after = None, -1
            if self.snapshot_dir is not None:
                seq = snapshot_journal_seq(self.snapshot_dir)
                if seq >= 0 or os.path.exists(os.path.join(
                        self.snapshot_dir, f"shard_{rset.shard}.npz")):
                    snap, after = self.snapshot_dir, seq
            handle = spawn_workers(self.store.cfg, 1, device=self.device,
                                   snapshot_dir=snap,
                                   probe_impl=self.probe_impl,
                                   query_impl=self.query_impl,
                                   start_timeout=self.start_timeout,
                                   shards=[rset.shard],
                                   replicas=[lane.replica])[0]
            conn = ShardConnection(handle.address,
                                   timeout=lane.conn.timeout,
                                   deadline_name="query_timeout_s",
                                   shard=rset.shard, replica=lane.replica)
            respawn_s = time.perf_counter() - t0
            # catch-up replay outside the lock: ingest may be racing, so
            # loop until a pass finds nothing new (bounded), then take the
            # lock for the final tail + verification + rejoin
            last = after
            t_replay = time.perf_counter()
            for _ in range(_MAX_REPLAY_PASSES):
                recs = self._tail(last)
                if not recs:
                    break
                last = self._replay(conn, rset.shard, recs)
            replay_s = time.perf_counter() - t_replay
            with self.store.lock:
                t_replay = time.perf_counter()
                recs = self._tail(last)
                if recs:
                    last = self._replay(conn, rset.shard, recs)
                replay_s += time.perf_counter() - t_replay
                self._verify(rset, lane, conn)
                rset.rejoin(lane, conn, handle)
            st = self._backoff.get((lane.shard, lane.replica))
            if st is not None:
                st["rejoined"] = time.monotonic()
            self._m_failovers.inc()
            self._h_resync.observe(time.perf_counter() - t0)
            self._h_respawn.observe(respawn_s)
            self._h_replay.observe(replay_s)
            return True
        except Exception:
            self._m_recover_fail.inc()
            if conn is not None:
                conn.close()
            if handle is not None:
                handle.terminate()
            traceback.print_exc()
            return False               # lane stays down; next tick retries

    def _tail(self, after: int) -> list[JournalRecord]:
        j = self.store.journal
        return j.records(after=after) if j is not None else []

    def _replay(self, conn: ShardConnection, shard: int,
                recs: list[JournalRecord]) -> int:
        """Apply this shard's slice of each record, in seq order; returns
        the last seq applied.  Slicing uses the coordinator's own
        partitioner, so the worker re-sees exactly the rows (and row
        order) its shard's live replicas indexed."""
        last = -1
        for rec in recs:
            gids = np.arange(rec.gid0, rec.gid0 + len(rec.batch),
                             dtype=np.int64)
            sel = self.store._shard_of(gids) == shard
            if sel.any():
                key = "words" if rec.packed else "rows"
                conn.request(Message(MsgType.ADD,
                                     {key: np.ascontiguousarray(
                                         rec.batch[sel])}))
            last = rec.seq
        return last

    def _verify(self, rset: ReplicaSet, lane: ReplicaLane,
                conn: ShardConnection) -> None:
        """Fail closed unless the rebuilt worker provably matches: its row
        count must equal the coordinator's gid map for the shard, and its
        digest must equal a live peer replica's."""
        d = dict(conn.request(Message(MsgType.DIGEST, {})).fields)
        want = self.store._gid_len[rset.shard]
        if int(d["size"]) != want:
            raise RuntimeError(
                f"resynced worker {conn._name} holds {int(d['size'])} "
                f"items but the coordinator's gid map has {want}")
        for peer in rset.up_lanes():
            if peer is lane:
                continue
            try:
                with self.store.lock:
                    rset.group.ensure_clean(peer.conn)
                    pd = dict(peer.conn.request(
                        Message(MsgType.DIGEST, {})).fields)
            except TransportError:
                continue               # a dying peer cannot veto the rejoin
            if (int(pd["size"]), int(pd["crc"])) \
                    != (int(d["size"]), int(d["crc"])):
                raise RuntimeError(
                    f"resynced worker {conn._name} digest "
                    f"(size={int(d['size'])}, crc={int(d['crc']):#x}) "
                    f"diverges from live peer {peer.conn._name} "
                    f"(size={int(pd['size'])}, crc={int(pd['crc']):#x})")
            return                     # one live peer's word is enough
