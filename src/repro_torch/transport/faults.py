"""Deterministic fault injection for the transport plane.

The port's own copy of ``repro.transport.faults``: the same plan encoding
and the same environment variables (``REPRO_FAULTS``, ``REPRO_FAULT_LOG``),
so one plan drives workers of either package.

Chaos coverage is only trustworthy when the same scenario runs twice and
injects the same faults at the same protocol points; a wall-clock-raced
``handle.terminate()`` kills a worker *somewhere* near the intended
message, and which lane dies mid-frame differs run to run.

A ``FaultPlan`` is a fixed schedule of :class:`FaultEvent`\\ s, each fired
on the ``at``-th message of a given type seen by the installed peer:

    ``delay``     sleep ``delay_ms`` before handling the message
    ``drop``      close the connection without replying (mid-round EOF)
    ``truncate``  send a deliberately short frame, then close (the peer
                  sees ``TruncatedFrame`` — a corrupt stream, not a hangup)
    ``kill``      hard-exit the worker process before handling (the
                  sharpest chaos primitive: death mid-protocol, not at a
                  test-chosen wall-clock instant)

Counting is per message type (``at=2, msg_type="add"`` fires on the third
ADD regardless of interleaved QUERY/STATS traffic), so the schedule is a
pure function of the protocol conversation — if the driving workload is
deterministic, the injected-event sequence is too, and the fired-event log
proves it: every fired event appends one JSON line to ``log_path``
(flushed + fsynced *before* the fault acts, so even a ``kill`` leaves its
record).  Run the scenario twice with the same plan and diff the logs.

Plans serialize to JSON (``encode``/``decode``) so they cross the
``spawn_workers`` process boundary and can ride environment variables:
``REPRO_FAULTS`` holds a ``{"<shard>.<replica>": spec}`` map applied by
``transport.server.run_worker``; ``REPRO_FAULT_LOG`` points the fired-event
log somewhere the test can read.  Client-side injection (coordinator
perspective: delay or drop *outgoing* requests) goes through
``install_client_plan`` and is consulted by ``transport.client``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

FAULTS_ENV = "REPRO_FAULTS"
FAULT_LOG_ENV = "REPRO_FAULT_LOG"

KINDS = ("delay", "drop", "truncate", "kill")

# exit code of a plan-killed worker — distinguishes an injected death from
# a genuine crash in test/bench triage
KILL_EXIT_CODE = 57


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """Fire ``kind`` on the ``at``-th (0-based) message of ``msg_type``.

    ``msg_type`` is a lowercase ``MsgType`` name ("add", "query", ...) or
    ``None`` to count every message.  ``delay_ms`` only matters for
    ``kind="delay"``.
    """

    kind: str
    at: int
    msg_type: str | None = None
    delay_ms: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.at < 0:
            raise ValueError(f"fault 'at' must be >= 0, got {self.at}")


class FaultPlan:
    """A fixed, per-peer schedule of fault events plus its fired log."""

    def __init__(self, events, *, lane: str = "", log_path: str | None = None):
        self.events = [e if isinstance(e, FaultEvent) else FaultEvent(**e)
                       for e in events]
        self.lane = lane
        self.log_path = log_path or os.environ.get(FAULT_LOG_ENV) or None
        self._lock = threading.Lock()
        self._seen: dict = {}              # msg_type name (or "") -> count
        self._pending = list(self.events)
        self.fired: list[dict] = []        # in-process record of fired events

    # -- serialization --------------------------------------------------------

    def encode(self) -> str:
        return json.dumps([dataclasses.asdict(e) for e in self.events])

    @classmethod
    def decode(cls, spec: str, *, lane: str = "",
               log_path: str | None = None) -> "FaultPlan":
        return cls(json.loads(spec), lane=lane, log_path=log_path)

    @classmethod
    def from_env(cls, lane: str) -> "FaultPlan | None":
        """Plan for ``lane`` (``"<shard>.<replica>"``) from ``REPRO_FAULTS``,
        or None when the env carries nothing for it."""
        raw = os.environ.get(FAULTS_ENV)
        if not raw:
            return None
        spec = json.loads(raw).get(lane)
        if not spec:
            return None
        if not isinstance(spec, str):
            spec = json.dumps(spec)
        return cls.decode(spec, lane=lane)

    @classmethod
    def from_seed(cls, seed: int, *, n_events: int, horizon: int,
                  kinds=("delay", "drop"), msg_type: str | None = "query",
                  delay_ms: float = 50.0, lane: str = "",
                  log_path: str | None = None) -> "FaultPlan":
        """A seed-deterministic random schedule: ``n_events`` events drawn
        without replacement from message indices ``[0, horizon)``.  Same
        seed -> same schedule, always."""
        import numpy as np
        rng = np.random.default_rng(seed)
        ats = sorted(int(a) for a in
                     rng.choice(horizon, size=min(n_events, horizon),
                                replace=False))
        picks = rng.integers(0, len(kinds), size=len(ats))
        events = [FaultEvent(kind=kinds[int(k)], at=a, msg_type=msg_type,
                             delay_ms=delay_ms) for a, k in zip(ats, picks)]
        return cls(events, lane=lane, log_path=log_path)

    # -- matching + firing ----------------------------------------------------

    def on_message(self, msg_type_name: str) -> list[FaultEvent]:
        """Record one observed message; return the events it fires (each
        event fires exactly once).  Thread-safe: counts are shared across
        the worker's connection threads so the schedule tracks the peer's
        whole conversation, not one socket's."""
        fired: list[FaultEvent] = []
        with self._lock:
            n_typed = self._seen.get(msg_type_name, 0)
            n_any = self._seen.get("", 0)
            self._seen[msg_type_name] = n_typed + 1
            self._seen[""] = n_any + 1
            still: list[FaultEvent] = []
            for ev in self._pending:
                n = n_any if ev.msg_type is None else n_typed
                if (ev.msg_type in (None, msg_type_name)) and n == ev.at:
                    fired.append(ev)
                else:
                    still.append(ev)
            self._pending = still
            for ev in fired:
                self._log_locked(ev, msg_type_name)
        return fired

    def _log_locked(self, ev: FaultEvent, msg_type_name: str) -> None:
        rec = {"lane": self.lane, "kind": ev.kind, "at": ev.at,
               "msg_type": ev.msg_type, "on": msg_type_name,
               "n_fired": len(self.fired)}
        self.fired.append(rec)
        if not self.log_path:
            return
        line = json.dumps(rec, sort_keys=True) + "\n"
        # O_APPEND + one write per line keeps concurrent lanes' records
        # intact; flush+fsync BEFORE the fault acts so a kill can't eat
        # its own evidence
        fd = os.open(self.log_path, os.O_WRONLY | os.O_APPEND | os.O_CREAT,
                     0o644)
        try:
            os.write(fd, line.encode())
            os.fsync(fd)
        finally:
            os.close(fd)

    @staticmethod
    def sleep(ev: FaultEvent) -> None:
        time.sleep(ev.delay_ms / 1e3)


def read_fired_log(path: str) -> list[dict]:
    """Parse a fired-event log.  Returns records sorted by (lane, order of
    firing within the lane) — the cross-lane interleaving in the file is
    scheduler-dependent, the per-lane sequences are the deterministic
    artifact."""
    recs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                recs.append(json.loads(line))
    recs.sort(key=lambda r: (r.get("lane", ""), r.get("n_fired", 0)))
    return recs


def faults_env_value(plans: dict) -> str:
    """``{"<shard>.<replica>": FaultPlan | spec}`` -> REPRO_FAULTS value."""
    return json.dumps({lane: (p.encode() if isinstance(p, FaultPlan) else p)
                       for lane, p in plans.items()})


# -- client-side plan ---------------------------------------------------------

_client_plan: FaultPlan | None = None
_client_lock = threading.Lock()


def install_client_plan(plan: FaultPlan | None) -> None:
    """Install (or clear) the process-wide coordinator-side plan.  Only
    ``delay`` and ``drop`` act on the client: ``drop`` closes the lane's
    socket before the send, so the coordinator exercises its own
    mid-round failure paths on a deterministic schedule."""
    global _client_plan
    with _client_lock:
        _client_plan = plan


def client_events(msg_type_name: str) -> list[FaultEvent]:
    plan = _client_plan
    if plan is None:
        return []
    return plan.on_message(msg_type_name)
