"""Coordinator side of the shard transport: connections, fan-out, backends.

The port of ``repro.transport.client``: host code (sockets, selectors,
numpy) speaking the same wire protocol, so a port coordinator serves over
workers of either package.  The card meets the wire in ``RemoteShard``: a
query batch's band hashes and words arrive as the coordinator holds them
(``BandHashes``, ``QueryWords``, on the card after the fold) and leave as
host arrays, the hashes split into two uint32 planes (``split_u64``) and
the words as uint32.  Each is copied to the host once a batch, whatever
the number of shards: the wrappers keep the copy the first remote shard
made.

``ShardConnection`` is one framed TCP connection to a shard worker with a
blocking request/reply path (used for ADD, STATS, SNAPSHOT, SHUTDOWN).  The
query hot path instead goes through ``FanoutGroup``: the coordinator submits
one QUERY (or BRUTE) frame per worker, and the group drives every socket
with a ``selectors`` event loop — nonblocking gather-writes out, incremental
frame reassembly in — so all S workers compute their partials concurrently
and replies are drained in whatever order they land.  One wall-clock
deadline covers the whole fan-out: when it expires the group raises
``TransportTimeout`` naming the shards still pending, and a worker that dies
mid-flight (connection reset / EOF / ERROR frame) surfaces as
``WorkerError`` — a failed query is always an exception, never a hang.

``RemoteShard`` adapts one worker to the ``ShardBackend`` protocol
(``store.sharded``), so ``ShardedSketchStore`` runs identically over
in-process shards and tcp workers; ``connect_sharded`` builds the store for
a worker address list, optionally restoring coordinator state (gid maps,
partition) from a ``ShardedSketchStore.save`` snapshot directory.

Hedging (``HedgePolicy``): with one slow shard, the fan-out wall clock is
that shard's latency — its p99 becomes the query p99.  When a policy is
set, the group holds a second connection per shard and, if a shard's reply
hasn't landed by a skew-derived hedge delay, re-issues the *same* read
request on the twin connection; the first good reply wins and the loser is
settled by the existing machinery (a late duplicate reply is discarded by
seq pairing; a leg cut mid-frame is poisoned).  Only idempotent reads
(QUERY/BRUTE) are ever hedged — writes keep exactly-once semantics.  The
hedge delay for a shard derives from its PEERS' reply-skew histograms
(how much later than each round's fastest reply everyone else lands), and
the timer arms when the round's first reply arrives: skew — not absolute
latency — is what hedging can actually fix, it is immune to
coordinator-side pauses that delay a whole round together, and excluding
the shard's own history keeps a stalling shard (whose
queued-behind-the-stall rounds inflate its own percentiles) from vetoing
its own hedges.  A lane whose request was abandoned — the twin when its
hedge lost, the PRIMARY when a hedge won its slot — still has that request
in flight on its socket and is reconnected in place before its next use:
without this, one stalled read blacks out the primary lane for the whole
stall and every round issued meanwhile must win a fresh hedge race to
survive.  Hedging cannot change results: both legs ask the same worker the
same deterministic question, so whichever reply wins is bit-identical.
"""

from __future__ import annotations

import contextlib
import dataclasses
import selectors
import socket
import threading
import time

import numpy as np

from ..device import DEFAULT_DEVICE
from ..kernels.query_fused import BandHashes, QueryWords
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..store.planner import TopKPartial
from ..store.sharded import ShardedSketchStore
from . import faults as faults_mod
from . import wire
from .wire import Message, MsgType


class TransportError(RuntimeError):
    """Base for coordinator-visible transport failures."""


class WorkerError(TransportError):
    """A worker answered with ERROR, died, or broke the stream."""


class TransportTimeout(TransportError):
    """The fan-out deadline expired with replies still pending."""


class Overloaded(WorkerError):
    """The worker (or the streaming front) rejected the request instead of
    queueing it.  Provably clean: the request was NOT executed (an
    OVERLOADED reply arrives over an intact stream), so a retry within the
    caller's budget and deadline is always safe — this error never carries
    ``dirty`` or ``unknown_outcome``.  ``retry_after_s`` is the server's
    backoff hint (roughly one queue drain)."""

    def __init__(self, msg: str, *, retry_after_s: float = 0.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)
        self.retryable = True


class DeadlineExceeded(TransportError):
    """The request's absolute deadline passed — either before sending
    (checked coordinator-side) or on arrival at the worker, which dropped
    the work before computing.  Not retryable: the caller is gone."""


# -- ambient wire deadline ----------------------------------------------------
# The ``ShardBackend`` protocol (add/start_query/...) has no deadline
# parameter, and growing one through every layer would churn each backend
# for a field only the transport consumes.  Like the trace context, the
# deadline is ambient: callers wrap the query in ``deadline_scope`` and the
# remote backends stamp ``wire.DEADLINE_FIELD`` onto each outgoing request.

_ambient = threading.local()


def current_deadline() -> float | None:
    """Absolute deadline (unix seconds) of the enclosing scope, or None."""
    return getattr(_ambient, "deadline", None)


@contextlib.contextmanager
def deadline_scope(abs_deadline_s: float | None):
    """Set the ambient absolute deadline for this thread.  Scopes nest;
    an inner scope can only tighten (the effective deadline is the min)."""
    prev = current_deadline()
    eff = abs_deadline_s
    if eff is not None and prev is not None:
        eff = min(eff, prev)
    _ambient.deadline = eff if eff is not None else prev
    try:
        yield
    finally:
        _ambient.deadline = prev


def attach_deadline(fields: dict) -> dict:
    """Stamp the ambient deadline (if any) onto outgoing request fields."""
    dl = current_deadline()
    if dl is not None:
        fields[wire.DEADLINE_FIELD] = wire.deadline_us(dl)
    return fields


def check_deadline(what: str = "request") -> None:
    """Raise ``DeadlineExceeded`` when the ambient deadline already passed
    — don't put a frame on the wire for an answer nobody will read."""
    dl = current_deadline()
    if dl is not None and time.time() > dl:
        raise DeadlineExceeded(
            f"{what} deadline passed {time.time() - dl:.3f}s ago "
            "before the request was sent")


class RetryBudget:
    """Token bucket capping retry traffic as a fraction of primary traffic.

    Every primary request deposits ``ratio`` tokens; every retry — a hedge
    (timer- or failure-triggered), a replica-failover re-ask, or a
    ``StreamConfig.retries`` re-dispatch — spends one.  ``cap`` bounds the
    burst; ``floor_per_s`` trickles tokens in regardless of traffic so a
    quiet plane can still retry (without it, the first failure after an
    idle stretch on an empty bucket would be unretryable forever).

    One budget is shared across ALL retry sources of a plane (built in
    ``connect_sharded``): under a brownout the
    sources compete for the same bounded pool, so total retry traffic
    stays <= ``ratio`` x primary + the floor instead of each layer
    amplifying independently — the retry-storm cap.

    ``unlimited=True`` disables the cap (an unbudgeted baseline).
    """

    def __init__(self, *, ratio: float = 0.2, cap: float = 100.0,
                 floor_per_s: float = 1.0, unlimited: bool = False):
        self.ratio = float(ratio)
        self.cap = float(cap)
        self.floor_per_s = float(floor_per_s)
        self.unlimited = bool(unlimited)
        self._tokens = self.cap
        self._last = time.monotonic()
        self._lock = threading.Lock()
        reg = obs_metrics.default()
        self._g_tokens = reg.gauge("transport.retry_budget.tokens")
        self._g_tokens.set(self._tokens)
        self._m_spent = reg.counter("transport.retry_budget.spent")
        self._m_exhausted = reg.counter("transport.retry_budget.exhausted")
        self.n_primaries = 0
        self.n_spent = 0
        self.n_denied = 0

    def _refill_locked(self) -> None:
        now = time.monotonic()
        self._tokens = min(self.cap,
                           self._tokens + self.floor_per_s *
                           (now - self._last))
        self._last = now

    @property
    def tokens(self) -> float:
        return self._tokens

    def note_primary(self, n: int = 1) -> None:
        """Deposit for ``n`` primary requests (``ratio`` tokens each)."""
        with self._lock:
            self.n_primaries += n
            self._refill_locked()
            self._tokens = min(self.cap, self._tokens + self.ratio * n)
            self._g_tokens.set(self._tokens)

    def try_spend(self, n: int = 1) -> bool:
        """Take ``n`` tokens for a retry; False (and the retry must not
        happen) when the budget is exhausted."""
        if self.unlimited:
            self.n_spent += n
            self._m_spent.inc(n)
            return True
        with self._lock:
            self._refill_locked()
            if self._tokens >= n:
                self._tokens -= n
                self.n_spent += n
                self._m_spent.inc(n)
                self._g_tokens.set(self._tokens)
                return True
            self.n_denied += n
            self._m_exhausted.inc(n)
            return False


class CircuitBreaker:
    """Per-lane circuit breaker: closed -> open after ``fail_threshold``
    consecutive stream-level failures -> half-open probe after ``reset_s``.

    Failures that count are lane-health events — broken streams, timeouts
    (``mark_broken`` / ``note_timeout``) — not application ERROR replies,
    which arrive over an intact stream and say nothing about the lane.  A
    flapping replica's lane opens and is *skipped* by replica failover and
    primary selection until its half-open probe succeeds, so each flap
    costs one probe instead of one full lane-timeout per read.
    """

    CLOSED, OPEN, HALF_OPEN = 0, 1, 2
    _STATE_NAMES = {0: "closed", 1: "open", 2: "half-open"}

    def __init__(self, *, fail_threshold: int = 5, reset_s: float = 2.0,
                 name: str = ""):
        self.fail_threshold = int(fail_threshold)
        self.reset_s = float(reset_s)
        self.state = self.CLOSED
        self.failures = 0
        self._opened_t = 0.0
        self._probe_t = 0.0
        self._probing = False
        self._lock = threading.Lock()
        reg = obs_metrics.default()
        self._g_state = reg.gauge(f"transport.breaker.{name}.state") \
            if name else None
        self._m_opens = reg.counter("transport.breaker.opens")
        if self._g_state is not None:
            self._g_state.set(self.CLOSED)

    def _set_state(self, s: int) -> None:
        self.state = s
        if self._g_state is not None:
            self._g_state.set(s)

    @property
    def state_name(self) -> str:
        return self._STATE_NAMES[self.state]

    @property
    def healthy(self) -> bool:
        """Non-consuming: True only when fully closed (ordering hint for
        primary selection; ``allow`` is the send-time decision)."""
        return self.state == self.CLOSED

    def allow(self) -> bool:
        """May a request be sent on this lane now?  In half-open state only
        one probe is admitted at a time (a stuck probe is recycled after
        ``reset_s`` so a lost outcome cannot wedge the lane shut)."""
        with self._lock:
            if self.state == self.CLOSED:
                return True
            now = time.monotonic()
            if self.state == self.OPEN:
                if now - self._opened_t < self.reset_s:
                    return False
                self._set_state(self.HALF_OPEN)
                self._probing = False
            if self._probing and now - self._probe_t < self.reset_s:
                return False
            self._probing = True
            self._probe_t = now
            return True

    def record_success(self) -> None:
        with self._lock:
            self.failures = 0
            self._probing = False
            if self.state != self.CLOSED:
                self._set_state(self.CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            tripped = (self.state == self.HALF_OPEN
                       or (self.state == self.CLOSED
                           and self.failures >= self.fail_threshold))
            if tripped:
                self._set_state(self.OPEN)
                self._opened_t = time.monotonic()
                self._probing = False
                self._m_opens.inc()


def _partial_from(msg: Message) -> TopKPartial:
    return TopKPartial(np.asarray(msg["ids"], np.int64),
                       np.asarray(msg["scores"], np.float32),
                       np.asarray(msg["has"], bool))


@dataclasses.dataclass(frozen=True)
class HedgePolicy:
    """When and how to re-issue a slow shard's read on its twin connection.

    With ``delay_s`` unset, the hedge delay for a shard is
    ``multiplier * q(quantile)`` of its PEER connections' observed reply
    SKEW — lateness relative to each round's fastest reply — clamped to
    ``[min_delay_s, max_delay_s]``, with the timer armed when the current
    round's first reply lands.  No hedge fires until ``min_samples`` peer
    skews have been observed (an unwarmed plane has no signal to derive a
    delay from), and single-shard groups never hedge adaptively (no peers,
    no skew).  ``delay_s`` (seconds) short-circuits all of that: a fixed
    delay from round start, active from the first request (``0.0`` is
    valid and hedges immediately — a stress setting).
    """

    delay_s: float | None = None
    quantile: float = 0.9
    multiplier: float = 2.0
    min_delay_s: float = 0.0005
    max_delay_s: float = 1.0
    min_samples: int = 32


class ShardConnection:
    """One framed connection to a shard worker (blocking request/reply).

    Every request gets a fresh sequence number and only the reply echoing
    it is accepted; replies with older seqs are stale leftovers of a failed
    fan-out (the worker answered after the coordinator stopped waiting) and
    are discarded, so one failed broadcast cannot desynchronize the
    connection for every later request.
    """

    def __init__(self, address: tuple[str, int], *, timeout: float = 30.0,
                 max_payload: int = wire.MAX_PAYLOAD,
                 deadline_name: str = "timeout",
                 shard: int = -1, replica: int = 0):
        self.address = tuple(address)
        self.timeout = timeout
        self.deadline_name = deadline_name   # which knob set the deadline
        self.max_payload = max_payload
        # (shard, replica) lane labels: every WorkerError/TransportTimeout
        # raised for this connection names the exact lane (``_name``), and
        # the lane-labelled counters below let failover tooling tell WHICH
        # replica of WHICH shard is timing out / going stale — an R-way
        # plane is unoperable when all its lanes alias one counter series
        self.shard = shard
        self.replica = replica
        self._seq = 0
        self.broken: str | None = None     # why this conn is unusable
        # registry handles are bound once at construction (the disabled
        # registry hands out shared no-ops, so a disabled plane pays zero
        # lookup cost per request); per-connection plain tallies feed the
        # which-shard/which-seq error text
        reg = obs_metrics.default()
        self._m_stale = reg.counter("transport.client.stale_replies")
        self._m_timeout = reg.counter("transport.client.timeouts")
        self._m_bytes_out = reg.counter("transport.client.bytes_out")
        self._m_bytes_in = reg.counter("transport.client.bytes_in")
        lane = f".shard{shard}.replica{replica}" if shard >= 0 else ""
        self._m_stale_lane = reg.counter(
            f"transport.client.stale_replies{lane}") if lane else None
        self._m_timeout_lane = reg.counter(
            f"transport.client.timeouts{lane}") if lane else None
        self.n_stale = 0                   # stale replies discarded here
        self.n_timeouts = 0
        self.last_stale_seq: int | None = None
        # per-lane breaker: stream-level failures below feed it; replica
        # failover and primary selection consult it (state rides the
        # lane-labelled gauge so a dump shows WHICH lane is open)
        bname = f"shard{shard}.replica{replica}" if shard >= 0 else ""
        self.breaker = CircuitBreaker(name=bname)
        try:
            self.sock = socket.create_connection(self.address,
                                                 timeout=timeout)
        except OSError as e:
            raise WorkerError(f"cannot connect to worker at "
                              f"{address[0]}:{address[1]}: {e}") from e
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def next_seq(self) -> int:
        # seq 0 is reserved for connection-level worker errors (a decode
        # failure the worker cannot attribute to any request)
        self._seq = (self._seq + 1) & 0xFFFFFFFF or 1
        return self._seq

    def mark_broken(self, why: str) -> None:
        """Poison the connection (framing no longer trustworthy)."""
        self.broken = why
        self.breaker.record_failure()
        self.close()

    def check_usable(self) -> None:
        if self.broken:
            raise WorkerError(
                f"worker {self._name} connection unusable: {self.broken}")

    def note_stale(self, seq: int) -> None:
        """Record one discarded stale reply (registry + which-seq tally)."""
        self.n_stale += 1
        self.last_stale_seq = seq
        self._m_stale.inc()
        if self._m_stale_lane is not None:
            self._m_stale_lane.inc()

    def note_timeout(self) -> None:
        """Record one deadline expiry against this lane (aggregate + the
        (shard, replica)-labelled series failover logs correlate with)."""
        self.n_timeouts += 1
        self.breaker.record_failure()
        self._m_timeout.inc()
        if self._m_timeout_lane is not None:
            self._m_timeout_lane.inc()

    def _stale_note(self) -> str:
        if not self.n_stale:
            return ""
        return (f"; {self.n_stale} stale repl"
                f"{'y' if self.n_stale == 1 else 'ies'} discarded on this "
                f"connection (last stale seq={self.last_stale_seq})")

    def request(self, msg: Message) -> Message:
        """Send one frame, read its reply (raises on ERROR replies)."""
        self.check_usable()
        check_deadline(msg.type.name)
        # deterministic client-side faults (coordinator perspective): a
        # plan "drop" severs this lane's socket pre-send, so the failure
        # paths below run on a reproducible schedule
        for ev in faults_mod.client_events(msg.type.name.lower()):
            if ev.kind == "delay":
                faults_mod.FaultPlan.sleep(ev)
            else:        # sever the stream; the send below fails in-path
                try:
                    self.sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
        msg.seq = self.next_seq()
        try:
            wire.send_message(self.sock, msg, meter=self._m_bytes_out.inc)
            while True:
                reply = wire.recv_message(self.sock,
                                          max_payload=self.max_payload,
                                          meter=self._m_bytes_in.inc)
                if reply.seq == msg.seq:
                    break
                if reply.type == MsgType.ERROR and reply.seq == 0:
                    break      # connection-level worker error: surface it
                # stale reply from an abandoned fan-out: drop and re-read
                self.note_stale(reply.seq)
        except socket.timeout as e:
            # the frame may have been cut mid-send or mid-read; seq pairing
            # only recovers frame-aligned streams, so poison the connection
            self.note_timeout()
            self.mark_broken(f"timed out mid-{msg.type.name} seq={msg.seq}")
            raise TransportTimeout(
                f"worker {self._name} timed out after {self.timeout}s "
                f"({self.deadline_name}) "
                f"({msg.type.name} seq={msg.seq}{self._stale_note()})") from e
        except (wire.WireError, OSError) as e:
            self.mark_broken(f"stream failed during {msg.type.name} "
                             f"seq={msg.seq}: {type(e).__name__}")
            raise WorkerError(
                f"worker {self._name} failed during {msg.type.name} "
                f"seq={msg.seq}: {type(e).__name__}: {e}"
                f"{self._stale_note()}") from e
        return self._check(reply)

    def _check(self, reply: Message) -> Message:
        # a reply may carry the worker's finished trace spans next to the
        # echoed seq — fold them into this process's tracer so coordinator
        # and worker legs stitch into one trace
        blob = reply.fields.get(wire.TRACE_SPANS_FIELD)
        if blob:
            obs_trace.default().absorb_json(blob)
        if reply.type == MsgType.OVERLOADED:
            # the stream is intact and the worker provably did not execute
            # the request — lane-healthy for the breaker, clean to retry
            self.breaker.record_success()
            reason = reply.fields.get("reason", "admission")
            if reason == "expired":
                raise DeadlineExceeded(
                    f"worker {self._name} dropped the request: its "
                    f"deadline passed before computing (seq={reply.seq})")
            raise Overloaded(
                f"worker {self._name} shed the request at its admission "
                f"gate (depth {reply.fields.get('gate_depth', '?')}/"
                f"{reply.fields.get('gate_limit', '?')}, seq={reply.seq})",
                retry_after_s=int(reply.fields.get("retry_after_us", 0))
                / 1e6)
        if reply.type == MsgType.ERROR:
            err = WorkerError(f"worker {self._name}: {reply['error']} "
                              f"(seq={reply.seq}{self._stale_note()})")
            # worker says the failed op mutated its store (ADD landed
            # partially): the coordinator must not treat a retry as safe
            err.dirty = bool(reply.fields.get("dirty", 0))
            # an ERROR reply arrives over an intact stream, so unless the
            # worker said dirty, the failed op provably did NOT mutate its
            # store — which is why this error carries no ``unknown_outcome``
            # flag and a clean validation failure never poisons the plane
            # (the write-path decision in ``ShardedSketchStore._scatter``
            # keys off dirty/unknown_outcome)
            raise err
        self.breaker.record_success()
        return reply

    def reconnect(self) -> None:
        """Replace the socket in place: same worker, fresh stream, fresh
        seq space, ``broken`` cleared.  Object identity is preserved so
        every holder of this connection (``RemoteShard``, fan-out maps,
        skew histograms) sees the fresh lane without rebinding.  Used by
        the fan-out's dirty-lane hygiene: a lane abandoned mid-request
        still has a worker thread serving a question nobody will read —
        possibly sitting in the very stall that was hedged around — and
        reusing it would queue the next request behind exactly the
        latency hedging exists to cut."""
        self.close()
        try:
            self.sock = socket.create_connection(self.address,
                                                 timeout=self.timeout)
        except OSError as e:
            raise WorkerError(f"cannot reconnect to worker at "
                              f"{self.address[0]}:{self.address[1]}: "
                              f"{e}") from e
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._seq = 0
        self.broken = None

    @property
    def _name(self) -> str:
        if self.shard >= 0:
            return (f"shard {self.shard} replica {self.replica} at "
                    f"{self.address[0]}:{self.address[1]}")
        return f"{self.address[0]}:{self.address[1]}"

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class _Pending:
    """Handle for one in-flight fan-out request.

    ``decode`` turns the reply message into the caller's value (a partial
    for QUERY/BRUTE, a row count for ADD).  ``reset_on_error`` is the query
    path's behavior: a failed take abandons the sibling replies so the next
    round starts clean.  The write path passes ``False`` — it consumes
    every pending of the round itself, because the poison decision needs
    ALL per-shard outcomes, not just the first failure.
    """

    lazy = False          # remote work runs whether or not result() is read

    def __init__(self, group: "FanoutGroup", conn: ShardConnection, *,
                 decode=_partial_from, reset_on_error: bool = True):
        self._group = group
        self._conn = conn
        self._decode = decode
        self._reset_on_error = reset_on_error

    def result(self):
        self._group.flush()
        return self._decode(self._group.take(
            self._conn, reset_on_error=self._reset_on_error))

    @property
    def latency_s(self) -> float | None:
        """Seconds from fan-out start to this shard's reply landing — the
        per-shard skew signal (None until the reply has arrived)."""
        return self._group._reply_lat.get(self._conn)


class FanoutGroup:
    """Nonblocking broadcast/gather over a set of shard connections.

    ``submit`` queues one outgoing frame per connection; the first
    ``result()``/``flush()`` drives every socket through one ``selectors``
    loop under a single deadline.  Sockets are nonblocking only inside the
    loop, so the blocking request path stays usable between fan-outs.

    With a ``HedgePolicy`` and per-shard twin connections (``hedge_conns``),
    a submitted request marked ``hedgeable`` may be re-issued on the twin
    when its reply is late (see the module docstring for the semantics).
    """

    def __init__(self, conns: list[ShardConnection], *,
                 timeout: float = 30.0, hedge: HedgePolicy | None = None,
                 hedge_conns: dict[ShardConnection, ShardConnection]
                 | None = None,
                 deadline_name: str = "timeout",
                 budget: RetryBudget | None = None):
        self.conns = list(conns)
        self.timeout = timeout
        self.hedge = hedge
        # the plane-wide retry budget: submits deposit, hedges (timer- and
        # failure-triggered) spend; replica failover and stream retries
        # share this same bucket (see RetryBudget)
        self.budget = budget if budget is not None else RetryBudget()
        self._twin = dict(hedge_conns or {})
        self._deadline_name = deadline_name
        self._out: dict[ShardConnection, list] = {}     # pending send buffers
        self._out_total: dict[ShardConnection, int] = {}
        self._in: dict[ShardConnection, bytearray] = {}
        self._want: dict[ShardConnection, int] = {}     # expected reply seq
        self._replies: dict[ShardConnection, Message] = {}
        self._msgs: dict[ShardConnection, Message] = {}  # hedgeable, per round
        # legs that may fail WITHOUT killing the round (replicated writes:
        # one dead replica degrades redundancy, the sibling legs complete);
        # a tolerant leg's failure is parked here and surfaced at take()
        self._tolerant: set[ShardConnection] = set()
        self._leg_errors: dict[ShardConnection, BaseException] = {}
        self._round_error: BaseException | None = None  # why the round died
        reg = obs_metrics.default()
        self._m_timeout = reg.counter("transport.client.timeouts")
        self._m_bytes_out = reg.counter("transport.client.bytes_out")
        self._m_bytes_in = reg.counter("transport.client.bytes_in")
        self._m_hedges = reg.counter("transport.client.hedges")
        self._m_hedge_wins = reg.counter("transport.client.hedge_wins")
        self._m_redials = reg.counter("transport.client.lane_redials")
        # lanes (twin OR primary) whose last request was abandoned
        # mid-flight: the worker is still serving that request on the
        # socket, so the lane is reconnected before its next use (see
        # _redial).  Primaries go dirty when a hedge wins their slot;
        # twins when their hedge loses or the round dies under them.
        self._dirty: set[ShardConnection] = set()
        self._h_round = reg.histogram("transport.client.fanout")
        self._round_t0 = 0.0               # when the current round started
        self._reply_lat: dict[ShardConnection, float] = {}
        # private per-shard reply-SKEW histograms — each unhedged round
        # records how much later than the round's fastest reply each shard
        # landed.  Owned by THIS group (not the registry) so another plane
        # in the same process cannot pollute the signal the hedge delay is
        # derived from; absolute latencies live in the registry's
        # ``query.shard<i>.partial`` instead
        self._lat_h = {c: obs_metrics.Histogram(f"fanout.skew.{i}")
                       for i, c in enumerate(self.conns)}
        self.n_hedges = 0                  # hedges fired (plain tallies)
        self.n_hedge_wins = 0              # hedges whose reply won the slot
        self.n_redials = 0                 # abandoned lanes reconnected

    def submit(self, conn: ShardConnection, msg: Message, *,
               decode=_partial_from, reset_on_error: bool = True,
               hedgeable: bool = False, tolerate: bool = False,
               keep_round_on_error: bool = False) -> _Pending:
        """Queue one outgoing frame.  ``tolerate`` marks the leg as allowed
        to fail without killing the round (its failure is surfaced at its
        own ``take`` instead — replicated writes use this so one dead
        replica costs redundancy, not the plane).  ``keep_round_on_error``
        makes a submit-phase failure clean up only THIS leg's slots, so a
        replica set can retry the submit on a sibling lane without
        abandoning everything already queued this round."""
        if conn in self._out or conn in self._replies:
            raise TransportError("one outstanding fan-out request per shard")
        if not self._out and not self._replies:
            self._round_error = None      # a fresh round: forget old failures
            self._reply_lat.clear()
            self._msgs.clear()
            self._tolerant.clear()
            self._leg_errors.clear()
        check_deadline(msg.type.name)
        for ev in faults_mod.client_events(msg.type.name.lower()):
            if ev.kind == "delay":
                faults_mod.FaultPlan.sleep(ev)
            else:                  # sever the lane pre-send (deterministic)
                try:
                    conn.sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
        self.budget.note_primary()
        try:
            # a dirty lane (its last request was abandoned to a hedged win
            # or a dead round) is reconnected before carrying new traffic;
            # see _redial for why reuse would defeat the hedge
            if conn in self._dirty and not self._redial(conn):
                raise WorkerError(
                    f"worker {conn._name} unreachable while redialing a "
                    "lane with an abandoned request in flight")
            conn.check_usable()
            msg.seq = conn.next_seq()
            self._want[conn] = msg.seq
            self._out[conn] = [memoryview(b) if not isinstance(b, memoryview)
                               else b for b in wire.encode_message(msg)]
            self._out_total[conn] = sum(b.nbytes for b in self._out[conn])
            self._in[conn] = bytearray()
            # only idempotent reads are ever eligible: the write path never
            # passes hedgeable=True, so a retry can't double-index a batch
            if hedgeable and self.hedge is not None \
                    and self._twin.get(conn) is not None:
                self._msgs[conn] = msg
            if tolerate:
                self._tolerant.add(conn)
        except BaseException:
            if keep_round_on_error:
                # drop only this leg; siblings already queued stay live
                self._out.pop(conn, None)
                self._out_total.pop(conn, None)
                self._in.pop(conn, None)
                self._want.pop(conn, None)
                self._msgs.pop(conn, None)
            else:
                self.reset()  # abandon siblings already queued this round
            raise
        return _Pending(self, conn, decode=decode,
                        reset_on_error=reset_on_error)

    def take(self, conn: ShardConnection, *,
             reset_on_error: bool = True) -> Message:
        leg_err = self._leg_errors.pop(conn, None)
        if leg_err is not None:
            # this tolerant leg failed mid-round while its siblings went on
            # to complete; after its frame hit the wire nobody can prove
            # whether the worker processed the request
            err = WorkerError(
                f"worker {conn._name} failed mid-fan-out: "
                f"{type(leg_err).__name__}: {leg_err}")
            err.unknown_outcome = True
            raise err from leg_err
        if conn not in self._replies:
            if self._round_error is None:
                raise TransportError(
                    f"no reply pending for worker {conn._name} "
                    "(already taken, or never submitted this round)")
            # this pending's round already died in flush() (stream break /
            # timeout): every sibling surfaces the same failure instead of
            # a bare KeyError — and nobody can tell whether the worker
            # processed the request before the stream broke
            err = WorkerError(
                f"worker {conn._name}: fan-out round failed before its "
                f"reply was read ({type(self._round_error).__name__}: "
                f"{self._round_error})")
            err.unknown_outcome = True
            raise err from self._round_error
        try:
            return conn._check(self._replies.pop(conn))
        except WorkerError:
            if reset_on_error:
                # the round is abandoned: drop sibling replies so the next
                # round starts clean instead of tripping the outstanding
                # guard (the write path instead consumes every reply)
                self.reset()
            raise

    def reset(self) -> None:
        """Drop every in-flight slot of the current (failed) round."""
        self._out.clear()
        self._out_total.clear()
        self._in.clear()
        self._replies.clear()
        self._msgs.clear()
        self._tolerant.clear()
        self._leg_errors.clear()

    # -- membership (replica failover rewires lanes between rounds) ----------
    def set_twin(self, primary: ShardConnection,
                 twin: ShardConnection | None) -> None:
        """Point ``primary``'s hedge twin at ``twin`` (None removes it).
        A replicated plane wires each shard's twin to ANOTHER replica's
        connection, so a hedge is a failover to a different machine —
        bit-identical replies either way, since replicas hold the same
        rows (writes fan out to all lanes before any later read)."""
        if twin is None:
            self._twin.pop(primary, None)
        else:
            self._twin[primary] = twin

    def adopt_conn(self, conn: ShardConnection) -> None:
        """Add a connection to the group (a resynced replica rejoining):
        it gets a skew histogram and the blocking-mode restore in flush."""
        if conn not in self.conns:
            self.conns.append(conn)
            self._lat_h[conn] = obs_metrics.Histogram(
                f"fanout.skew.{len(self.conns) - 1}")

    def retire_conn(self, conn: ShardConnection) -> None:
        """Remove a connection from the group (its lane went down); twin
        mappings through it are dropped — callers re-wire via set_twin."""
        if conn in self.conns:
            self.conns.remove(conn)
        self._lat_h.pop(conn, None)
        self._dirty.discard(conn)
        self._twin.pop(conn, None)
        for p, t in list(self._twin.items()):
            if t is conn:
                del self._twin[p]

    def ensure_clean(self, conn: ShardConnection) -> None:
        """Make a lane usable for a blocking request: redial it if it was
        poisoned or abandoned mid-request (the read-failover path calls
        this before re-asking a sibling replica).  Raises ``WorkerError``
        when the worker is unreachable."""
        if conn.broken or conn in self._dirty:
            if not self._redial(conn):
                raise WorkerError(
                    f"worker {conn._name} unreachable while redialing")

    def _hedge_delay(self, conn: ShardConnection) -> float | None:
        """Seconds until ``conn``'s request may hedge, or None (never)."""
        p = self.hedge
        if p is None or conn not in self._msgs:
            return None                  # no policy / not a hedgeable read
        if p.delay_s is not None:
            return max(float(p.delay_s), 0.0)
        # the delay derives from reply SKEW — how much later than its
        # round's first reply each shard lands — and only from the PEER
        # connections' skew, never conn's own.  Absolute latencies are the
        # wrong signal twice over: a coordinator-side pause (GC, a compile,
        # a scheduler hiccup) delays every reply of a round together and
        # would inflate an absolute-latency percentile into a delay that
        # never fires, and a stalling shard queues the rounds behind each
        # stall on its own socket, so its own history grows until it vetoes
        # its own hedges.  Peer skew is immune to both.  (Single-shard
        # groups have no peers, hence no skew signal: adaptive mode never
        # hedges them — set delay_s to hedge a lone shard.)
        hists = [h for c, h in self._lat_h.items() if c is not conn]
        total = sum(h.count for h in hists)
        if not hists or total < p.min_samples:
            return None                  # no skew signal yet: don't guess
        counts = [sum(h.counts[i] for h in hists)
                  for i in range(len(hists[0].counts))]
        lat = obs_metrics._quantile_from_counts(counts, total, p.quantile)
        return min(max(p.multiplier * lat, p.min_delay_s), p.max_delay_s)

    def _redial(self, conn: ShardConnection) -> bool:
        """Reconnect an abandoned lane in place; False when the worker is
        unreachable right now.

        A lane whose last request was abandoned (its hedge race was lost,
        or a hedge won its slot) still has that request in flight: the
        worker's thread for the socket is executing it — and may be
        sitting in the very stall that was hedged around — so the lane's
        next request would queue behind exactly the latency hedging
        exists to cut.  This matters most for PRIMARIES: without the
        redial, one stalled read blacks the primary lane out for the full
        stall, every round issued meanwhile must hedge to survive, and
        each of those hedges gives the twin lane its own chance to stall
        — the tail failure becomes a correlated burst.  Reconnecting the
        abandoned lane ends the blackout at the first hedged win.  A lane
        cut mid-frame (poisoned) is also recovered here: the fresh stream
        starts frame-aligned with a fresh seq space."""
        try:
            conn.reconnect()
        except TransportError:
            return False              # worker unreachable: lane stays dirty
        self._dirty.discard(conn)
        self.n_redials += 1
        self._m_redials.inc()
        return True

    # -- the event loop ------------------------------------------------------
    def flush(self) -> None:
        """Drive all submitted requests to completion or raise.  A failed
        fan-out clears every in-flight slot (including replies that did
        land), so the group stays usable after the exception surfaces —
        except connections whose request frame was cut mid-send, which are
        poisoned (``ShardConnection.broken``) and raise on further use."""
        try:
            self._flush()
        except BaseException as e:
            # after frames hit the wire nobody can prove which workers
            # processed their request — writes must treat this as a
            # maybe-wrote failure (``unknown_outcome``), and siblings of the
            # dead round re-raise it from take()
            e.unknown_outcome = True
            self._round_error = e
            self._replies.clear()
            raise

    def _flush(self) -> None:
        pending = set(self._out)
        if not pending:
            return
        self._round_t0 = time.perf_counter()
        # the caller's absolute deadline (if any) can only tighten the
        # round's wall clock — a round that cannot answer in time should
        # fail at the deadline, not keep S workers busy for the full knob
        budget_s = self.timeout
        amb = current_deadline()
        if amb is not None:
            budget_s = min(budget_s, max(amb - time.time(), 0.0))
        deadline = time.monotonic() + budget_s
        # hedge bookkeeping, all per-round: when a shard's request hedges,
        # ``owner`` maps the fired twin leg back to its primary and
        # ``fired`` the primary to its twin — two legs, one reply slot
        owner: dict[ShardConnection, ShardConnection] = {}
        fired: dict[ShardConnection, ShardConnection] = {}
        hedge_at: dict[ShardConnection, float] = {}
        unhedged_done: dict[ShardConnection, float] = {}
        # a FIXED delay arms at round start; the adaptive (skew-derived)
        # delay arms when the round's FIRST reply lands — "this shard is
        # late relative to its peers" only exists once a peer has answered,
        # and a round-start timer would misfire on every coordinator-side
        # pause that delays the whole round together
        if self.hedge is not None and self.hedge.delay_s is not None:
            now = time.monotonic()
            for conn in pending:
                d = self._hedge_delay(conn)
                if d is not None:
                    hedge_at[conn] = now + d
        sel = selectors.DefaultSelector()

        def _cleanup_leg(conn: ShardConnection) -> None:
            try:
                sel.unregister(conn.sock)
            except (KeyError, ValueError):
                pass
            pending.discard(conn)
            self._out.pop(conn, None)
            self._out_total.pop(conn, None)
            self._in.pop(conn, None)

        def _settle_loser(loser: ShardConnection, why: str) -> None:
            # the other leg won this slot: a loser cut mid-frame can no
            # longer be framed and is poisoned; fully-sent-nothing-read
            # stays usable — its late reply is a frame-aligned stale the
            # seq pairing discards on the connection's next use
            left = sum(b.nbytes for b in self._out.get(loser, []))
            if 0 < left < self._out_total.get(loser, 0):
                loser.mark_broken(f"request frame cut mid-send by {why}")
            elif len(self._in.get(loser, b"")) and not left:
                loser.mark_broken(f"reply frame partially consumed by {why}")
            _cleanup_leg(loser)

        def _fire_hedge(primary: ShardConnection) -> bool:
            twin = self._twin.get(primary)
            msg = self._msgs.get(primary)
            if twin is None or msg is None:
                return False
            # every hedge — timer-fired tail cut or failure-triggered
            # failover — is retry traffic and draws from the shared budget;
            # an exhausted budget means the hedge simply does not fire (the
            # primary leg keeps its chance, or the round fails and the
            # caller's budgeted retry path takes over)
            if not self.budget.try_spend():
                return False
            if (twin.broken or twin in self._dirty) \
                    and not self._redial(twin):
                return False          # worker unreachable: no hedge now
            # same request, re-encoded under the twin's own seq space; the
            # worker serves both connections, so whichever leg's reply
            # lands first carries the identical deterministic answer
            msg.seq = twin.next_seq()
            self._want[twin] = msg.seq
            self._out[twin] = [b if isinstance(b, memoryview)
                               else memoryview(b)
                               for b in wire.encode_message(msg)]
            self._out_total[twin] = sum(b.nbytes for b in self._out[twin])
            self._in[twin] = bytearray()
            twin.sock.setblocking(False)
            sel.register(twin.sock, selectors.EVENT_WRITE, twin)
            pending.add(twin)
            owner[twin] = primary
            fired[primary] = twin
            self.n_hedges += 1
            self._m_hedges.inc()
            return True

        def _leg_failed(conn: ShardConnection, err: BaseException) -> bool:
            """One leg's stream broke mid-round.  True when the slot
            survives on the other leg (possibly a hedge fired right now) —
            the failed leg is poisoned and retired; False when the failure
            is terminal and the round must die."""
            primary = owner.get(conn)
            if primary is not None:          # the hedge leg died: drop it
                conn.mark_broken(
                    f"hedge leg failed: {type(err).__name__}")
                _cleanup_leg(conn)
                return primary in pending or primary in self._replies
            twin = fired.get(conn)
            live = twin is not None and twin in pending
            if not live and fired.get(conn) is None:
                live = _fire_hedge(conn)     # failure-triggered hedge
            if not live:
                return False
            conn.mark_broken(
                f"stream failed mid-fan-out: {type(err).__name__}")
            _cleanup_leg(conn)
            return True

        try:
            for conn in pending:
                conn.sock.setblocking(False)
                sel.register(conn.sock, selectors.EVENT_WRITE, conn)
            while pending:
                now = time.monotonic()
                budget = deadline - now
                if budget <= 0:
                    waiting = {owner.get(c, c) for c in pending}
                    if waiting and waiting <= self._tolerant:
                        # every leg still pending opted into per-leg
                        # failure: time each out individually (lane down,
                        # outcome unknown) and let the round complete on
                        # the replies that DID land
                        for c in sorted(waiting, key=id):
                            c.note_timeout()
                            e = TransportTimeout(
                                f"worker {c._name} timed out after "
                                f"{self.timeout}s ({self._deadline_name}) "
                                f"(seq={self._want.get(c)})")
                            self._leg_errors[c] = e
                            c.mark_broken("timed out mid-fan-out")
                            _cleanup_leg(c)
                        for c in list(pending):   # stray hedge legs
                            _cleanup_leg(c)
                        continue
                    self._m_timeout.inc()
                    for c in waiting:
                        if c._m_timeout_lane is not None:
                            c._m_timeout_lane.inc()
                    names = sorted(f"{c._name} (seq={self._want.get(c)})"
                                   for c in waiting)
                    raise TransportTimeout(
                        f"fan-out timed out after {self.timeout}s "
                        f"({self._deadline_name}) waiting on "
                        f"{len(names)} shard(s): {', '.join(names)}")
                for c in [c for c, t in hedge_at.items()
                          if t <= now and c in pending and c not in fired]:
                    if not _fire_hedge(c):
                        hedge_at.pop(c, None)      # twin unusable: give up
                nxt = min((t for c, t in hedge_at.items()
                           if c in pending and c not in fired),
                          default=None)
                if nxt is not None:
                    budget = min(budget, max(nxt - now, 0.0) + 1e-4)
                for key, _ in sel.select(budget):
                    conn = key.data
                    if conn not in pending:
                        continue
                    try:
                        if self._out[conn]:
                            self._pump_send(sel, conn)
                        else:
                            self._pump_recv(sel, conn)
                    # WorkerError covers EOF mid-reply (the worker process
                    # died cleanly) — a leg failure like any stream break,
                    # so a killed replica's read fails over in-round via
                    # the failure-triggered hedge instead of killing the
                    # whole round
                    except (wire.WireError, WorkerError) as e:
                        if not _leg_failed(conn, e):
                            if conn in self._tolerant:
                                self._leg_errors[conn] = e
                                conn.mark_broken(
                                    f"stream failed mid-fan-out: "
                                    f"{type(e).__name__}")
                                _cleanup_leg(conn)
                                continue
                            if isinstance(e, WorkerError):
                                raise
                            raise WorkerError(
                                f"worker {conn._name} broke the stream: "
                                f"{type(e).__name__}: {e}") from e
                        continue
                    except OSError as e:
                        if not _leg_failed(conn, e):
                            if conn in self._tolerant:
                                self._leg_errors[conn] = e
                                conn.mark_broken(
                                    f"connection failed mid-fan-out: "
                                    f"{type(e).__name__}")
                                _cleanup_leg(conn)
                                continue
                            raise WorkerError(
                                f"worker {conn._name} connection failed: "
                                f"{e}") from e
                        continue
                    if conn in self._replies:
                        _cleanup_leg(conn)
                        primary = owner.get(conn)
                        if primary is not None:      # the hedge leg won
                            self._replies[primary] = self._replies.pop(conn)
                            self._reply_lat[primary] = \
                                self._reply_lat.pop(conn)
                            self.n_hedge_wins += 1
                            self._m_hedge_wins.inc()
                            if primary in pending:
                                # the primary's abandoned request is still
                                # being served (likely mid-stall): retire
                                # the whole lane so the NEXT round starts
                                # on a fresh one instead of queueing behind
                                # the remainder of the stall
                                self._dirty.add(primary)
                                _settle_loser(primary, "a hedged win")
                        else:
                            # only unhedged primary wins feed the skew
                            # signal (collected here, skews recorded once
                            # the round completes): a hedged win's latency
                            # includes the hedge delay and would inflate
                            # future delays
                            lat = self._reply_lat.get(conn)
                            if lat is not None and conn in self._lat_h:
                                unhedged_done[conn] = lat
                            twin = fired.get(conn)
                            if twin is not None and twin in pending:
                                # the worker is still serving the abandoned
                                # hedge on this lane: redial before reuse
                                self._dirty.add(twin)
                                _settle_loser(twin, "the primary winning")
                        if self.hedge is not None \
                                and self.hedge.delay_s is None \
                                and not hedge_at:
                            # first reply of the round landed: arm the
                            # skew timers for everyone still pending
                            now = time.monotonic()
                            for c in pending:
                                if c in owner:       # hedge legs never hedge
                                    continue
                                d = self._hedge_delay(c)
                                if d is not None:
                                    hedge_at[c] = now + d
            self._h_round.observe(time.perf_counter() - self._round_t0)
            if len(unhedged_done) > 1:
                # skew = lateness vs the round's fastest unhedged reply;
                # the 1us floor keeps the fastest shard's "zero" inside
                # the histogram's bucket range
                base = min(unhedged_done.values())
                for c, lat in unhedged_done.items():
                    self._lat_h[c].observe(max(lat - base, 1e-6))
        finally:
            # hedge legs still pending when the round ends (it died, or the
            # primary won) have abandoned requests in flight server-side
            self._dirty.update(c for c in pending if c in owner)
            sel.close()
            for conn in self.conns + list(self._twin.values()):
                try:
                    conn.sock.setblocking(True)
                    conn.sock.settimeout(conn.timeout)
                except OSError:
                    pass
            # a frame cut mid-send or mid-read leaves the stream unframed —
            # seq pairing only recovers frame-ALIGNED leftovers, so such
            # connections are poisoned instead of misparsing later frames.
            # (fully-unsent and fully-sent requests both stay in sync: the
            # worker either never sees the request or answers a reply the
            # seq discard handles.)
            for conn, bufs in self._out.items():
                left = sum(b.nbytes for b in bufs)
                if 0 < left < self._out_total.get(conn, 0):
                    conn.mark_broken(
                        "request frame cut mid-send by a failed fan-out")
            for conn in pending:
                if len(self._in.get(conn, b"")) and not self._out.get(conn):
                    conn.mark_broken(
                        "reply frame partially consumed by a failed fan-out")
            # a failed fan-out leaves no half-tracked state behind
            self._out.clear()
            self._out_total.clear()
            self._in.clear()

    def _pump_send(self, sel, conn: ShardConnection) -> None:
        bufs = self._out[conn]
        while bufs:
            try:
                sent = conn.sock.send(bufs[0])
            except BlockingIOError:
                return
            self._m_bytes_out.inc(sent)
            if sent < bufs[0].nbytes:
                bufs[0] = bufs[0].cast("B")[sent:]
                return
            bufs.pop(0)
        sel.modify(conn.sock, selectors.EVENT_READ, conn)

    def _pump_recv(self, sel, conn: ShardConnection) -> None:
        buf = self._in[conn]
        while True:
            try:
                chunk = conn.sock.recv(1 << 16)
            except BlockingIOError:
                return
            if not chunk:
                raise WorkerError(
                    f"worker {conn._name} closed the connection mid-query "
                    "(worker process died?)")
            self._m_bytes_in.inc(len(chunk))
            buf += chunk
            if self._try_complete(conn):
                return

    def _try_complete(self, conn: ShardConnection) -> bool:
        buf = self._in[conn]
        while True:
            if len(buf) < wire.HEADER_SIZE:
                return False
            mtype, seq, length, _ = wire.decode_header(
                bytes(buf[: wire.HEADER_SIZE]), max_payload=conn.max_payload)
            end = wire.HEADER_SIZE + length
            if len(buf) < end:
                return False
            if seq != self._want[conn] and \
                    not (mtype == MsgType.ERROR and seq == 0):
                conn.note_stale(seq)
                del buf[:end]      # stale reply from an abandoned fan-out
                continue
            if len(buf) > end:
                raise wire.ProtocolError("unexpected bytes after reply frame")
            # full frame validation (crc, payload decode) is wire's job —
            # one definition shared with the blocking path
            self._replies[conn] = wire.decode_frame(
                memoryview(buf)[:end], max_payload=conn.max_payload)
            self._reply_lat[conn] = time.perf_counter() - self._round_t0
            return True

    def close(self) -> None:
        for conn in self.conns:
            conn.close()
        for conn in self._twin.values():
            conn.close()


class RemoteShard:
    """``ShardBackend`` over one shard worker (see ``store.sharded``)."""

    def __init__(self, conn: ShardConnection, group: FanoutGroup,
                 hedge_conn: ShardConnection | None = None):
        self.conn = conn
        self.group = group
        self.hedge_conn = hedge_conn

    @staticmethod
    def _traced(fields: dict) -> dict:
        """Attach the ambient trace context (if any) and the ambient
        deadline as wire fields, so the worker's spans join the
        coordinator's trace and expired work can be dropped server-side.
        Reading the ambient stacks here is what keeps the ``ShardBackend``
        protocol unchanged."""
        ctx = obs_trace.current()
        if ctx is not None:
            fields[wire.TRACE_ID_FIELD] = ctx.trace_id
            fields[wire.TRACE_PARENT_FIELD] = ctx.span_id
        return attach_deadline(fields)

    # -- writes (blocking request/reply) ------------------------------------
    def add(self, sigs: np.ndarray) -> int:
        return int(self.conn.request(Message(
            MsgType.ADD, self._traced(
                {"rows": np.ascontiguousarray(sigs, np.int32)})))["n"])

    def add_packed(self, words: np.ndarray) -> int:
        return int(self.conn.request(Message(
            MsgType.ADD, self._traced(
                {"words": np.ascontiguousarray(words, np.uint32)})))["n"])

    # -- the write fan-out ---------------------------------------------------
    def start_add(self, batch: np.ndarray, *, packed: bool = False) -> _Pending:
        """Submit this shard's ADD slice; all shards index concurrently.

        ``reset_on_error=False``: the coordinator's scatter consumes every
        pending of the round — the partial-write poison decision needs all
        per-shard outcomes, not just the first failure.
        """
        field = {"words": np.ascontiguousarray(batch, np.uint32)} if packed \
            else {"rows": np.ascontiguousarray(batch, np.int32)}
        return self.group.submit(self.conn,
                                 Message(MsgType.ADD, self._traced(field)),
                                 decode=lambda m: int(m["n"]),
                                 reset_on_error=False)

    # -- the query fan-out ---------------------------------------------------
    # both reads are hedgeable: re-asking the same worker the same
    # deterministic question is idempotent, so a duplicate can only cost
    # compute, never change an answer or the store
    #
    # the hashes and words cross to the host here, through the batch's
    # wrappers: the first remote shard's ``host()`` makes the copy (a wait
    # for the card), every later shard reuses it
    def start_query(self, hashes: BandHashes, qwords: QueryWords,
                    top_k: int, mode: str) -> _Pending:
        lo, hi = wire.split_u64(hashes.host())
        return self.group.submit(self.conn, Message(MsgType.QUERY, self._traced({
            "hash_lo": lo, "hash_hi": hi,
            "qwords": np.ascontiguousarray(qwords.host(), np.uint32),
            "top_k": int(top_k), "mode": mode})), hedgeable=True)

    def start_brute(self, qwords: QueryWords, top_k: int) -> _Pending:
        return self.group.submit(self.conn, Message(MsgType.BRUTE, self._traced({
            "qwords": np.ascontiguousarray(qwords.host(), np.uint32),
            "top_k": int(top_k)})), hedgeable=True)

    # -- control -------------------------------------------------------------
    def stats(self) -> dict:
        return dict(self.conn.request(Message(MsgType.STATS, {})).fields)

    def save(self, path: str) -> None:
        self.conn.request(Message(MsgType.SNAPSHOT, {"path": str(path)}))

    def shutdown(self) -> None:
        """Graceful worker exit (acked before the process leaves serve)."""
        self.conn.request(Message(MsgType.SHUTDOWN, {}))
        self.close()

    def close(self) -> None:
        self.conn.close()
        if self.hedge_conn is not None:
            self.hedge_conn.close()


def shutdown_plane(store, handles, *, join_timeout: float = 10.0) -> bool:
    """Stop a shard plane: graceful SHUTDOWN per remote shard, close the
    store's backends, reap worker processes.  The one definition of the
    teardown order (service close, benchmarks, and tests all use it).

    Joins only wait when every shutdown was acked (a hung worker should
    not stall the caller); ``terminate`` no-ops on cleanly-exited workers.
    Safe on inproc planes (no shutdown legs, no handles).  Returns whether
    every remote shard acked its SHUTDOWN.
    """
    clean = True
    for sh in getattr(store, "shards", []):
        if hasattr(sh, "shutdown"):
            try:
                sh.shutdown()
            except Exception:
                clean = False          # worker already dead or unreachable
    store.close()
    for h in handles:
        if clean:
            h.join(join_timeout)
        h.terminate()
    return clean


def connect_sharded(addresses, cfg=None, *, snapshot_dir: str | None = None,
                    partition: str = "round_robin", query_impl: str = "auto",
                    timeout: float = 30.0,
                    hedge: "HedgePolicy | bool | None" = None,
                    budget: RetryBudget | None = None,
                    device: str = DEFAULT_DEVICE,
                    ) -> ShardedSketchStore:
    """Build a tcp-backed ``ShardedSketchStore`` over worker ``addresses``,
    its coordinator on ``device`` (where a query batch is folded once).

    Fresh plane: pass the workers' ``StoreConfig`` as ``cfg``.  Snapshot
    boot: pass the ``ShardedSketchStore.save`` directory the workers were
    spawned from — coordinator state (cfg, partition, gid maps) is restored
    from its manifest and must describe ``len(addresses)`` shards.

    ``query_impl`` steers only the COORDINATOR's one broadcast band-hash
    fold; each worker's probe/score legs follow the knob it was spawned
    with (``spawn_workers(query_impl=...)``).

    ``timeout`` is the effective query deadline — ``SearchConfig`` plumbs
    it here as ``query_timeout_s``, and ``TransportTimeout`` messages name
    it.  ``hedge`` enables hedged reads: a ``HedgePolicy`` (or ``True``
    for the defaults) opens a second connection per worker for the group's
    late-reply re-issues.  ``budget`` is the plane's shared ``RetryBudget``
    (None builds the default) — hedges, failovers, and stream retries all
    draw from it.
    """
    if hedge is True:
        hedge = HedgePolicy()
    elif hedge is False:
        hedge = None
    conns: list[ShardConnection] = []
    twins: dict[ShardConnection, ShardConnection] = {}
    try:
        for i, a in enumerate(addresses):
            conns.append(ShardConnection(a, timeout=timeout,
                                         deadline_name="query_timeout_s",
                                         shard=i))
        if hedge is not None:
            for c in conns:
                twins[c] = ShardConnection(c.address, timeout=timeout,
                                           deadline_name="query_timeout_s",
                                           shard=c.shard)
        group = FanoutGroup(conns, timeout=timeout, hedge=hedge,
                            hedge_conns=twins,
                            deadline_name="query_timeout_s",
                            budget=budget)
        backends = [RemoteShard(c, group, hedge_conn=twins.get(c))
                    for c in conns]
        if snapshot_dir is not None:
            store = ShardedSketchStore.load(snapshot_dir, backends=backends,
                                            query_impl=query_impl,
                                            device=device)
        elif cfg is None:
            raise ValueError("connect_sharded needs cfg or snapshot_dir")
        else:
            store = ShardedSketchStore(cfg, len(backends),
                                       partition=partition,
                                       query_impl=query_impl,
                                       backends=backends, device=device)
        # the coordinator's gid maps and the workers' stores must describe
        # the same items — a coordinator connected without its snapshot (or
        # to the wrong workers) would otherwise return shard-LOCAL ids as
        # global answers with no error
        for i, b in enumerate(backends):
            size, want = int(b.stats()["size"]), store._gid_len[i]
            if size != want:
                raise WorkerError(
                    f"worker {conns[i]._name} holds {size} items but "
                    f"the coordinator's gid map has {want} — wrong "
                    "snapshot_dir (or none) for these workers?")
        return store
    except BaseException:
        for c in conns + list(twins.values()):  # no fd leak on failure
            c.close()
        raise
