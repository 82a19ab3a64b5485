"""Streaming query front end: single queries in, device batches out.

The port of ``repro.serve.stream``.  ``SimilaritySearchService`` answers
query batches; a serving front end sees one query at a time.
``StreamingQueryService`` bridges the two with an admission queue: callers
submit single queries and get a ``QueryTicket`` back at once, a coalescer
thread gathers compatible queries into batches, and a batch flushes when it
reaches ``max_batch`` OR its oldest query has waited ``max_delay_ms``,
whichever comes first.  Batches then run with ``depth`` in flight: batch
N+1's signing is launched on the card (CUDA launches return at once) while
batch N's shard fan-out, scoring and merge run, so the signing kernel and
the shard plane work at the same time.  ``_sign`` holds no host sync, so
the overlap is kept: on the fused path the signed words stay on the device
into the store's fold, and only the raw path (b = 1, 2 at the default
bands) copies its signatures to the host, when the batch is drained.

Exactness: sign, fold, probe, score and merge are all row-independent,
and a row's brute-force-fallback decision depends only on its own
candidates, so the answer for a query is bit-identical whether it rides a
coalesced batch, any pipeline depth, or a batch of one.  Mixed per-query
``top_k`` stays exact the same way: the batch asks the store for the max,
and a prefix of a longer ranking IS the shorter ranking.

Batch compatibility is by (layout, row shape, dtype).  An incompatible
arrival flushes the queue in front of it (FIFO order is never reordered,
so no ticket can be starved by later arrivals).  ``pad_pow2`` pads a
partial flush up to the next power of two by repeating the batch's first
row, as the reference does (there, to bound JAX's recompiles; here, for
the same knob and the same batches); rows are independent, so the padding
never changes an answer.

Over a mesh service, a coalesced batch's shape depends on each rank's
timing, so a collective issued inside the coalescer could wait forever:
the stream signs on the rank alone (``SketchEngine.local``, the same pi and
sigma), row for row the same words, and issues no collective.

Overload: ``max_queue`` bounds the admission queue, and a full queue sheds
the NEWEST arrival (its ticket comes back already rejected with
:class:`~repro_torch.transport.client.Overloaded` carrying a retry-after
hint), so admitted work is never reordered.  ``query_timeout_s`` gives each
ticket an absolute deadline that travels as the wire deadline of its
batch (the MAX over its tickets'); tickets whose deadline passes while
queued are dropped before signing.  Batch retries (``StreamConfig.retries``)
spend from the plane's shared ``RetryBudget``, honour a server's
``retry_after_s`` hint, and never fire past the batch deadline.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import threading
import time

import numpy as np

from ..device import as_host_sigs
from ..obs import metrics as obs_metrics
from ..transport.client import (DeadlineExceeded, Overloaded,
                                TransportError, deadline_scope)

FLUSH_REASONS = ("full", "deadline", "shape", "close")


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    max_batch: int = 256        # flush when this many compatible queries
    max_delay_ms: float = 2.0   # ... or when the oldest waited this long
    depth: int = 2              # in-flight batches (1 = serial, 2 = overlap)
    pad_pow2: bool = True       # pad partial batches to pow2 (module doc)
    top_k: int = 10             # default per-query top_k
    # transient-failure retries a batch query (reads are idempotent, so a
    # retry costs latency, never an answer).  On a replicated plane a
    # round that dies to a killed replica succeeds on retry once the
    # replica set has failed over
    retries: int = 0
    # admission bound (0 = unbounded): a full queue sheds the NEWEST
    # arrival with an already-rejected Overloaded ticket
    max_queue: int = 0
    # default per-ticket deadline (0 = none), overridable per submit; it
    # travels as the batch's wire deadline so workers drop expired work
    query_timeout_s: float = 0.0

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1 (got {self.max_batch})")
        if self.max_delay_ms < 0:
            raise ValueError(
                f"max_delay_ms must be >= 0 (got {self.max_delay_ms})")
        if self.depth < 1:
            raise ValueError(f"depth must be >= 1 (got {self.depth})")
        if self.retries < 0:
            raise ValueError(f"retries must be >= 0 (got {self.retries})")
        if self.max_queue < 0:
            raise ValueError(f"max_queue must be >= 0 (got {self.max_queue})")
        if self.query_timeout_s < 0:
            raise ValueError(f"query_timeout_s must be >= 0 "
                             f"(got {self.query_timeout_s})")


class QueryTicket:
    """One submitted query: resolves to ``(ids, scores)`` when its batch
    completes.  ``latency_s`` is admission-to-answer wall time."""

    def __init__(self, row: np.ndarray, layout: str, top_k: int,
                 deadline: float | None = None):
        self.row = row
        self.layout = layout
        self.top_k = top_k
        self.deadline = deadline   # absolute epoch seconds, None = no limit
        # admission-compatibility key: batches only coalesce rows the
        # signing kernel can stack into one array
        self.key = (layout, row.shape, row.dtype.str)
        self.t_submit = time.perf_counter()
        self.t_done: float | None = None
        self._ev = threading.Event()
        self._ids: np.ndarray | None = None
        self._scores: np.ndarray | None = None
        self._err: BaseException | None = None

    def _resolve(self, ids: np.ndarray, scores: np.ndarray) -> None:
        self._ids, self._scores = ids, scores
        self.t_done = time.perf_counter()
        self._ev.set()

    def _reject(self, err: BaseException) -> None:
        self._err = err
        self.t_done = time.perf_counter()
        self._ev.set()

    @property
    def done(self) -> bool:
        return self._ev.is_set()

    @property
    def latency_s(self) -> float | None:
        return None if self.t_done is None else self.t_done - self.t_submit

    def result(self, timeout: float | None = None):
        """Block for this query's ``(ids, scores)`` (each ``(top_k,)``).

        Re-raises the batch's failure if its dispatch or drain died."""
        if not self._ev.wait(timeout):
            raise TimeoutError("query still in flight")
        if self._err is not None:
            raise self._err
        return self._ids, self._scores


class StreamingQueryService:
    """Admission queue + pipelined batch execution over one service.

    One coalescer thread owns the whole flow (admission order == dispatch
    order == drain order, so FIFO fairness and exactness need no further
    locking): it collects a compatible FIFO prefix of the queue, launches
    its signing, and only fans out the oldest in-flight batch once
    ``depth`` batches are in flight, or as soon as the queue goes quiet.

    ``close`` flushes: every admitted query is answered before it returns
    (a query submitted after close is refused at once).
    """

    def __init__(self, service, cfg: StreamConfig | None = None):
        self.service = service
        self.cfg = cfg or StreamConfig()
        # over a mesh the ranks coalesce different batches: sign on the
        # rank alone, with no collective
        engine = getattr(service, "engine", None)
        self._sign = service._sign if getattr(engine, "mesh", None) is None \
            else functools.partial(service._sign, local=True)
        self._q: collections.deque[QueryTicket] = collections.deque()
        self._cond = threading.Condition()
        self._closed = False
        self._inflight: collections.deque = collections.deque()
        reg = obs_metrics.default()
        self._h_batch = reg.histogram("stream.batch")
        self._h_qwait = reg.histogram("stream.queue_wait")
        self._h_e2e = reg.histogram("stream.e2e")
        self._c_queries = reg.counter("stream.queries")
        self._c_retries = reg.counter("stream.retries")
        self._c_shed = reg.counter("stream.shed")
        self._c_expired = reg.counter("stream.expired")
        self._g_depth = reg.gauge("stream.queue_depth")
        self._c_flush = {r: reg.counter(f"stream.flush.{r}")
                         for r in FLUSH_REASONS}
        self.n_batches = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="stream-query")
        self._thread.start()

    # -- submission ----------------------------------------------------------
    def submit_sparse(self, idx, top_k: int | None = None,
                      query_timeout_s: float | None = None) -> QueryTicket:
        """Admit one sparse query (1-D array of active indices)."""
        return self._submit(np.asarray(idx), "sparse", top_k, query_timeout_s)

    def submit_dense(self, v, top_k: int | None = None,
                     query_timeout_s: float | None = None) -> QueryTicket:
        """Admit one dense query (1-D vector of length d)."""
        return self._submit(np.asarray(v), "dense", top_k, query_timeout_s)

    def _retry_after_locked(self) -> float:
        """Backoff hint for a shed ticket: roughly one drain of the current
        queue (observed e2e mean a batch x queued batches), floored at one
        coalescing window."""
        floor = self.cfg.max_delay_ms / 1e3
        if not self._h_e2e.count:
            return max(floor, 1e-3)
        batches = max(len(self._q) / self.cfg.max_batch, 1.0)
        return max(self._h_e2e.mean * batches, floor, 1e-3)

    def _submit(self, row: np.ndarray, layout: str, top_k: int | None,
                query_timeout_s: float | None = None) -> QueryTicket:
        if row.ndim != 1:
            raise ValueError(
                f"submit takes ONE query (1-D row, got shape {row.shape}); "
                "batches are what the admission queue builds")
        tmo = self.cfg.query_timeout_s if query_timeout_s is None \
            else float(query_timeout_s)
        t = QueryTicket(row, layout, int(top_k or self.cfg.top_k),
                        deadline=time.time() + tmo if tmo > 0 else None)
        with self._cond:
            if self._closed:
                raise RuntimeError("streaming service is closed")
            if self.cfg.max_queue and len(self._q) >= self.cfg.max_queue:
                # reject-newest: the ticket comes back already rejected,
                # same interface as an admitted one, and the admitted FIFO
                # work stands
                self._c_shed.inc()
                t._reject(Overloaded(
                    f"streaming admission queue full "
                    f"({len(self._q)}/{self.cfg.max_queue}): query shed",
                    retry_after_s=self._retry_after_locked()))
                return t
            self._q.append(t)
            self._g_depth.set(len(self._q))
            self._cond.notify()
        return t

    # -- the coalescer thread ------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._q and not self._closed and not self._inflight:
                    self._cond.wait()
                if not self._q and not self._inflight and self._closed:
                    return
                batch = reason = None
                deadline_pending = False
                if self._q:
                    batch, reason = self._collect_locked()
                    deadline_pending = batch is None
            if batch is not None:
                self._dispatch(batch, reason)
            with self._cond:
                has_work = bool(self._q)
            if self._inflight and (len(self._inflight) >= self.cfg.depth
                                   or not has_work or deadline_pending):
                self._drain_one()

    def _collect_locked(self):
        """With the lock held and a non-empty queue: block until the head
        batch is ready and pop it, or return ``(None, None)`` when the
        deadline is still running and there are in-flight batches whose
        drain can overlap the wait."""
        cfg = self.cfg
        deadline = self._q[0].t_submit + cfg.max_delay_ms / 1e3
        while True:
            key0 = self._q[0].key
            n = 1
            while n < len(self._q) and n < cfg.max_batch \
                    and self._q[n].key == key0:
                n += 1
            if n >= cfg.max_batch:
                reason = "full"
            elif n < len(self._q):
                reason = "shape"     # incompatible follower: flush the prefix
            elif self._closed:
                reason = "close"
            elif time.perf_counter() >= deadline:
                reason = "deadline"
            elif self._inflight:
                return None, None    # drain instead of idling out the wait
            else:
                self._cond.wait(
                    timeout=max(deadline - time.perf_counter(), 0.0))
                continue
            out = [self._q.popleft() for _ in range(n)]
            self._g_depth.set(len(self._q))
            return out, reason

    def _pad_to(self, n: int) -> int:
        if not self.cfg.pad_pow2:
            return n
        return min(1 << (n - 1).bit_length(), self.cfg.max_batch)

    def _dispatch(self, tickets: list[QueryTicket], reason: str) -> None:
        # a ticket whose deadline passed while queued is dead weight: its
        # caller is gone, so it is dropped before any signing work
        now = time.time()
        live = []
        for t in tickets:
            if t.deadline is not None and now >= t.deadline:
                self._c_expired.inc()
                t._reject(DeadlineExceeded(
                    "query deadline passed while queued: dropped before "
                    "dispatch"))
            else:
                live.append(t)
        self._c_flush[reason].inc()
        if not live:
            return
        tickets = live
        rows = np.stack([t.row for t in tickets])
        n_pad = self._pad_to(len(tickets)) - len(tickets)
        if n_pad:
            rows = np.concatenate(
                [rows, np.broadcast_to(rows[:1],
                                       (n_pad,) + rows.shape[1:])])
        try:
            signed = self._sign(rows, tickets[0].layout)  # launched
        except Exception as e:
            for t in tickets:
                t._reject(e)
            return
        self._h_batch.observe(len(tickets))
        now = time.perf_counter()
        for t in tickets:
            self._h_qwait.observe(now - t.t_submit)
        self._inflight.append((signed, tickets))

    def _budget(self):
        """The plane's shared ``RetryBudget``, when the store has one (a
        remote plane routes every shard through one ``FanoutGroup`` whose
        budget is THE plane budget); an in-process store has no transport
        and its retries stay free."""
        for sh in getattr(self.service.store, "shards", []) or []:
            b = getattr(getattr(sh, "group", None), "budget", None)
            if b is not None:
                return b
        return None

    @staticmethod
    def _batch_deadline(tickets: list[QueryTicket]) -> float | None:
        """Wire deadline for a coalesced batch: the MAX over its tickets'
        deadlines (the batch must be allowed to finish for its most
        patient ticket).  Any ticket without a deadline makes the batch
        unbounded."""
        dls = [t.deadline for t in tickets]
        if any(d is None for d in dls):
            return None
        return max(dls)

    def _query_with_retry(self, svc, signed, top_k: int,
                          batch_deadline: float | None = None):
        """Run one batch query under the batch's wire deadline, retrying up
        to ``cfg.retries`` times on transient failures only: a
        ``TransportError`` (a shard round died, which a self-healing plane
        fixes between attempts) or an ``Overloaded`` rejection (provably
        clean; its ``retry_after_s`` is honoured).  Every retry spends one
        token from the plane's shared ``RetryBudget`` and never fires past
        ``batch_deadline``.  ``DeadlineExceeded`` is terminal, and any
        other exception re-raises at once."""
        budget = self._budget()
        last: BaseException | None = None
        for attempt in range(self.cfg.retries + 1):
            scope = deadline_scope(batch_deadline) \
                if batch_deadline is not None else contextlib.nullcontext()
            try:
                with scope:
                    return svc._query(signed, top_k)
            except DeadlineExceeded:
                raise
            except Overloaded as e:
                last, wait = e, max(e.retry_after_s, 0.0)
            except TransportError as e:
                last, wait = e, 0.0
            if attempt >= self.cfg.retries:
                break
            if batch_deadline is not None \
                    and time.time() + wait >= batch_deadline:
                break                  # a retry could not land in time
            if budget is not None and not budget.try_spend():
                break                  # plane-wide retry budget exhausted
            if wait:
                time.sleep(wait)
            self._c_retries.inc()
        raise last

    def _drain_one(self) -> None:
        signed, tickets = self._inflight.popleft()
        svc = self.service
        try:
            if not svc.packed_ingest:
                # the raw path folds band keys on the host: its signatures
                # come to the host here (as in the service's query); the
                # fused path keeps the signed words on the device into the
                # store's fold
                signed = as_host_sigs(signed)
            top_k = max(t.top_k for t in tickets)
            ids, scores = self._query_with_retry(
                svc, signed, top_k, self._batch_deadline(tickets))
            ids, scores = np.asarray(ids), np.asarray(scores)
        except Exception as e:
            # one batch's failure answers its own tickets and nothing else;
            # the coalescer keeps serving
            for t in tickets:
                t._reject(e)
            return
        for i, t in enumerate(tickets):
            t._resolve(ids[i, :t.top_k].copy(), scores[i, :t.top_k].copy())
            self._h_e2e.observe(t.t_done - t.t_submit)
        self._c_queries.inc(len(tickets))
        self.n_batches += 1

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Flush every admitted query and stop the coalescer (idempotent)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join()

    def __enter__(self) -> "StreamingQueryService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
