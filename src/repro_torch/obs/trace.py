"""Cross-process trace spans for the sign -> shard -> serve path.

The port's own copy of ``repro.obs.trace``, with the same span dicts, so
a worker of either package can echo spans into the other's coordinator.

A trace is a 63-bit id shared by every span of one logical operation (one
query batch, one ingest scatter).  Spans carry (trace_id, span_id,
parent_id, proc, start, duration, tags) and are recorded into a bounded
ring on the process-local ``Tracer``; finished spans are plain dicts, so
they serialize to JSON and travel the wire unchanged.

Sampling happens once, at the root: ``Tracer.span(name)`` with no ambient
parent rolls ``sample_rate``; an unsampled root returns the shared no-op
span and every descendant (local or remote) inherits the decision.  Sampled
spans push themselves onto a thread-local ambient stack, so nested
instrumentation stitches parent and child without a context argument.

Cross-process propagation rides the transport's request/reply pairing: the
coordinator attaches ``ctx()`` (trace id + parent span id) as two int
fields on the request frame, the worker opens its spans under that parent,
and the reply carries the worker's finished spans back as a JSON field;
``Tracer.absorb`` folds them into the coordinator's ring, so ``for_trace``
returns one stitched trace.
"""

from __future__ import annotations

import collections
import json
import random
import threading
import time
from typing import NamedTuple


class TraceCtx(NamedTuple):
    """What crosses a process boundary: the trace and the parent span."""

    trace_id: int
    span_id: int


def _new_id() -> int:
    return random.getrandbits(63) or 1


class Span:
    """One timed leg.  Use as a context manager; on exit it records itself
    into its tracer's finished ring."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "proc",
                 "t_start", "_t0", "dur_s", "tags", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, trace_id: int,
                 parent_id: int | None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.proc = tracer.proc
        self.tags: dict = {}
        self._tracer = tracer
        self.t_start = time.time()
        self._t0 = time.perf_counter()
        self.dur_s = 0.0

    sampled = True

    def tag(self, key: str, value) -> "Span":
        self.tags[key] = value
        return self

    def ctx(self) -> TraceCtx:
        return TraceCtx(self.trace_id, self.span_id)

    def to_dict(self) -> dict:
        return {"name": self.name, "trace": self.trace_id,
                "span": self.span_id, "parent": self.parent_id,
                "proc": self.proc, "t0": self.t_start, "dur_s": self.dur_s,
                "tags": self.tags}

    def __enter__(self) -> "Span":
        self._tracer._push(self)
        return self

    def __exit__(self, *exc) -> None:
        self.dur_s = time.perf_counter() - self._t0
        self._tracer._pop(self)


class _NullSpan:
    """Shared no-op span: the unsampled (and disabled-tracer) fast path."""

    sampled = False
    trace_id = span_id = 0
    parent_id = None
    tags: dict = {}

    def tag(self, key: str, value) -> "_NullSpan":
        return self

    def ctx(self) -> None:
        return None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL_SPAN = _NullSpan()


class Tracer:
    """Process-local span factory + finished-span ring.

    ``proc`` labels which process a span ran in (coordinator vs shard
    worker) so a stitched trace reads unambiguously.
    """

    def __init__(self, sample_rate: float = 0.0, proc: str = "main",
                 max_finished: int = 8192):
        self.sample_rate = float(sample_rate)
        self.proc = proc
        self.finished: collections.deque = collections.deque(
            maxlen=max_finished)
        self._local = threading.local()
        self._lock = threading.Lock()

    # -- ambient stack -------------------------------------------------------
    def _stack(self) -> list:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        else:                       # out-of-order exit: drop it wherever it is
            try:
                stack.remove(span)
            except ValueError:
                pass
        with self._lock:
            self.finished.append(span.to_dict())

    def current(self) -> TraceCtx | None:
        """The ambient trace context (what remote submits put on the wire)."""
        stack = self._stack()
        return stack[-1].ctx() if stack else None

    # -- span creation -------------------------------------------------------
    def span(self, name: str, parent: TraceCtx | None = None):
        """Open a span.  Explicit ``parent`` (a wire-propagated ctx) always
        samples; otherwise nest under the ambient span; otherwise this is a
        root — roll ``sample_rate``."""
        if parent is not None:
            return Span(self, name, parent.trace_id, parent.span_id)
        ambient = self.current()
        if ambient is not None:
            return Span(self, name, ambient.trace_id, ambient.span_id)
        if self.sample_rate <= 0.0 or random.random() >= self.sample_rate:
            return NULL_SPAN
        return Span(self, name, _new_id(), None)

    # -- finished spans ------------------------------------------------------
    def absorb(self, spans) -> None:
        """Fold remote span dicts (a worker reply's echo) into the ring."""
        with self._lock:
            self.finished.extend(spans)

    def absorb_json(self, blob: str | None) -> None:
        if blob:
            self.absorb(json.loads(blob))

    def drain(self) -> list[dict]:
        """Pop every finished span (what replies/dumps ship)."""
        with self._lock:
            out = list(self.finished)
            self.finished.clear()
        return out

    def for_trace(self, trace_id: int) -> list[dict]:
        """All finished spans of one trace (non-destructive)."""
        with self._lock:
            return [s for s in self.finished if s.get("trace") == trace_id]

    def last_trace_id(self) -> int | None:
        with self._lock:
            for s in reversed(self.finished):
                if s.get("parent") is None:
                    return s.get("trace")
            return self.finished[-1].get("trace") if self.finished else None


_default = Tracer()


def default() -> Tracer:
    """The process-wide tracer (workers get their own per process)."""
    return _default


def set_default(tracer: Tracer) -> Tracer:
    global _default
    old, _default = _default, tracer
    return old


def current() -> TraceCtx | None:
    """Ambient trace context of the default tracer (the wire-injection
    hook: remote backends call this at submit time)."""
    return _default.current()
