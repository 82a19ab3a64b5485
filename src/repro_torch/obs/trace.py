"""Trace spans for the sign -> store -> merge path.

The part of ``repro.obs.trace`` the serving path calls: ``Tracer.span``
opens a timed span nested under the ambient one (a thread-local stack);
a root span is sampled with ``sample_rate`` and an unsampled root hands
out the shared no-op span.  Finished spans are dicts in a bounded ring.
"""

from __future__ import annotations

import collections
import random
import threading
import time


def _new_id() -> int:
    return random.getrandbits(63) or 1


class Span:
    """One timed leg; records itself into its tracer's ring on exit."""

    sampled = True

    def __init__(self, tracer: "Tracer", name: str, trace_id: int,
                 parent_id: int | None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.tags: dict = {}
        self._tracer = tracer
        self.t_start = time.time()
        self._t0 = time.perf_counter()
        self.dur_s = 0.0

    def tag(self, key: str, value) -> "Span":
        self.tags[key] = value
        return self

    def to_dict(self) -> dict:
        return {"name": self.name, "trace": self.trace_id,
                "span": self.span_id, "parent": self.parent_id,
                "proc": self._tracer.proc, "t0": self.t_start,
                "dur_s": self.dur_s, "tags": self.tags}

    def __enter__(self) -> "Span":
        self._tracer._stack().append(self)
        return self

    def __exit__(self, *exc) -> None:
        self.dur_s = time.perf_counter() - self._t0
        self._tracer._pop(self)


class _NullSpan:
    """Shared no-op span: the unsampled fast path."""

    sampled = False

    def tag(self, key: str, value) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL_SPAN = _NullSpan()


class Tracer:
    """Process-local span factory + finished-span ring."""

    def __init__(self, sample_rate: float = 0.0, proc: str = "main",
                 max_finished: int = 8192):
        self.sample_rate = float(sample_rate)
        self.proc = proc
        self.finished: collections.deque = collections.deque(
            maxlen=max_finished)
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> list:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def _pop(self, span: Span) -> None:
        stack = self._stack()
        if span in stack:
            stack.remove(span)
        with self._lock:
            self.finished.append(span.to_dict())

    def span(self, name: str):
        """Open a span under the ambient one, or a sampled root."""
        stack = self._stack()
        if stack:
            return Span(self, name, stack[-1].trace_id, stack[-1].span_id)
        if self.sample_rate <= 0.0 or random.random() >= self.sample_rate:
            return NULL_SPAN
        return Span(self, name, _new_id(), None)


_default = Tracer()


def default() -> Tracer:
    """The process-wide tracer."""
    return _default
