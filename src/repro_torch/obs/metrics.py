"""Metrics registry: counters and log-bucket histograms.

The part of ``repro.obs.metrics`` the serving path calls, with the same
instrument names (``ingest.sign|wait|scatter|wall``, ``service.query``,
``kernel.*``) and the same bucket layout, so snapshots read alike.  Bucket
0 is the underflow (< ``HIST_MIN``), then ``HIST_BUCKETS_PER_DOUBLING``
buckets per doubling for ``HIST_DOUBLINGS`` doublings, then one overflow
bucket.  Sums are kept as integer nanos so merges are exact.
"""

from __future__ import annotations

import math
import threading

HIST_MIN = 1e-6
HIST_BUCKETS_PER_DOUBLING = 4
HIST_DOUBLINGS = 30
N_LOG_BUCKETS = HIST_BUCKETS_PER_DOUBLING * HIST_DOUBLINGS
N_BUCKETS = N_LOG_BUCKETS + 2

_QUANT = 1e9


def bucket_index(v: float) -> int:
    """Value -> bucket index (0 = underflow, N_BUCKETS-1 = overflow)."""
    if v < HIST_MIN:
        return 0
    i = 1 + int(math.log2(v / HIST_MIN) * HIST_BUCKETS_PER_DOUBLING)
    return i if i < N_BUCKETS - 1 else N_BUCKETS - 1


class Counter:
    """Monotonic event count."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Histogram:
    """Fixed-log-bucket latency/value histogram."""

    def __init__(self, name: str):
        self.name = name
        self.counts = [0] * N_BUCKETS
        self.count = 0
        self.sum_q = 0
        self.last = 0.0

    def observe(self, v: float) -> None:
        self.observe_n(v, 1)

    def observe_n(self, v: float, n: int) -> None:
        """Record ``n`` identical observations."""
        if n <= 0:
            return
        v = float(v)
        self.counts[bucket_index(v)] += n
        self.count += n
        self.sum_q += n * int(round(v * _QUANT))
        self.last = v

    @property
    def sum(self) -> float:
        return self.sum_q / _QUANT

    def to_snapshot(self) -> dict:
        return {"count": self.count, "sum_ns": self.sum_q,
                "buckets": {str(i): c for i, c in enumerate(self.counts)
                            if c}}


class Registry:
    """Named instruments + snapshot.  Creation is locked; reads are not."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._hists: dict[str, Histogram] = {}

    def _get(self, table: dict, name: str, cls):
        got = table.get(name)
        if got is None:
            with self._lock:
                got = table.setdefault(name, cls(name))
        return got

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def histogram(self, name: str) -> Histogram:
        return self._get(self._hists, name, Histogram)

    def snapshot(self) -> dict:
        return {"counters": {n: c.value for n, c in self._counters.items()},
                "hists": {n: h.to_snapshot()
                          for n, h in self._hists.items()}}


_default = Registry()


def default() -> Registry:
    """The process-wide registry."""
    return _default
