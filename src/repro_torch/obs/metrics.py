"""Zero-dependency metrics registry: counters, gauges, log-bucket histograms.

The port's own copy of ``repro.obs.metrics``: the same instrument names, the
same bucket layout and the same snapshot dicts, so a snapshot taken here
equals the reference's for the same observations and either package's
snapshots merge with the other's.

Every instrument lives in a ``Registry`` keyed by name.  Per-process
(per-shard, per-worker) measurements reduce to a global view with an
**exact, associative, commutative** merge, the contract
``distributed.collectives.merge_topk`` gives the serving plane:

  * ``Counter``   -- monotonically increasing int.  Merge: integer add.
  * ``Gauge``     -- a level (occupancy, slots, queue depth).  Merge: sum;
    gauges are chosen to be summable across shards, not ratios.
  * ``Histogram`` -- fixed log-spaced buckets shared by every histogram, so
    the merge is an elementwise bucket add.  Observations are quantized to
    1e-9 (int "nanos") before summing, so ``sum`` is an integer and the
    merge is bit-exact in any order.

Bucket 0 is the underflow (< ``HIST_MIN``), then
``HIST_BUCKETS_PER_DOUBLING`` buckets per doubling for ``HIST_DOUBLINGS``
doublings, then one overflow bucket: 1 us .. ~1073 s at ~19% relative
error, in 122 ints.

Snapshots are plain JSON-able dicts (``snapshot()``), merged with
``merge_snapshots``, relabelled with ``label_snapshot`` and diffed with
``snapshot_delta``; ``hist_quantile`` reads pXX off a snapshot histogram.

``Registry(enabled=False)`` (and the module ``NULL`` registry) hands out
shared no-op instruments.  ``REPRO_OBS=0`` boots the default registry
disabled (the variable reaches spawned shard workers).
"""

from __future__ import annotations

import math
import os
import threading

# -- shared histogram layout --------------------------------------------------

HIST_MIN = 1e-6                     # smallest resolvable value (1 us)
HIST_BUCKETS_PER_DOUBLING = 4       # ~19% relative bucket width
HIST_DOUBLINGS = 30                 # HIST_MIN .. HIST_MIN * 2**30 (~1073 s)
N_LOG_BUCKETS = HIST_BUCKETS_PER_DOUBLING * HIST_DOUBLINGS
N_BUCKETS = N_LOG_BUCKETS + 2       # + underflow (index 0) + overflow (last)

_QUANT = 1e9                        # observations summed as int "nanos"


def bucket_index(v: float) -> int:
    """Value -> bucket index (0 = underflow, N_BUCKETS-1 = overflow)."""
    if v < HIST_MIN:
        return 0
    i = 1 + int(math.log2(v / HIST_MIN) * HIST_BUCKETS_PER_DOUBLING)
    return i if i < N_BUCKETS - 1 else N_BUCKETS - 1


def bucket_bounds(i: int) -> tuple[float, float]:
    """Bucket index -> [lo, hi) value bounds."""
    if i <= 0:
        return 0.0, HIST_MIN
    if i >= N_BUCKETS - 1:
        return HIST_MIN * 2.0 ** (N_LOG_BUCKETS / HIST_BUCKETS_PER_DOUBLING), \
            math.inf
    step = 1.0 / HIST_BUCKETS_PER_DOUBLING
    return HIST_MIN * 2.0 ** ((i - 1) * step), HIST_MIN * 2.0 ** (i * step)


def _bucket_mid(i: int) -> float:
    """Representative value for a bucket (geometric midpoint)."""
    lo, hi = bucket_bounds(i)
    if i <= 0:
        return HIST_MIN / 2.0
    if i >= N_BUCKETS - 1:
        return lo
    return math.sqrt(lo * hi)


# -- instruments --------------------------------------------------------------

class Counter:
    """Monotonic event count."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """A level.  ``add`` deltas keep multi-instance gauges summable: N
    tables in one process each add (new - previously_reported), so the
    gauge reads the in-process total, mirroring the cross-process sum
    merge."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def add(self, dv: float) -> None:
        self.value += float(dv)


class Histogram:
    """Fixed-log-bucket latency/value histogram with exact merge.

    ``last`` is a live-object convenience (the most recent observation —
    what ``ShardedSketchStore.last_timings`` renders); it is NOT part of
    snapshots, which carry only the exactly-mergeable state.
    """

    def __init__(self, name: str):
        self.name = name
        self.counts = [0] * N_BUCKETS
        self.count = 0
        self.sum_q = 0              # sum of observations, int 1e-9 units
        self.vmin: float | None = None
        self.vmax: float | None = None
        self.last = 0.0
        # observe_n callers (probe-depth style) feed a handful of repeated
        # small values; memoize value -> (bucket, quantized) so the hot
        # loop skips the log2 + round.  Bounded; latency-style observe()
        # never touches it (distinct floats would only churn the dict).
        self._memo: dict[float, tuple[int, int]] = {}

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bucket_index(v)] += 1
        self.count += 1
        self.sum_q += int(round(v * _QUANT))
        if self.vmin is None or v < self.vmin:
            self.vmin = v
        if self.vmax is None or v > self.vmax:
            self.vmax = v
        self.last = v

    def observe_n(self, v: float, n: int) -> None:
        """Record ``n`` identical observations (batched paths: e.g. "k
        probe chains terminated at depth t")."""
        if n <= 0:
            return
        v = float(v)
        ent = self._memo.get(v)
        if ent is None:
            if len(self._memo) >= 256:
                self._memo.clear()
            ent = self._memo[v] = (bucket_index(v), int(round(v * _QUANT)))
        self.counts[ent[0]] += n
        self.count += n
        self.sum_q += n * ent[1]
        if self.vmin is None or v < self.vmin:
            self.vmin = v
        if self.vmax is None or v > self.vmax:
            self.vmax = v
        self.last = v

    @property
    def sum(self) -> float:
        return self.sum_q / _QUANT

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        return _quantile_from_counts(self.counts, self.count, q)

    def to_snapshot(self) -> dict:
        return {"count": self.count, "sum_ns": self.sum_q,
                "min": self.vmin, "max": self.vmax,
                "buckets": {str(i): c for i, c in enumerate(self.counts)
                            if c}}


def _quantile_from_counts(counts, total: int, q: float) -> float:
    """Quantile with WITHIN-bucket interpolation.

    Bucket-edge-only reporting made p50==p90==p99 whenever one log bucket
    held most of the mass (every small-N latency stage) — three identical
    numbers that look like a measurement but carry one bucket's worth of
    information.  Instead, locate the bucket holding rank ``q * total`` and
    place the quantile at the fractional rank within it: geometrically for
    log buckets (constant relative width), linearly for the underflow bucket
    (starts at 0), and at the lower edge for the unbounded overflow bucket.
    Still bucket-limited (~19% relative), but distinct quantiles now move
    apart whenever their ranks differ; pair with the sample count (callers
    report ``n``) so small-N percentiles read as what they are.
    """
    if total <= 0:
        return 0.0
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1] (got {q})")
    want = q * total
    seen = 0
    if isinstance(counts, dict):
        items = sorted((int(i), c) for i, c in counts.items())
    else:
        items = [(i, c) for i, c in enumerate(counts) if c]
    for i, c in items:
        if seen + c >= want:
            f = min(max((want - seen) / c, 0.0), 1.0)
            lo, hi = bucket_bounds(i)
            if i >= N_BUCKETS - 1:
                return lo                     # overflow: unbounded above
            if lo <= 0.0:
                return hi * f                 # underflow: linear from 0
            return lo * (hi / lo) ** f        # log bucket: geometric
        seen += c
    return _bucket_mid(items[-1][0]) if items else 0.0


# -- no-op twins (the disabled fast path) -------------------------------------

class _NullCounter:
    name = ""
    value = 0

    def inc(self, n: int = 1) -> None:
        pass


class _NullGauge:
    name = ""
    value = 0.0

    def set(self, v: float) -> None:
        pass

    def add(self, dv: float) -> None:
        pass


class _NullHistogram:
    name = ""
    count = 0
    sum_q = 0
    sum = 0.0
    mean = 0.0
    last = 0.0
    vmin = vmax = None

    def observe(self, v: float) -> None:
        pass

    def observe_n(self, v: float, n: int) -> None:
        pass

    def quantile(self, q: float) -> float:
        return 0.0

    def to_snapshot(self) -> dict:
        return {"count": 0, "sum_ns": 0, "min": None, "max": None,
                "buckets": {}}


NULL_COUNTER = _NullCounter()
NULL_GAUGE = _NullGauge()
NULL_HISTOGRAM = _NullHistogram()


# -- the registry -------------------------------------------------------------

class Registry:
    """Named instruments + snapshot/merge.  Instrument creation is locked
    (the dump thread may race a first-use); reads are lock-free — a
    snapshot taken mid-update is merely a moment older, never corrupt."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}

    def _get(self, table: dict, name: str, cls):
        got = table.get(name)
        if got is None:
            with self._lock:
                got = table.setdefault(name, cls(name))
        return got

    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return NULL_COUNTER
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return NULL_GAUGE
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str) -> Histogram:
        if not self.enabled:
            return NULL_HISTOGRAM
        return self._get(self._hists, name, Histogram)

    def snapshot(self) -> dict:
        """JSON-able state: {"counters": {...}, "gauges": {...},
        "hists": {name: {count, sum_ns, min, max, buckets}}}."""
        return {
            "counters": {n: c.value for n, c in self._counters.items()},
            "gauges": {n: g.value for n, g in self._gauges.items()},
            "hists": {n: h.to_snapshot() for n, h in self._hists.items()},
        }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


NULL = Registry(enabled=False)

_ENV = "REPRO_OBS"
_default: Registry = NULL if os.environ.get(_ENV, "") == "0" else Registry()


def default() -> Registry:
    """The process-wide registry (instrument handles are cached at
    component construction, so swap BEFORE building the plane)."""
    return _default


def set_default(reg: Registry) -> Registry:
    """Swap the default registry; returns the previous one."""
    global _default
    old, _default = _default, reg
    return old


# -- snapshot algebra ---------------------------------------------------------

def empty_snapshot() -> dict:
    return {"counters": {}, "gauges": {}, "hists": {}}


def _merge_hist(a: dict, b: dict) -> dict:
    buckets = dict(a.get("buckets", {}))
    for i, c in b.get("buckets", {}).items():
        buckets[i] = buckets.get(i, 0) + c
    mins = [m for m in (a.get("min"), b.get("min")) if m is not None]
    maxs = [m for m in (a.get("max"), b.get("max")) if m is not None]
    return {"count": a.get("count", 0) + b.get("count", 0),
            "sum_ns": a.get("sum_ns", 0) + b.get("sum_ns", 0),
            "min": min(mins) if mins else None,
            "max": max(maxs) if maxs else None,
            "buckets": buckets}


def merge_snapshots(*snaps: dict) -> dict:
    """Associative, commutative reduction of registry snapshots — counters
    and histogram state add exactly (ints), gauges sum.  Merging S shard
    snapshots in any grouping/order yields identical results, the same
    contract ``merge_topk`` gives partial top-ks."""
    out = empty_snapshot()
    for s in snaps:
        for n, v in s.get("counters", {}).items():
            out["counters"][n] = out["counters"].get(n, 0) + v
        for n, v in s.get("gauges", {}).items():
            out["gauges"][n] = out["gauges"].get(n, 0) + v
        for n, h in s.get("hists", {}).items():
            out["hists"][n] = _merge_hist(
                out["hists"].get(n) or {"count": 0, "sum_ns": 0,
                                        "min": None, "max": None,
                                        "buckets": {}}, h)
    return out


def label_snapshot(snap: dict, prefix: str) -> dict:
    """A copy of ``snap`` with every instrument name prefixed — how a
    plane snapshot keeps per-worker provenance: each worker's registry is
    merged twice, once raw (so plane-wide totals stay one series) and once
    under its ``shard{i}.replica{r}.`` prefix (so a failover
    investigation can see WHICH lane's counters moved).  Values are
    shared, not copied — treat the result as read-only merge input."""
    return {
        "counters": {prefix + n: v
                     for n, v in snap.get("counters", {}).items()},
        "gauges": {prefix + n: v
                   for n, v in snap.get("gauges", {}).items()},
        "hists": {prefix + n: h
                  for n, h in snap.get("hists", {}).items()},
    }


def snapshot_delta(before: dict, after: dict) -> dict:
    """What happened between two snapshots of the SAME registry: counters
    and histogram buckets subtract; gauges are levels, so the delta keeps
    ``after``'s values."""
    out = empty_snapshot()
    for n, v in after.get("counters", {}).items():
        d = v - before.get("counters", {}).get(n, 0)
        if d:
            out["counters"][n] = d
    out["gauges"] = dict(after.get("gauges", {}))
    for n, h in after.get("hists", {}).items():
        b = before.get("hists", {}).get(n)
        if b is None:
            out["hists"][n] = h
            continue
        buckets = {i: c - b.get("buckets", {}).get(i, 0)
                   for i, c in h.get("buckets", {}).items()
                   if c - b.get("buckets", {}).get(i, 0)}
        cnt = h.get("count", 0) - b.get("count", 0)
        if cnt or buckets:
            out["hists"][n] = {"count": cnt,
                               "sum_ns": h.get("sum_ns", 0) -
                               b.get("sum_ns", 0),
                               "min": h.get("min"), "max": h.get("max"),
                               "buckets": buckets}
    return out


def hist_quantile(h: dict, q: float) -> float:
    """pXX from a snapshot histogram (within-bucket interpolated; still
    bucket-limited to ~19% rel. err — report ``h["count"]`` alongside)."""
    return _quantile_from_counts(h.get("buckets", {}), h.get("count", 0), q)


def hist_sum(h: dict) -> float:
    return h.get("sum_ns", 0) / _QUANT
