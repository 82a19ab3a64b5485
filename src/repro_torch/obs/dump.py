"""Periodic JSONL metrics/span dumps, and a checker for CI smoke.

The port's own copy of ``repro.obs.dump``: the line schema is the
reference's, so each package's checker accepts the other's dump.

``MetricsDumper`` is a daemon thread that appends one JSON object per
interval to a file::

    {"t": <unix time>, "seq": <n>, "metrics": <registry snapshot>,
     "spans": [<finished span dicts>...]}

Snapshots are cumulative (each line is the registry's full state at that
instant); spans are incremental (each line drains the tracer's ring, so a
span appears on exactly one line).  A final line is always written on
``close()`` so short-lived runs still leave a complete record.

An optional ``extra`` callable contributes per-line fields — the serve
launcher uses it to fold in worker STATS snapshots so one dump file covers
the whole plane.

``check_dump`` (also ``python -m repro_torch.obs.dump --check PATH``) validates
a dump file: every line parses, has the schema above, and — with
``--require-shard-hists`` — at least one snapshot carries a nonzero
per-shard partial-latency histogram (the CI metrics-smoke gate).
``--require-overload`` additionally requires the overload-hardening
families to be wired: the plane's shared retry-budget token gauge, at
least one per-lane circuit-breaker state gauge, and at least one
shedding-surface metric (streaming admission queue or worker admission
gate).  Names are matched as substrings so per-lane relabelled worker
snapshots (``shard0.replica1.worker.overloaded``) count.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

from . import metrics as _metrics
from . import trace as _trace


class MetricsDumper:
    """Append registry snapshots + drained spans to ``path`` every
    ``interval_s`` seconds until closed."""

    def __init__(self, path: str, interval_s: float = 1.0,
                 registry=None, tracer=None, extra=None):
        self.path = path
        self.interval_s = max(0.05, float(interval_s))
        self._registry = registry
        self._tracer = tracer
        self._extra = extra
        self._seq = 0
        self._stop = threading.Event()
        self._f = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._run, name="metrics-dump", daemon=True)
        self._thread.start()

    def _write_line(self) -> None:
        reg = self._registry or _metrics.default()
        tr = self._tracer or _trace.default()
        line = {"t": time.time(), "seq": self._seq,
                "metrics": reg.snapshot(), "spans": tr.drain()}
        if self._extra is not None:
            try:
                line.update(self._extra() or {})
            except Exception as e:          # never let a stats fetch kill dumps
                line["extra_error"] = repr(e)
        with self._lock:
            if self._f.closed:
                return
            self._f.write(json.dumps(line) + "\n")
            self._f.flush()
        self._seq += 1

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._write_line()

    def close(self) -> None:
        """Stop the thread and write one final line."""
        if self._stop.is_set():
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._write_line()
        with self._lock:
            self._f.close()

    def __enter__(self) -> "MetricsDumper":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# the overload-hardening metric surface, grouped by what must exist for
# the plane to be considered wired (substring match against metric names,
# so per-lane relabelled worker snapshots count)
_OVERLOAD_FAMILIES = {
    "retry_budget": ("transport.retry_budget.tokens",),
    "breaker": ("transport.breaker.",),
    "shed_surface": ("stream.queue_depth", "stream.shed",
                     "worker.admission.depth", "worker.overloaded"),
}


def _iter_snapshots(line: dict):
    """The line's own registry snapshot plus any snapshot-shaped dicts an
    ``extra`` callable folded in (worker STATS obs payloads)."""
    yield line["metrics"]
    for key, val in line.items():
        if key == "metrics" or not isinstance(val, dict):
            continue
        if {"counters", "gauges", "hists"} <= set(val):
            yield val
        else:
            for sub in val.values():
                if isinstance(sub, dict) \
                        and {"counters", "gauges", "hists"} <= set(sub):
                    yield sub


def check_dump(path: str, require_shard_hists: bool = False,
               require_overload: bool = False) -> dict:
    """Validate a dump file; raise ``ValueError`` on malformed content.

    Returns summary stats: line count, span count, the per-shard
    partial-latency histogram names seen with nonzero counts, and which
    overload-hardening metric families were present.
    """
    n_lines = 0
    n_spans = 0
    shard_hists: set[str] = set()
    overload_seen: dict[str, set] = {k: set() for k in _OVERLOAD_FAMILIES}
    with open(path, encoding="utf-8") as f:
        for lineno, raw in enumerate(f, 1):
            raw = raw.strip()
            if not raw:
                continue
            try:
                line = json.loads(raw)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: not JSON: {e}") from None
            for key in ("t", "seq", "metrics", "spans"):
                if key not in line:
                    raise ValueError(f"{path}:{lineno}: missing {key!r}")
            snap = line["metrics"]
            for key in ("counters", "gauges", "hists"):
                if key not in snap:
                    raise ValueError(
                        f"{path}:{lineno}: snapshot missing {key!r}")
            for name, h in snap["hists"].items():
                if not isinstance(h.get("count"), int):
                    raise ValueError(
                        f"{path}:{lineno}: hist {name!r} has no int count")
                if ".shard" in name and ".partial" in name and h["count"] > 0:
                    shard_hists.add(name)
            for sub in _iter_snapshots(line):
                names = list(sub.get("counters", {})) \
                    + list(sub.get("gauges", {}))
                for family, needles in _OVERLOAD_FAMILIES.items():
                    for name in names:
                        if any(n in name for n in needles):
                            overload_seen[family].add(name)
            n_spans += len(line["spans"])
            n_lines += 1
    if n_lines == 0:
        raise ValueError(f"{path}: empty dump")
    if require_shard_hists and len(shard_hists) < 2:
        raise ValueError(
            f"{path}: expected nonzero per-shard partial histograms for >=2 "
            f"shards, saw {sorted(shard_hists)}")
    if require_overload:
        missing = [f for f, seen in overload_seen.items() if not seen]
        if missing:
            raise ValueError(
                f"{path}: overload metric families missing: {missing} "
                f"(need {[_OVERLOAD_FAMILIES[f] for f in missing]})")
    return {"lines": n_lines, "spans": n_spans,
            "shard_hists": sorted(shard_hists),
            "overload_families": {k: sorted(v)
                                  for k, v in overload_seen.items() if v}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.dump", description=check_dump.__doc__)
    ap.add_argument("--check", metavar="PATH", required=True,
                    help="dump file to validate")
    ap.add_argument("--require-shard-hists", action="store_true",
                    help="require nonzero per-shard partial histograms "
                         "from >=2 shards (CI smoke gate)")
    ap.add_argument("--require-overload", action="store_true",
                    help="require the overload-hardening metric families "
                         "(retry budget, circuit breakers, a shedding "
                         "surface) to appear in the dump (CI smoke gate)")
    args = ap.parse_args(argv)
    try:
        out = check_dump(args.check,
                         require_shard_hists=args.require_shard_hists,
                         require_overload=args.require_overload)
    except (OSError, ValueError) as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(f"OK: {out['lines']} lines, {out['spans']} spans, "
          f"shard hists: {out['shard_hists']}, "
          f"overload families: {sorted(out['overload_families'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
