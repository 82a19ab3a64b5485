"""Reading the program's tracer spans: one trace a query batch (the
service's ``query`` root span and everything under it)."""

from __future__ import annotations

import collections


def by_trace(spans: list[dict]) -> dict[int, list[dict]]:
    """Each trace's spans in order of start."""
    out = collections.defaultdict(list)
    for s in spans:
        out[s["trace"]].append(s)
    return {t: sorted(ss, key=lambda s: s["t0"]) for t, ss in out.items()}


def round_seconds(spans: list[dict], names: tuple[str, ...],
                  round_no: int) -> float:
    """Seconds of the ``round_no``-th (0-based) span of each name in each
    trace, summed over the traces: the coordinator's candidate round is its
    first ``query.broadcast``/``query.partial``/``query.merge``, the
    brute-force fallback its second."""
    total = 0.0
    for ss in by_trace(spans).values():
        for name in names:
            of_name = [s for s in ss if s["name"] == name]
            if len(of_name) > round_no:
                total += of_name[round_no]["dur_s"]
    return total


def named_seconds(spans: list[dict], name: str) -> float:
    """Seconds of every span called ``name``, summed."""
    return sum(s["dur_s"] for s in spans if s["name"] == name)
