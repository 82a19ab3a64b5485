"""Reading a ``torch.profiler`` chrome trace: the device's operations, the
union of their intervals (so no operator is counted twice with the kernels
it launched) and the gaps between them."""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load(path: str) -> list[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def device_ops(events: list[dict]) -> list[tuple[float, float, str]]:
    """(start_us, end_us, name) of every kernel, memcpy and memset, by
    start."""
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") in DEVICE_CATS and "dur" in e)


def markers(events: list[dict], name: str) -> list[tuple[float, float]]:
    """(start_us, end_us) of the host's ``record_function(name)`` ranges,
    by start."""
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("name") == name and e.get("cat") == "user_annotation"
                  and "dur" in e)


def clipped(ops, lo: float, hi: float):
    """The parts of ``ops`` inside [lo, hi]."""
    return [(max(s, lo), min(e, hi), n) for s, e, n in ops
            if e > lo and s < hi]


def busy_us(ops, lo: float, hi: float) -> float:
    """Microseconds of [lo, hi] in which some device operation ran."""
    total, end = 0.0, lo
    for s, e, _ in clipped(ops, lo, hi):
        total += max(0.0, e - max(s, end))
        end = max(end, e)
    return total


def gaps_us(ops, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle intervals of [lo, hi]."""
    out, end = [], lo
    for s, e, _ in clipped(ops, lo, hi):
        if s > end:
            out.append((end, s))
        end = max(end, e)
    if hi > end:
        out.append((end, hi))
    return out


def time_by_name(ops) -> dict[str, float]:
    """Device microseconds summed by operation name."""
    out: dict[str, float] = {}
    for s, e, n in ops:
        out[n] = out.get(n, 0.0) + e - s
    return out
