"""The share of the profiled steps' span in which no kernel, memcpy or
memset ran on the card."""

from portbench import devtrace


def read(run):
    if run.profiled is None or not run.ops:
        return None
    lo, hi = run.profiled
    return 100.0 * (1.0 - devtrace.busy_us(run.ops, lo, hi) / (hi - lo))
