"""Zero-dependency observability plane: mergeable metrics + wire traces.

The port's own copy of ``repro.obs``, with the same metric names, snapshot
dicts, span dicts and dump schema:

``metrics``  -- counters, gauges, fixed-log-bucket histograms with exact
(integer) merges, a process registry, and snapshot algebra.
``trace``    -- sampled spans with coordinator -> worker id propagation
over the transport's frames.
``dump``     -- periodic JSONL dumps + a checker.
"""

from .metrics import (Counter, Gauge, Histogram, Registry, NULL,
                      default, set_default, empty_snapshot,
                      merge_snapshots, snapshot_delta, hist_quantile,
                      hist_sum)
from .trace import (TraceCtx, Span, Tracer, NULL_SPAN)
from . import metrics, trace

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "NULL",
    "default", "set_default", "empty_snapshot", "merge_snapshots",
    "snapshot_delta", "hist_quantile", "hist_sum",
    "TraceCtx", "Span", "Tracer", "NULL_SPAN",
    "metrics", "trace",
]
