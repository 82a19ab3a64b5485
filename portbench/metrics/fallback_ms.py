"""The planner's brute-force fallback: each batch's second
``query.broadcast``/``query.partial``/``query.merge`` round (rows padded to
a power of two, kernel 4, the full stable sort, the gathers and copies),
summed over the traced window and divided by all of its batches."""

from portbench import spans

ROUND = ("query.broadcast", "query.partial", "query.merge")


def read(run):
    if not run.spans or not run.steps:
        return None
    return spans.round_seconds(run.spans, ROUND, 1) * 1e3 / run.steps
