"""The coordinator's and store's candidate leg: ``query.fold`` and the
first ``query.broadcast``/``query.partial``/``query.merge`` of each batch
(probe, candidate scoring, the partial's copy to the host, the merge),
summed over the traced window and divided by its batches."""

from portbench import spans

ROUND = ("query.broadcast", "query.partial", "query.merge")


def read(run):
    if not run.spans or not run.steps:
        return None
    total = spans.named_seconds(run.spans, "query.fold") \
        + spans.round_seconds(run.spans, ROUND, 0)
    return total * 1e3 / run.steps
