"""The service's front door: ``query.sign`` spans (the index lists'
upload and kernel 1's launch), summed over the traced window and divided
by its batches."""

from portbench import spans


def read(run):
    if not run.spans or not run.steps:
        return None
    return spans.named_seconds(run.spans, "query.sign") * 1e3 / run.steps
