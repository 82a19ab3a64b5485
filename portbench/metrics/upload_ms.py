"""The front door's upload: ``query.sign.upload`` spans (the host-to-
device copy of the batch's index lists in ``SketchEngine._on_device``),
summed over the traced window and divided by its batches.  None where
the program opens no such span."""

NAME = "query.sign.upload"


def read(run):
    ups = [s["dur_s"] for s in run.spans if s["name"] == NAME]
    if not ups or not run.steps:
        return None
    return sum(ups) * 1e3 / run.steps
