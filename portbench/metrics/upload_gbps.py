"""The front door's upload rate: the ``bytes`` tags of the
``query.sign.upload`` spans (the host-to-device copy of the batch's index
lists in ``SketchEngine._on_device``) over their summed durations, in
1e9 bytes a second.  None where the program opens no such span."""

NAME = "query.sign.upload"


def read(run):
    ups = [s for s in run.spans if s["name"] == NAME]
    secs = sum(s["dur_s"] for s in ups)
    if not secs:
        return None
    return sum(s["tags"]["bytes"] for s in ups) / secs / 1e9
