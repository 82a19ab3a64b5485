"""The share of the rows kernel 4 scores in the brute-force fallback that
are real query rows, not the planner's power-of-two padding: the
``rows`` and ``padded`` tags of every ``query.fallback.pad`` span."""


def read(run):
    pads = [s["tags"] for s in run.spans if s["name"] == "query.fallback.pad"]
    padded = sum(t["padded"] for t in pads)
    if not padded:
        return None
    return 100.0 * sum(t["rows"] for t in pads) / padded
