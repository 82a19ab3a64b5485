"""A decode step as the card sees it: the ``lm.decode`` spans'
``device_ms`` (CUDA events from the first token's sampling to the last
step's, the card's idle gaps between the host's launches included) over
their ``steps``, through the window.  Not the span's host wall: nothing
in a step waits for the card, so the host enters ``lm.decode`` while the
card still runs the prompt."""


def read(run):
    spans = [s for s in run.spans if s["name"] == "lm.decode"
             and "device_ms" in s["tags"]]
    steps = sum(s["tags"].get("steps", 0) for s in spans)
    if not steps:
        return None
    return sum(s["tags"]["device_ms"] for s in spans) / steps
