"""The prompt's device time: the median over the window's calls of the
``lm.generate`` span's ``prefill_device_ms`` (CUDA events around the
prefill and the first token, read once the call's tokens are on the
host)."""

import statistics


def read(run):
    ms = [s["tags"]["prefill_device_ms"] for s in run.spans
          if s["name"] == "lm.generate"
          and "prefill_device_ms" in s["tags"]]
    return statistics.median(ms) if ms else None
