"""The share of the card's dense bf16 peak that the served calls reach:
each ``lm.generate`` span's model FLOPs (``lm_cost.generate_flops`` from
its ``batch``, ``prompt_len`` and ``new_tokens``) over its duration times
989.4 TFLOP/s, through the window.  Silent off an H100."""

from portbench import lm_cost


def read(run):
    calls = [s for s in run.spans if s["name"] == "lm.generate"]
    secs = sum(s["dur_s"] for s in calls)
    if run.peak is None or not secs:
        return None
    flops = sum(lm_cost.generate_flops(run.config, s["tags"]["batch"],
                                       s["tags"]["prompt_len"],
                                       s["tags"]["new_tokens"])
                for s in calls)
    return 100.0 * flops / (secs * lm_cost.BF16_FLOPS_PER_S)
