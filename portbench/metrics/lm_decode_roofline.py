"""The decode steps against their memory roofline: the least time a step
could take by bytes (``lm_cost.decode_step_bytes``: the weights but the
experts, the experts the step hit (the ``experts_hit`` tag), K/V over the
step's context, the Mamba state read and written) at 3.35 TB/s, over the
step's device time (the ``lm.decode`` span's ``device_ms`` over its
``steps``), summed through the window."""

from portbench import lm_cost


def read(run):
    by_id = {s["span"]: s for s in run.spans}
    least = busy = 0.0
    for s in run.spans:
        tags = s["tags"]
        if s["name"] != "lm.decode" or not tags.get("steps") \
                or "device_ms" not in tags or "experts_hit" not in tags:
            continue
        call = by_id[s["parent"]]["tags"]
        context = call["prompt_len"] + (tags["steps"] + 1) / 2
        least += tags["steps"] * lm_cost.decode_step_bytes(
            run.config, call["batch"], context, tags["experts_hit"])
        busy += tags["device_ms"] / 1e3
    if run.peak is None or not busy:
        return None
    return 100.0 * least / run.peak["bytes_per_s"] / busy
