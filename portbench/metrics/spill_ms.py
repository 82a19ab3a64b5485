"""The store's spill leg on the host: the self time of each
``query.spill`` span (the spilled keys' lookup in ``store/table.py``, the
ids' upload and concatenation; its ``query.spill.copy_out`` child, the
wait for the card, is ``host_wait_ms``'s), summed over the traced window
and divided by its batches.  0.0 where the fused candidate leg ran
(``query.probe``) and no batch had a spill leg; None where the program
opens neither span."""


def read(run):
    if not run.steps or not any(s["name"] == "query.probe"
                                for s in run.spans):
        return None
    spill = {s["span"]: s["dur_s"] for s in run.spans
             if s["name"] == "query.spill"}
    waits = sum(s["dur_s"] for s in run.spans
                if s["name"] == "query.spill.copy_out"
                and s["parent"] in spill)
    return (sum(spill.values()) - waits) * 1e3 / run.steps
