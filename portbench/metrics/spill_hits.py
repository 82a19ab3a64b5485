"""The spilled ids the store's spill leg hands the scorer: the ``hits``
tag of each ``query.spill`` span (ids from ``store/table.py``
``spilled_candidates``, padding left out), summed over the traced window
and divided by its batches.  0.0 where the fused candidate leg ran
(``query.probe``) and no batch had a spill leg; None where the program
opens neither span."""


def read(run):
    if not run.steps or not any(s["name"] == "query.probe"
                                for s in run.spans):
        return None
    return sum(s["tags"]["hits"] for s in run.spans
               if s["name"] == "query.spill") / run.steps
