"""The host blocked on the card: every span whose name ends in
``.copy_out`` (the band hashes' copy for the spill leg, the candidate
partial's three copies, the fallback's copies of its counts and order),
summed over the traced window and divided by its batches.  None where
the program opens no such span."""


def read(run):
    waits = [s["dur_s"] for s in run.spans
             if s["name"].endswith(".copy_out")]
    if not waits or not run.steps:
        return None
    return sum(waits) * 1e3 / run.steps
