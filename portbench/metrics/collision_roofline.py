"""Kernel 4 (``csrc/collision.cu``) against its roofline, over the
profiled steps: the least time for the fallback's real rows scored against
every indexed row (one int32 compare a word pair; the query words, the
index words and the counts moved once), divided by the kernel's device
time in the profile."""

from portbench import roofline

KERNEL = "collision_kernel"


def read(run):
    busy = sum(e - s for s, e, n in run.ops if KERNEL in n)
    if not busy or run.peak is None:
        return None
    svc = run.config["service"]
    least = 0.0
    for w in run.work:
        if w["fallback_rows"]:
            ops, n_bytes = roofline.collision_work(
                w["fallback_rows"], w["index_rows"], svc["k"], svc["b"])
            least += roofline.least_s(ops, n_bytes, run.peak)
    return 100.0 * least / (busy / 1e6)
