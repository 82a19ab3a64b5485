"""Kernel 1 (``csrc/cminhash_sparse.cu``) against its roofline, over the
profiled steps: the least time for K table reads of every real (not
padding) entry of the batch, divided by the kernel's device time in the
profile."""

from portbench import roofline

KERNEL = "cminhash_sparse_kernel"


def read(run):
    busy = sum(e - s for s, e, n in run.ops if KERNEL in n)
    if not busy or run.peak is None:
        return None
    svc = run.config["service"]
    least = 0.0
    for w in run.work:
        ops, n_bytes = roofline.sign_work(w["entries"], w["rows"], svc["d"],
                                          svc["k"], svc["b"])
        least += roofline.least_s(ops, n_bytes, run.peak)
    return 100.0 * least / (busy / 1e6)
