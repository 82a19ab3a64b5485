"""The 95th percentile of every window batch's latency, on the host clock:
from the call to the return of the host ids and scores (a failed batch
counts with its time)."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.latencies_s) * 1e3, 95))
