"""The 95th percentile over every request due in the window of the time
from when it was due (the schedule) to the last byte of its reply; a
failed request is infinitely late, and a percentile that lands on one is
reported as the window plus the drain cap, the least it could be."""

import math

from benchmark.harness.client import percentile

KERNELS = ()


def read(run):
    lat = [s.done - s.due if s.ok else math.inf for s in run.sent
           if run.t0 <= s.due < run.t1]
    p = percentile(lat, 0.95)
    if p is None:
        return None
    return min(p, run.seconds + run.mix["drain_s"])
