"""fit_p95_s (end to end, host clock): the 95th percentile, over every
request due in the window, of the time from when it was due to its
``FitResult``; a request that failed or never came counts as infinite."""
from harness import measure

UNIT = "s"


def read(run):
    return measure.latency_p95(run)
