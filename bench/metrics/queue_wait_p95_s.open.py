"""queue_wait_p95_s.open (fit serving, ``serving/fit.py``): the 95th
percentile of each answered request's latency less the wall time of the
bucket that ran it (``FitResult.wall_s``): the time it waited for a
bucket to form and start."""
from harness import measure

UNIT = "s"


def read(run):
    return measure.queue_wait_p95(run)
