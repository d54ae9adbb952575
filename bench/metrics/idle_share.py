"""idle_share (device): percent of the traced window in which no
operation ran on the device, 1 - (union of the device operations'
intervals) / window, from the profiler's trace.  It also reads
``idle_share.<suffix>``, the same share under a name of its own where it
moves another end-to-end metric."""
from harness import measure

UNIT = "%"


def read(run):
    return measure.idle_share(run)
