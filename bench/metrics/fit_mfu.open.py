"""fit_mfu.open (whole request): the least time of the answered fits (as
``fit_mfu`` counts it) over the server's bucket time, each bucket's
``FitResult.wall_s`` once: the open loop's window holds idle time that
the offered rate, not the program, sets."""
from harness import measure

UNIT = "%"


def read(run):
    return measure.fit_mfu_buckets(run)
