"""fit_mfu (whole request): percent of the window's chip time that the
fits answered in it would take at the least time of their work —
``grid_points`` x ``max_iter`` rounds of 4·m·n·p flops at 67 TFLOP/s in
fp32, or X, y and W read once at 3.35 TB/s, whichever is longer.  The
count depends on no kernel's name or instance."""
from harness import measure

UNIT = "%"


def read(run):
    return measure.fit_mfu(run)
