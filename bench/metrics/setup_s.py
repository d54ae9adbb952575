"""setup_s (end to end, host clock): process start to the first timed
request — imports, the CUDA context, the kernel library (built by nvcc on
a checkout's first run), the pool drawn on the card, and the cell's own
shapes warmed."""

UNIT = "s"


def read(run):
    return run.setup_s
