"""fits_per_s (end to end, host clock): tuned fits answered in the window
over the window's length; the window closes at the first answer at or
after ``--seconds``."""
from harness import measure

UNIT = "fits/s"


def read(run):
    return measure.fits_per_s(run)
