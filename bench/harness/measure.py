"""The arithmetic of the metrics, which the readers in ``bench/metrics/``
call.  Each takes the ``Run`` of ``harness.cell`` and returns a number,
or None where the run holds nothing to read (no answer, no trace, no
launch of the kernel), in which case the metric is left out of the line.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from frozen import cost


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile, linear between order statistics (numpy's
    default); None when empty or when it falls on a request that never
    came (an infinite value)."""
    v = np.sort(np.asarray(values, np.float64))
    if len(v) == 0:
        return None
    pos = (len(v) - 1) * q / 100.0
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    if not np.isfinite(v[hi]):
        return None
    return float(v[lo] + (v[hi] - v[lo]) * (pos - lo))


def fits_per_s(run) -> Optional[float]:
    """Tuned fits answered in the window over the window's length; the
    window closes at an answer, so no request is cut in two."""
    w = run.window
    n = sum(1 for r in w.reqs if r.result is not None and r.done <= w.close)
    return n / (w.close - w.start) if n else None


def latencies(run):
    """Each request's time from when it was due to its answer; one that
    failed or never came counts as infinite."""
    return [(r.done - r.due) if r.result is not None else float("inf")
            for r in run.window.reqs]


def latency_p95(run) -> Optional[float]:
    return percentile(latencies(run), 95)


def queue_wait_p95(run) -> Optional[float]:
    """The 95th percentile of each answered request's latency less the
    wall time of the bucket that ran it (``FitResult.wall_s``)."""
    return percentile([r.done - r.due - r.result.wall_s
                       for r in run.window.reqs if r.result is not None], 95)


def answered(run) -> int:
    return sum(1 for r in run.window.reqs if r.result is not None)


def launches_per_fit(run) -> Optional[float]:
    n, launched = answered(run), sum(run.counters.values())
    return launched / n if n and launched else None


def _sizes(run):
    c = run.cell.config
    return c["m"], c["n"], c["p"] + 1


def roofline(run, kernels: Sequence[str], work: Callable) -> Optional[float]:
    """Percent of the least time of the traced launches over their device
    time.  ``kernels`` name the kernels of which each launch runs one;
    ``work(m, n, p)`` gives (flops, bytes) of one launch, at the data
    sheet's peaks."""
    if run.trace is None:
        return None
    launched = run.trace.launches(kernels)
    if not launched:
        return None
    device_s = sum(e - s for _, s, e in launched) * 1e-9
    least = len(launched) * cost.least_seconds(*work(*_sizes(run)))
    return 100.0 * least / device_s


def fit_least_seconds(run) -> float:
    c = run.cell.config
    m, n, p = _sizes(run)
    return cost.least_seconds(*cost.fit_work(m, n, p, c["grid_points"],
                                             c["max_iter"]))


def fit_mfu(run) -> Optional[float]:
    """Percent of the window's chip time (window x chips) that the fits
    answered in it would take at the least time of their work."""
    w = run.window
    n = sum(1 for r in w.reqs if r.result is not None and r.done <= w.close)
    if not n:
        return None
    return (100.0 * n * fit_least_seconds(run)
            / ((w.close - w.start) * run.cell.chips))


def fit_mfu_buckets(run) -> Optional[float]:
    """Percent of the server's bucket time that the answered fits would
    take at the least time of their work (each bucket's wall once)."""
    walls = {}
    for r in run.window.reqs:
        if r.result is not None:
            walls[(r.result.wall_s, r.result.batch_size)] = r.result.wall_s
    if not walls:
        return None
    return 100.0 * answered(run) * fit_least_seconds(run) / sum(walls.values())


def idle_share(run) -> Optional[float]:
    """Percent of the traced window in which no operation ran on the
    device."""
    if run.trace is None or run.trace.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
