"""What every traffic loop shares: the clock, a request's record, the
window, which input each request takes and an open loop's arrivals.

A mix (``bench/traffic/<mix>.json``) names its loop by ``"loop"``; the
loop is ``bench/loops/<loop>.py``, found by that name (``spec.loop``),
with ``drive(system, mix, seed, seconds) -> Window`` and
``warm_up(system, mix)``.  A loop drives any system module's object
(``bench/systems/<system>.py``): ``submit(rid, index)`` returns a handle
with ``result(timeout)`` and ``done()``; ``start()`` and ``stop()`` run
and end the system's own server thread where a loop needs one.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

DRAIN_S = 60.0
clock = time.perf_counter


@dataclasses.dataclass
class Req:
    rid: int
    pool: int                   # the input it takes (an index into the pool)
    due: float                  # s on ``clock``, when it was due
    sent: float                 # when ``submit`` returned
    done: Optional[float] = None
    result: object = None       # the system's answer
    error: Optional[BaseException] = None


@dataclasses.dataclass
class Window:
    start: float
    close: float                # the closed loop's last counted answer, or
    #                             the open loop's last arrival
    reqs: List[Req]


def wait(req: Req, handle, timeout: Optional[float] = None) -> None:
    """Wait for ``req``'s answer and record it; a failed request is
    recorded, not raised."""
    try:
        req.result = handle.result(timeout)
    except Exception as e:
        req.error = e
    req.done = clock()


def picks(traffic: dict, seed: int, count: int) -> List[int]:
    """The input of each of ``count`` requests: in turn through the pool
    (``"order": "cycle"``), or through one permutation of it drawn from
    the seed (``"shuffle"``)."""
    size = int(traffic["pool"])
    if traffic.get("order", "cycle") == "cycle":
        return [k % size for k in range(count)]
    perm = np.random.default_rng([int(seed), 1]).permutation(size)
    return [int(perm[k % size]) for k in range(count)]


def arrivals(rate: float, seconds: float) -> np.ndarray:
    """Due times (s after the window opens) of an open loop at ``rate``
    per second over ``seconds``: a fixed schedule, not a Poisson draw —
    the round(rate * seconds) midpoint quantiles of the exponential gap,
    in one shuffled order, summed.  The schedule is the same for every
    seed: at four fifths of capacity the tail swings with the bursts of
    the order (0.59 to 1.39 s at one rate in ``table1.open``), so the seed
    draws the data and which input each request takes, and the arrivals
    are the mix's own."""
    count = max(1, int(round(rate * seconds)))
    q = (np.arange(count) + 0.5) / count
    gaps = -np.log1p(-q) / rate
    gaps = gaps[np.random.default_rng(0).permutation(count)]
    times = np.cumsum(gaps)
    return times[times <= seconds]
