"""The open loop (``"loop": "open"``): requests due at the arrivals of
``traffic.arrivals(rate_per_s, seconds)``, sent on time whatever the
server does, and served by the system's worker thread (``start()``).
Each is timed from when it was due.  After the last arrival the generator
waits for every answer, at most ``DRAIN_S`` seconds."""
from __future__ import annotations

import queue
import threading
import time
from typing import List

from harness.traffic import (DRAIN_S, Req, Window, arrivals, clock, picks,
                             wait)


def drive(system, traffic: dict, seed: int, seconds: float) -> Window:
    due = arrivals(float(traffic["rate_per_s"]), seconds)
    order = picks(traffic, seed, len(due))
    reqs: List[Req] = []
    sent: "queue.Queue" = queue.Queue()
    system.start()
    start = clock()
    drain_end = start + float(due[-1]) + DRAIN_S

    def collect():
        while True:
            item = sent.get()
            if item is None:
                return
            req, handle = item
            wait(req, handle, max(0.0, drain_end - clock()))

    collector = threading.Thread(target=collect, name="bench-collector",
                                 daemon=True)
    collector.start()
    try:
        for k, offset in enumerate(due):
            at = start + float(offset)
            pause = at - clock()
            if pause > 0:
                time.sleep(pause)
            req = Req(rid=k, pool=order[k], due=at, sent=at)
            handle = system.submit(k, req.pool)
            req.sent = clock()
            reqs.append(req)
            sent.put((req, handle))
    finally:
        sent.put(None)
        collector.join(max(0.0, drain_end - clock()) + 5.0)
        system.stop()
    return Window(start, start + float(due[-1]), reqs)


def warm_up(system, traffic: dict) -> None:
    """The buckets the loop can form that differ in their work, before the
    window: a full one and one of one request."""
    rid = -1
    for size in (int(traffic["max_batch"]), 1):
        handles = []
        for k in range(size):
            handles.append(system.submit(rid, k % int(traffic["pool"])))
            rid -= 1
        for h in handles:
            h.result()
