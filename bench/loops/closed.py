"""The closed loop (``"loop": "closed"``): ``clients`` callers, each sending
its next request as soon as its last one is answered.  The server runs
inline (a handle's ``result`` drives it), so the clients' requests that
are queued together form one bucket.  The window closes at the first
answer at or after ``seconds``; the answers of that same bucket count with
it."""
from __future__ import annotations

from typing import List

from harness.traffic import DRAIN_S, Req, Window, clock, picks, wait


def drive(system, traffic: dict, seed: int, seconds: float) -> Window:
    clients = int(traffic["clients"])
    order = picks(traffic, seed, 1 << 16)
    reqs: List[Req] = []
    handles = {}

    def send() -> Req:
        rid = len(reqs)
        at = clock()
        req = Req(rid=rid, pool=order[rid % len(order)], due=at, sent=at)
        handles[rid] = system.submit(rid, req.pool)
        req.sent = clock()
        reqs.append(req)
        return req

    start = clock()
    deadline = start + seconds
    waiting = [send() for _ in range(clients)]
    while True:
        head = waiting.pop(0)
        wait(head, handles[head.rid])
        if head.done >= deadline:
            close = head.done
            break
        waiting.append(send())
    for r in waiting:
        if handles[r.rid].done():       # answered in the same bucket
            wait(r, handles[r.rid])
            r.done = close
        else:                           # answered after the close
            wait(r, handles[r.rid], DRAIN_S)
    return Window(start, close, reqs)


def warm_up(system, traffic: dict) -> None:
    """One full bucket, the only one the loop forms, before the window."""
    handles = [system.submit(-1 - k, k % int(traffic["pool"]))
               for k in range(int(traffic["clients"]))]
    for h in handles:
        h.result()
