"""The device's idle time of a traced window put down to the program's host
spans (``repro_torch.spans``), which carry the profiler's clock
(``time.time_ns()``), so a span and a device operation share one
timeline.

- ``idle_by_span``: every idle nanosecond of the window, each piece of a
  gap put down to the innermost span of the host's work open on the
  server's thread at that moment, or to ``OUTSIDE`` where none is open.
- ``bucket_idle_share`` / ``front_idle_share``: percent of the window in
  which the device is idle while the server's thread is inside a bucket
  (``serve.bucket``) / outside every bucket; the two sum to the window's
  idle share.
- ``bucket_wait_p95_s``: the 95th percentile, over the requests answered
  in the window, of each one's wait from ``submit()`` to the start of its
  bucket (``serve.queue``).

No cell reads these yet: ``harness.cell`` does not turn the program's
spans on.  ``bench/idle_by_span.py`` runs a cell with them on over its
window and prints these readings.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from harness import measure
from harness.trace import Trace, union_seconds

OUTSIDE = "outside any span"
BUCKET = "serve.bucket"       # a bucket of the server, from pop to delivery
WAITS = ("serve.queue",)      # spans of waiting, not of the host's work


def idle(trace: Trace, start_ns: int) -> np.ndarray:
    """The device's idle intervals (start, end ns) in the window of
    ``trace.window_s`` seconds from ``start_ns``: every gap in the union
    of its operations, and the window's edges."""
    end_ns = start_ns + int(round(trace.window_s * 1e9))
    iv = np.asarray([[s, e] for _, s, e in trace.kernels],
                    np.int64).reshape(-1, 2)
    iv = np.clip(iv, start_ns, end_ns)
    _, merged = union_seconds(iv[iv[:, 1] > iv[:, 0]])
    gaps = np.r_[start_ns, merged.ravel(), end_ns].reshape(-1, 2)
    return gaps[gaps[:, 1] > gaps[:, 0]]


def _work(spans) -> list:
    """The spans of the host's work on the server's threads (those that
    ran a bucket; every thread where none did), waits left out."""
    threads = {s[3] for s in spans if s[0] == BUCKET}
    return [s for s in spans if s[0] not in WAITS
            and (not threads or s[3] in threads)]


def _innermost(spans) -> List[Tuple[int, int, str]]:
    """The timeline of ``spans`` as (start, end, name) pieces, each piece
    named by the innermost span open over it: of the spans open there,
    the one started last (at one instant, the longer first)."""
    spans = [s for s in spans if s[2] > s[1]]
    marks = sorted([(s[1], 1, s[1] - s[2], i) for i, s in enumerate(spans)]
                   + [(s[2], 0, 0, i) for i, s in enumerate(spans)])
    pieces, open_, last = [], [], None
    for t, starts, _, i in marks:
        if open_ and last is not None and t > last:
            pieces.append((last, t, spans[open_[-1]][0]))
        if starts:
            open_.append(i)
        else:
            open_.remove(i)
        last = t
    return pieces


def _overlap(gaps: np.ndarray, pieces) -> Dict[str, float]:
    """Seconds of ``gaps`` under each name of the ``pieces`` (both sorted
    and disjoint); what no piece covers is ``OUTSIDE``."""
    out: Dict[str, float] = defaultdict(float)
    total, j = 0, 0
    for g0, g1 in gaps.tolist():
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < g1:
            cut = min(g1, pieces[k][1]) - max(g0, pieces[k][0])
            out[pieces[k][2]] += cut * 1e-9
            total += cut
            k += 1
    out[OUTSIDE] += (int(np.sum(gaps[:, 1] - gaps[:, 0])) - total) * 1e-9
    return out


def idle_by_span(trace: Trace, start_ns: int, spans) -> List[list]:
    """The device's idle seconds in the window, each piece of a gap put
    down to the innermost span of the host's work open on the server's
    thread at that moment, as [name, seconds], largest first.  ``spans``
    are the program's records (name, t0_ns, t1_ns, thread, ids)."""
    by = _overlap(idle(trace, start_ns), _innermost(_work(spans)))
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])


def bucket_idle_share(trace: Trace, start_ns: int, spans) -> Optional[float]:
    """Percent of the window in which the device is idle while the
    server's thread is inside a ``serve.bucket``; None without spans or
    without a device operation."""
    if not spans or not trace.kernels:
        return None
    buckets = [s for s in _work(spans) if s[0] == BUCKET]
    inside = sum(v for k, v in _overlap(idle(trace, start_ns),
                                        _innermost(buckets)).items()
                 if k != OUTSIDE)
    return 100.0 * inside / trace.window_s


def front_idle_share(trace: Trace, start_ns: int, spans) -> Optional[float]:
    """Percent of the window in which the device is idle while the
    server's thread is outside every ``serve.bucket``: after a bucket's
    last handle is set, the clients' turn-around, submit, the next pop."""
    inside = bucket_idle_share(trace, start_ns, spans)
    if inside is None:
        return None
    gaps = idle(trace, start_ns)
    whole = int(np.sum(gaps[:, 1] - gaps[:, 0])) * 1e-9
    return 100.0 * whole / trace.window_s - inside


def bucket_wait_p95_s(window, spans) -> Optional[float]:
    """The 95th percentile, over the requests answered in ``window``, of
    each one's ``serve.queue`` span."""
    if not spans:
        return None
    rids = {r.rid for r in window.reqs
            if r.result is not None and r.done <= window.close}
    waits = [(t1 - t0) * 1e-9 for name, t0, t1, _, ids in spans
             if name == "serve.queue" and ids.get("rid") in rids]
    return measure.percentile(waits, 95)
