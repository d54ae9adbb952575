"""Host spans of the port: named intervals of the host's own work, on the
clock that ``torch.profiler``'s events carry, so that a device trace and
the spans share one timeline.

Off by default.  An operator who wants to know what the host was doing
while the device waited turns them on around the work and takes them
after it::

    from repro_torch import spans
    spans.enable(True)
    ...                     # serve, fit, under torch.profiler or not
    spans.enable(False)
    records = spans.take()  # [(name, t0_ns, t1_ns, thread, ids), ...]

- ``span(name, **ids)`` is a context manager around one piece of work.
  Off, it returns one shared object that does nothing: a call costs a
  global read and a function call.  On, its exit appends ``(name, t0_ns,
  t1_ns, thread_ident, ids)``; ``ids`` is the keywords it was given.
- ``record(name, t0_ns, t1_ns, **ids)`` appends an interval whose start
  was stamped earlier by ``clock()`` (a request's wait in a queue).
- The clock is ``time.time_ns()``: the Unix-epoch nanoseconds that the
  profiler's host and device events carry.
- At most ``CAPACITY`` records are held; once full, each new record
  pushes out the oldest, and ``dropped`` counts them.  ``take()`` returns
  the records held and clears them and ``dropped``.  Recording threads
  share the records under one lock.

Spans nest by time on one thread: an enclosing span starts before and
ends after the spans inside it.  The names the port records are listed
in ``PERF.md`` (§3); ``bench/idle_by_span.py`` reads them against a
device trace.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Tuple

CAPACITY = 1 << 20

clock = time.time_ns

_on = False
_records: deque = deque(maxlen=CAPACITY)
_lock = threading.Lock()
dropped = 0


class _Off:
    """The span of a recorder that is off: enters and exits, records
    nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "ids", "t0")

    def __init__(self, name: str, ids: dict) -> None:
        self.name, self.ids = name, ids

    def __enter__(self):
        self.t0 = clock()
        return self

    def __exit__(self, *exc):
        record(self.name, self.t0, clock(), **self.ids)
        return False


def span(name: str, **ids):
    """A context manager timing the work inside it as span ``name``."""
    if not _on:
        return _OFF
    return _Span(name, ids)


def record(name: str, t0_ns: int, t1_ns: int, **ids) -> None:
    """Append the span ``name`` from ``t0_ns`` to ``t1_ns`` (``clock()``
    readings) on the calling thread."""
    global dropped
    item = (name, t0_ns, t1_ns, threading.get_ident(), ids)
    with _lock:
        if len(_records) == _records.maxlen:
            dropped += 1
        _records.append(item)


def enable(on: bool) -> None:
    """Turn recording on or off; records already held stay."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def take() -> List[Tuple[str, int, int, int, dict]]:
    """The records held, oldest first; clears them and ``dropped``."""
    global dropped
    with _lock:
        out = list(_records)
        _records.clear()
        dropped = 0
    return out
