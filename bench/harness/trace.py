"""The device trace of a ``--trace 1`` run: ``torch.profiler`` (CUPTI) over
the whole measured window, reduced to the device's operations (kernels,
copies, fills) and the host's operations beside them.

- ``busy_s``: the union of the device operations' intervals, in seconds;
  ``window_s``: the traced window on the host's clock.
- ``kernels``: each device operation as (name, start ns, end ns).
- ``device_ops``: the ten device operations that took most time, by name.
- ``idle_gaps``: the device's idle time between operations, summed by
  what the host was doing at each gap's midpoint (the innermost host
  operation under way there, on any thread), the ten largest.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from collections import defaultdict
from typing import List, Optional, Tuple

import numpy as np
import torch

GAPS_NAMED = 4000      # the longest gaps that are named; the rest summed
NO_HOST_OP = "no host op (Python between calls, or waiting)"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, int, int]]
    device_ops: List[list]
    idle_gaps: List[list]

    def launches(self, names) -> List[Tuple[str, int, int]]:
        """The device operations whose name starts with one of ``names``
        (a kernel's name as the trace gives it, without its template
        arguments)."""
        names = tuple(names)
        return [k for k in self.kernels if _base(k[0]).startswith(names)]


@functools.lru_cache(maxsize=4096)
def _base(name: str) -> str:
    """A demangled kernel name without its return type, namespaces' and
    templates' decoration and arguments: ``void (anonymous
    namespace)::round_stream_kernel<float>(Args<float>)`` ->
    ``round_stream_kernel``; other names (``Memcpy DtoD (Device ->
    Device)``) as they are."""
    text = name.replace("(anonymous namespace)::", "")
    plain, depth = [], 0
    for ch in text:
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif not depth:
            plain.append(ch)
    head = "".join(plain).split("(")[0].strip()
    if not head or (" " in head and not head.startswith(("void ", "std::"))
                    and "::" not in head):
        return name
    return head.split(" ")[-1]


def union_seconds(intervals: np.ndarray) -> Tuple[float, np.ndarray]:
    """Total length of the union of (start, end) ns intervals, and the
    merged intervals."""
    if len(intervals) == 0:
        return 0.0, np.zeros((0, 2), np.int64)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    first = np.flatnonzero(np.r_[True, iv[1:, 0] > reach[:-1]])
    last = np.r_[first[1:] - 1, len(iv) - 1]
    merged = np.stack([iv[first, 0], reach[last]], axis=1)
    return float(np.sum(merged[:, 1] - merged[:, 0])) * 1e-9, merged


def _named_gaps(merged: np.ndarray, host: List[Tuple[str, int, int]]):
    if len(merged) < 2:
        return []
    gap_s, gap_e = merged[:-1, 1], merged[1:, 0]
    length = gap_e - gap_s
    order = np.argsort(-length, kind="stable")
    named = order[:GAPS_NAMED]
    by_name = defaultdict(float)
    if len(order) > GAPS_NAMED:
        by_name["shorter gaps"] += float(np.sum(length[order[GAPS_NAMED:]])) \
            * 1e-9
    host = sorted(host, key=lambda h: h[1])
    starts = np.asarray([h[1] for h in host], np.int64)
    for g in named:
        mid = (gap_s[g] + gap_e[g]) // 2
        i = int(np.searchsorted(starts, mid, side="right")) - 1
        name = NO_HOST_OP
        for j in range(i, max(-1, i - 400), -1):
            if host[j][2] >= mid:
                name = host[j][0]
                break
        by_name[name] += float(length[g]) * 1e-9
    return sorted(([k, v] for k, v in by_name.items()),
                  key=lambda kv: -kv[1])[:10]


class Tracer:
    """Profiles what runs inside it when ``on``; ``trace`` is then the
    reduced ``Trace`` (None when off)."""

    def __init__(self, on: bool, device) -> None:
        self.on = on
        self.cuda = torch.device(device).type == "cuda"
        self.trace: Optional[Trace] = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.cuda else [])
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        if self.cuda:
            torch.cuda.synchronize()
        window = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        self.trace = reduce(self._prof.profiler.kineto_results.events(),
                            window)
        del self._prof
        return False


def reduce(events, window_s: float) -> Trace:
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in events:
        item = (e.name(), int(e.start_ns()), int(e.start_ns())
                + int(e.duration_ns()))
        if e.device_type() == DeviceType.CUDA:
            dev.append(item)
        elif e.device_type() == DeviceType.CPU:
            host.append(item)
    iv = np.asarray([[s, e] for _, s, e in dev], np.int64).reshape(-1, 2)
    busy, merged = union_seconds(iv)
    total = defaultdict(float)
    for name, s, e in dev:
        total[_base(name)] += (e - s) * 1e-9
    ops = sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])
    return Trace(window_s=window_s, busy_s=busy, kernels=dev,
                 device_ops=ops[:10], idle_gaps=_named_gaps(merged, host))
