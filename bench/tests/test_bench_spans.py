"""The device's idle time put down to the program's host spans
(``harness.host_spans``) on synthetic traces, and ``bench/idle_by_span.py``
rehearsed on the CPU at a tiny size."""
import types

import numpy as np
import pytest
from torch.autograd import DeviceType

from conftest import tiny_cell
from harness import host_spans, measure, trace, traffic

MS = 1_000_000      # ns


class _Event:
    def __init__(self, name, start_ms, end_ms, device=DeviceType.CUDA):
        self._n, self._s, self._e, self._d = name, start_ms, end_ms, device

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._s * MS)

    def duration_ns(self):
        return int((self._e - self._s) * MS)

    def device_type(self):
        return self._d


def _span(name, start_ms, end_ms, thread=1, **ids):
    return (name, start_ms * MS, end_ms * MS, thread, ids)


def _spans_trace():
    """A window of 0-100 ms: the device busy 10-20, 30-35 and 60-90 ms;
    a bucket from 5 to 70 ms holding one problem (8-50) with one grid
    point (25-45) inside it; a request queued 0-5 ms; a span of another
    thread over the whole window."""
    t = trace.reduce([_Event("k", 10, 20), _Event("k", 30, 35),
                      _Event("k", 60, 90)], 0.100)
    spans = [_span("serve.queue", 0, 5, rid=7, bucket=1),
             _span("path.point", 25, 45), _span("path.problem", 8, 50, b=0),
             _span("serve.bucket", 5, 70, bucket=1, size=1),
             _span("client", 0, 100, thread=2)]
    return t, spans


def test_idle_is_put_down_to_the_innermost_span():
    t, spans = _spans_trace()
    by = dict(host_spans.idle_by_span(t, 0, spans))
    # idle: 0-10, 20-30, 35-60, 90-100 ms
    assert by == {"outside any span": pytest.approx(0.005 + 0.010),
                  "serve.bucket": pytest.approx(0.003 + 0.010),
                  "path.problem": pytest.approx(0.002 + 0.005 + 0.005),
                  "path.point": pytest.approx(0.005 + 0.010)}
    gaps = host_spans.idle(t, 0)
    assert int(np.sum(gaps[:, 1] - gaps[:, 0])) == 55 * MS
    assert sum(by.values()) == pytest.approx(0.055, abs=1e-12)
    # the waiting request and the other thread's span take no idle time
    assert "serve.queue" not in by and "client" not in by


def test_operations_outside_the_window_are_cut_at_its_edges():
    t = trace.reduce([_Event("k", -5, 10), _Event("k", 95, 120)], 0.100)
    gaps = host_spans.idle(t, 0)
    assert gaps.tolist() == [[10 * MS, 95 * MS]]


def test_bucket_and_front_idle_shares_sum_to_the_idle_share():
    t, spans = _spans_trace()
    inside = host_spans.bucket_idle_share(t, 0, spans)
    front = host_spans.front_idle_share(t, 0, spans)
    assert inside == pytest.approx(100 * (0.005 + 0.010 + 0.025) / 0.100)
    run = types.SimpleNamespace(trace=t)
    assert abs(inside + front - measure.idle_share(run)) < 1e-9
    # overlapping operations, and a bucket that starts in a busy stretch
    t = trace.reduce([_Event("a", 0, 10), _Event("b", 5, 20),
                      _Event("c", 30, 40)], 0.050)
    spans = [_span("serve.bucket", 15, 35)]
    inside = host_spans.bucket_idle_share(t, 0, spans)
    assert inside == pytest.approx(100 * 0.010 / 0.050)
    assert abs(inside + host_spans.front_idle_share(t, 0, spans)
               - 40.0) < 1e-9


def _req(rid, done):
    r = traffic.Req(rid=rid, pool=0, due=0.0, sent=0.0, done=done)
    r.result = types.SimpleNamespace(wall_s=0.1, batch_size=1)
    return r


def test_bucket_wait_reads_the_queue_span_of_answered_requests():
    reqs = [_req(0, 1.0), _req(1, 2.0), _req(2, 9.0)]
    spans = [_span("serve.queue", 0, 10 * (k + 1), rid=k, bucket=1)
             for k in range(3)] + [_span("serve.queue", 0, 900, rid=-1)]
    w = traffic.Window(0.0, 5.0, reqs)
    assert host_spans.bucket_wait_p95_s(w, spans) == pytest.approx(
        float(np.percentile([0.010, 0.020], 95)))


def test_no_spans_no_reading():
    t, _ = _spans_trace()
    w = traffic.Window(0.0, 1.0, [_req(0, 0.5)])
    for spans in (None, []):
        assert host_spans.bucket_wait_p95_s(w, spans) is None
        assert host_spans.bucket_idle_share(t, 0, spans) is None
        assert host_spans.front_idle_share(t, 0, spans) is None
    # nor from a trace without device operations
    _, spans = _spans_trace()
    empty = trace.reduce([], 0.1)
    assert host_spans.front_idle_share(empty, 0, spans) is None


@pytest.mark.parametrize("traced", [False, True])
def test_idle_by_span_rehearsal(traced):
    import idle_by_span
    from repro_torch import spans
    c = tiny_cell("table1.closed", pool=8, clients=4, max_batch=4)
    c.config = dict(c.config, max_iter=60)
    out = idle_by_span.run(c, 2 ** 41 + 17, 1.0, traced, "cpu")
    assert out["correct"] is True and out["failed"] == 0
    assert out["spans"] > 0 and out["dropped"] == 0
    assert out["bucket_wait_p95_s"] >= 0.0
    assert not spans.enabled() and spans.take() == []
    if traced:
        # the CPU traces no device operation: the whole window is idle,
        # every second of it under a span or outside them
        by = dict(out["idle_by_span"])
        assert sum(by.values()) == pytest.approx(out["window_s"], abs=1e-6)
        assert out["idle_s"] == pytest.approx(out["window_s"], abs=1e-6)
        assert by.get("path.point", 0.0) > 0.0
        assert out["bucket_idle_share"] is None
    else:
        assert "idle_by_span" not in out
