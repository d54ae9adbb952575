"""The port's host spans (``repro_torch.spans``): off by default and
recording nothing, the spans of a dense bucket of ``DecsvmFitServer``
with their counts and nesting, the clock they share with
``torch.profiler``'s events, and the recorder's bound.  The ``cuda`` case
checks on the card that each grid point's span holds the launch of its
round kernel.  No jax: the port alone."""
import collections
import sys
import threading

import pytest
import torch

from repro_torch import spans
from repro_torch.core import ADMMConfig, SimConfig, generate
from repro_torch.core.graph import erdos_renyi
from repro_torch.core.tuning import lambda_grid
from repro_torch.serving import DecsvmFitServer, FitRequest
from _torch_cases import one_thread  # noqa: F401

B, L = 3, 4


@pytest.fixture
def recorder():
    """The recorder off and empty before and after the test."""
    spans.enable(False)
    spans.take()
    yield spans
    spans.enable(False)
    spans.take()


def _requests(device="cpu", max_iter=20):
    sim = SimConfig(p=12, s=3, m=4, n=40, rho=0.5, mu=0.5)
    cfg = ADMMConfig(lam=0.0, max_iter=max_iter, backend="megakernel")
    out = []
    for k in range(B):
        X, y, _ = generate(sim, seed=k)
        W = erdos_renyi(sim.m, 0.7, seed=k)
        if k == 0:
            lams = lambda_grid(X, y, num=L)
        out.append(FitRequest(rid=10 + k, X=X, y=y, W=W, cfg=cfg, lams=lams,
                              mode="batched", engine="dense"))
    return out


def _serve(reqs, device="cpu"):
    server = DecsvmFitServer(max_batch=B, device=device)
    handles = [server.submit(r) for r in reqs]
    return server, [h.result() for h in handles]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_off_records_nothing_and_on_leaves_the_answers(recorder):
    reqs = _requests()
    assert not recorder.enabled()
    _, off = _serve(reqs)
    assert recorder.take() == []
    assert recorder.span("x") is recorder.span("y", b=1)
    recorder.enable(True)
    _, on = _serve(reqs)
    assert recorder.take()
    for a, b in zip(off, on):
        assert a.best_lam == b.best_lam and a.table == b.table
        assert (a.B == b.B).all() and (a.beta == b.beta).all()
        assert a.train_accuracy == b.train_accuracy
        assert a.consensus_gap == b.consensus_gap


def test_a_dense_bucket_records_its_spans(recorder):
    reqs = _requests()
    recorder.enable(True)
    server, _ = _serve(reqs)
    recorder.enable(False)
    got = recorder.take()
    by = collections.defaultdict(list)
    for s in got:
        by[s[0]].append(s)
    counts = {k: len(v) for k, v in by.items()}
    assert counts == {"serve.queue": B, "serve.bucket": 1, "serve.stack": 1,
                      "path.problem": B, "solver.rho": B,
                      "solver.kernel_x": B, "path.point": B * L,
                      "path.score": B, "path.tables": 1, "serve.margins": 1,
                      "serve.deliver": 1}
    bucket = by["serve.bucket"][0]
    assert bucket[4] == {"bucket": 1, "size": B, "engine": "dense"}
    assert server.bucket_log[-1][1] == B
    # each request waited from submit to the bucket's start
    assert sorted(s[4]["rid"] for s in by["serve.queue"]) == \
        [r.rid for r in reqs]
    for q in by["serve.queue"]:
        assert q[4]["bucket"] == 1 and q[1] <= q[2] <= bucket[1]
    # every work span lies inside the bucket, on its thread
    for s in got:
        if s[0] not in ("serve.queue", "serve.bucket"):
            assert _inside(s, bucket) and s[3] == bucket[3], s
    problems = sorted(by["path.problem"], key=lambda s: s[1])
    assert [p[4] for p in problems] == [{"b": b} for b in range(B)]
    for name, each in (("path.point", L), ("path.score", 1),
                       ("solver.rho", 1), ("solver.kernel_x", 1)):
        for p in problems:
            assert sum(_inside(s, p) for s in by[name]) == each, name
    for name in ("serve.stack", "path.tables", "serve.margins",
                 "serve.deliver"):
        assert not any(_inside(by[name][0], p) for p in problems)
    order = ["serve.stack", "path.tables", "serve.margins", "serve.deliver"]
    starts = [by[n][0][1] for n in order]
    assert starts == sorted(starts) and starts[0] < problems[0][1]


def test_spans_share_the_profilers_clock(recorder):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(256, 256)
    recorder.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recorder.span("op"):
            x @ x
    (name, t0, t1, _, ids), = recorder.take()
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm" and e.device_type() == DeviceType.CPU]
    assert name == "op" and ids == {} and len(mm) == 1
    start = mm[0].start_ns()
    end = start + mm[0].duration_ns()
    slack = 50_000
    assert t0 - slack <= start <= end <= t1 + slack


def test_the_bound_drops_the_oldest_and_counts_them(recorder, monkeypatch):
    monkeypatch.setattr(recorder, "_records", collections.deque(maxlen=3))
    recorder.enable(True)
    for k in range(5):
        recorder.record("r", k, k + 1, k=k)
    with recorder.span("s", k=5):
        pass
    assert recorder.dropped == 3
    got = recorder.take()
    assert [s[4]["k"] for s in got] == [3, 4, 5]
    assert got[0][:3] == ("r", 3, 4) and got[-1][0] == "s"
    assert recorder.dropped == 0 and recorder.take() == []
    assert recorder.CAPACITY == 1 << 20


def test_threads_lose_no_record(recorder, monkeypatch):
    """Threads recording at once, past the bound: every record is held or
    counted as dropped."""
    threads, each = 16, 2000
    monkeypatch.setattr(recorder, "_records",
                        collections.deque(maxlen=threads * each // 2))
    recorder.enable(True)
    start = threading.Barrier(threads)

    def work():
        start.wait(timeout=30)
        for k in range(each):
            with recorder.span("w", k=k):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in pool)
    dropped = recorder.dropped
    held = recorder.take()
    assert len(held) == threads * each // 2
    assert len(held) + dropped == threads * each
    assert len({s[3] for s in held}) > 1


@pytest.mark.cuda
def test_each_grid_points_span_holds_its_round_kernels_launch(recorder):
    """On the card, under ``torch.profiler``: each ``path.point`` span
    holds the host launch of one round-kernel launch, and the kernel
    starts after its launch does (one clock for spans, host and device
    events)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the round kernel has no CPU mode)")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reqs = _requests(max_iter=300)
    _serve(reqs, "cuda")                        # builds and warms the kernel
    recorder.enable(True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _serve(reqs, "cuda")
        torch.cuda.synchronize()
    recorder.enable(False)
    points = [s for s in recorder.take() if s[0] == "path.point"]
    events = prof.profiler.kineto_results.events()
    launches = {e.correlation_id(): e for e in events
                if e.device_type() == DeviceType.CPU
                and e.name().startswith("cudaLaunch")}
    kernels = [e for e in events if e.device_type() == DeviceType.CUDA
               and "round_stream_kernel" in e.name()]
    assert len(points) == B * L and len(kernels) == B * L
    held = collections.Counter()
    for k in kernels:
        launch = launches.get(k.correlation_id()) or launches.get(
            k.linked_correlation_id())
        assert launch is not None, k.name()
        assert launch.start_ns() <= k.start_ns()
        inside = [i for i, p in enumerate(points)
                  if p[1] <= launch.start_ns()
                  and launch.start_ns() + launch.duration_ns() <= p[2]]
        assert len(inside) == 1
        held[inside[0]] += 1
    assert sorted(held) == list(range(B * L))
