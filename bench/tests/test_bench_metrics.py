"""The metrics' arithmetic on the CPU: the closed loop's window, the open
loop's tail from due times, the idle share and a roofline share from
synthetic traces, the discovery of cells, configurations, systems, mixes,
loops and metrics added as files, and the result line's keys.  The cells' own
readings need the card (``test_cells_read_on_the_card``)."""
import dataclasses
import json
import shutil
import time
import types

import numpy as np
import pytest
from torch.autograd import DeviceType

from conftest import BENCH, tiny_cell
from frozen import cost
from harness import cell as cell_mod
from harness import measure, spec, trace, traffic


class _Handle:
    def __init__(self, server):
        self.server, self.finished = server, False

    def done(self):
        return self.finished

    def result(self, timeout=None):
        if not self.finished:           # runs the whole queue as one bucket
            time.sleep(self.server.service)
            for h in self.server.pending:
                h.finished = True
            self.server.pending = []
        return types.SimpleNamespace(wall_s=self.server.service,
                                     batch_size=2)


class _Server:
    def __init__(self, service):
        self.service, self.pending = service, []


class _System:
    def __init__(self, service):
        self.server = _Server(service)

    def start(self):
        pass

    def stop(self):
        pass

    def submit(self, rid, pool):
        h = _Handle(self.server)
        self.server.pending.append(h)
        return h


def _run(window, config=None, trace_=None, chips=1):
    c = types.SimpleNamespace(config=config or {}, chips=chips)
    return types.SimpleNamespace(window=window, cell=c, trace=trace_,
                                 counters={})


def test_closed_window_closes_at_an_answer():
    mix = {"clients": 2, "pool": 3, "order": "cycle"}
    loop = spec.loop(types.SimpleNamespace(root=BENCH.parent,
                                           traffic={"loop": "closed"}))
    w = loop.drive(_System(0.05), mix, 1, 0.3)
    counted = [r for r in w.reqs if r.done <= w.close]
    assert w.close - w.start >= 0.3
    assert w.close in [r.done for r in w.reqs]
    assert len(counted) == len(w.reqs) and len(counted) % 2 == 0
    assert [r.pool for r in w.reqs][:4] == [0, 1, 2, 0]
    rate = measure.fits_per_s(_run(w))
    assert rate == pytest.approx(len(counted) / (w.close - w.start))
    assert 2 / 0.05 * 0.7 < rate <= 2 / 0.05


def _req(due, done, sent=None, ok=True, wall=0.1):
    r = traffic.Req(rid=0, pool=0, due=due, sent=due if sent is None
                    else sent, done=done)
    r.result = types.SimpleNamespace(wall_s=wall, batch_size=1) if ok \
        else None
    return r


def test_open_tail_is_taken_from_due_times():
    # the generator sent the last ten requests late: their wait counts
    reqs = [_req(k * 0.1, k * 0.1 + 0.2) for k in range(90)]
    reqs += [_req(9 + k * 0.1, 9 + k * 0.1 + 1.0, sent=9 + k * 0.1 + 0.9)
             for k in range(10)]
    w = traffic.Window(0.0, 10.0, reqs)
    lat = [0.2] * 90 + [1.0] * 10
    assert measure.latency_p95(_run(w)) == pytest.approx(
        float(np.percentile(lat, 95)))
    assert measure.queue_wait_p95(_run(w)) == pytest.approx(
        float(np.percentile([x - 0.1 for x in lat], 95)))
    # a request that never came counts as missing any limit
    reqs[-1].result = None
    assert measure.latency_p95(_run(w)) == pytest.approx(1.0)
    for r in reqs[-10:]:
        r.result = None
    assert measure.latency_p95(_run(w)) is None


class _Event:
    def __init__(self, name, start_ms, end_ms, device=DeviceType.CUDA):
        self._n, self._s, self._e, self._d = name, start_ms, end_ms, device

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._s * 1e6)

    def duration_ns(self):
        return int((self._e - self._s) * 1e6)

    def device_type(self):
        return self._d


def test_idle_share_of_overlapping_kernels():
    events = [_Event("void a<float>(int)", 0, 10), _Event("b", 5, 20),
              _Event("c", 30, 40),
              _Event("aten::mm", 20, 30, DeviceType.CPU),
              _Event("cudaLaunchKernel", 24, 26, DeviceType.CPU)]
    t = trace.reduce(events, 0.050)
    assert t.busy_s == pytest.approx(0.030)
    assert measure.idle_share(_run(None, trace_=t)) == pytest.approx(40.0)
    assert t.idle_gaps == [["cudaLaunchKernel", pytest.approx(0.010)]]
    assert t.device_ops[0] == ["b", pytest.approx(0.015)]


def test_roofline_share_from_known_shapes():
    m, n, p, rounds = 16, 1024, 4096, 300
    least = cost.least_seconds(*cost.round_block_work(m, n, p, 4, rounds,
                                                      False))
    ms = least * 1e3
    name = "void (anonymous namespace)::round_stream_kernel<float>(Args)"
    events = [_Event(name, 0, 2 * ms), _Event(name, 3 * ms, 5 * ms),
              _Event("void other<float>()", 5 * ms, 9 * ms)]
    t = trace.reduce(events, 1.0)
    run = _run(None, dict(m=m, n=n, p=p - 1, max_iter=rounds), t)
    share = spec.reader("round_roofline").read(run)
    assert share == pytest.approx(50.0, rel=1e-6)
    # the fit's mfu: 4 fits a second of 12 x 300 rounds at the fp32 peak
    w = traffic.Window(0.0, 1.0, [_req(0, 0.25 * k) for k in range(1, 5)])
    cfg = dict(m=m, n=n, p=p - 1, max_iter=rounds, grid_points=12)
    mfu = measure.fit_mfu(_run(w, cfg))
    assert mfu == pytest.approx(100 * 4 * 12 * rounds * 4 * m * n * p
                                / cost.PEAK_FP32, rel=1e-9)


def test_new_cell_config_mix_and_metric_are_found_as_files(tmp_path):
    """A later cell, configuration, mix and per-layer metric are new files
    and new entries: nothing that exists is edited."""
    root = tmp_path
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((root / "bench/configs/decsvm-table1.json").read_text())
    (root / "bench/configs/decsvm-table1-m12.json").write_text(
        json.dumps(dict(conf, name="decsvm-table1-m12", m=12)))
    (root / "bench/traffic/closed2_dense.json").write_text(json.dumps(
        {"loop": "closed", "clients": 2, "pool": 4, "engine": "dense",
         "mode": "batched", "max_batch": 2}))
    (root / "bench/limits/table1.m12.json").write_text(json.dumps(
        {"est_gap": 1e-3, "hinge_gap": 1e-4, "supp_gap": 3.0}))
    (root / "bench/metrics/bucket_count.m12.py").write_text(
        "UNIT = 'buckets'\n\ndef read(run):\n    return 7.0\n")
    bench["configs"].append({"name": "decsvm-table1-m12", "source": "x",
                             "file": "bench/configs/decsvm-table1-m12.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "table1.m12",
                               "config": "decsvm-table1-m12",
                               "traffic": "closed2_dense", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "bucket_count.m12", "unit": "buckets",
                               "better": "lower", "source": "host_clock",
                               "layer": "fit serving", "moves": "fits_per_s",
                               "workloads": ["table1.m12"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    c = spec.find("table1.m12", root=root)
    assert c.config["m"] == 12 and c.traffic["clients"] == 2
    assert [m["name"] for m in c.end_to_end] == ["fits_per_s", "setup_s"]
    assert [m["name"] for m in c.per_layer] == ["bucket_count.m12"]
    assert spec.reader("bucket_count.m12", root).read(None) == 7.0
    assert all(p.read_bytes() == b for p, b in before.items())


ECHO_SYSTEM = '''"""A system that doubles numbers, on one chip or across four."""
CHIPS = (1, 4)


def make_inputs(config, mix, seed, device):
    return [seed + k for k in range(int(mix["pool"]))]


class _Handle:
    def __init__(self, value):
        self.value = value

    def done(self):
        return True

    def result(self, timeout=None):
        return self.value


class System:
    def __init__(self, config, mix, made, device):
        self.made, self.factor = made, config["factor"]

    def submit(self, rid, index):
        return _Handle(self.made[index] * self.factor)


def counters():
    return {"doubled": 0}


def answer(result, index):
    return (index, result)


def judge(config, limits, made, answers, failed):
    wrong = sum(1 for i, v in answers if v != 2 * made[i])
    return ({"wrong": float(wrong), "failed": float(failed)},
            {"wrong": 0.0, "failed": 0.0}, f"{len(answers)} answers checked")
'''

BURST_LOOP = '''"""All of the pool's requests at once, then the window closes."""
from harness.traffic import Req, Window, clock, wait


def drive(system, mix, seed, seconds):
    start = clock()
    reqs = [Req(rid=k, pool=k, due=start, sent=start)
            for k in range(int(mix["pool"]))]
    for r in reqs:
        wait(r, system.submit(r.rid, r.pool))
    return Window(start, max(r.done for r in reqs), reqs)


def warm_up(system, mix):
    system.submit(-1, 0).result()
'''


def test_new_system_and_loop_are_found_as_files(tmp_path):
    """A later system under test (with its own inputs, answers, comparison
    and chip counts) and a later kind of loop are new files, which a
    configuration and a mix name: nothing that exists is edited, and a
    cell of them runs through the harness."""
    root = tmp_path
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    (root / "bench/systems/echo.py").write_text(ECHO_SYSTEM)
    (root / "bench/loops/burst.py").write_text(BURST_LOOP)
    (root / "bench/configs/echo-x2.json").write_text(json.dumps(
        {"name": "echo-x2", "system": "echo", "factor": 2}))
    (root / "bench/traffic/burst5.json").write_text(json.dumps(
        {"loop": "burst", "pool": 5}))
    for cell in ("echo.one", "echo.four"):
        (root / f"bench/limits/{cell}.json").write_text("{}")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "echo-x2", "source": "x",
                             "file": "bench/configs/echo-x2.json",
                             "reduced": [], "why": "x"})
    for cell, chips in (("echo.one", 1), ("echo.four", 4)):
        bench["workloads"].append({"name": cell, "config": "echo-x2",
                                   "traffic": "burst5", "chips": chips,
                                   "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    one, four = (spec.find(c, root=root) for c in ("echo.one", "echo.four"))
    assert cell_mod.refusal(one, 1) is None
    assert cell_mod.refusal(four, 4) is None
    assert "needs 4" in cell_mod.refusal(four, 1)
    gisette = spec.find("gisette.dense", root=root)
    assert "runs on (1,)" in cell_mod.refusal(
        dataclasses.replace(gisette, chips=4), 4)
    line, report = cell_mod.execute(one, 40, 0.1, False, "cpu",
                                    traffic.clock())
    assert line["correct"] is True and line["attempted"] == 5
    assert set(line["metrics"]) == {"fits_per_s", "setup_s"}
    assert line["compared"] == {"wrong": {"value": 0.0, "limit": 0.0},
                                "failed": {"value": 0.0, "limit": 0.0}}
    assert "5 answers checked" in report[0]
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_suffixed_metric_shares_its_base_reader():
    """``idle_share.open`` has no file of its own: ``idle_share.py`` reads
    it; a metric with a file of its own keeps it."""
    assert spec.reader("idle_share.open") is spec.reader("idle_share")
    assert spec.reader("round_roofline.open") is spec.reader("round_roofline")
    assert spec.reader("fit_mfu.open") is not spec.reader("fit_mfu")
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric.open")


def test_every_reader_names_its_benchmark_unit():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert spec.reader(m["name"]).UNIT == m["unit"], m["name"]


def test_result_line_keys():
    c = tiny_cell("gisette.dense", pool=2, clients=2, max_batch=2)
    line, report = cell_mod.execute(c, 2 ** 40 + 5, 0.5, True, "cpu",
                                    traffic.clock())
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "compared"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes", "busy_s",
                                   "window_s"}
    assert line["correct"] is True and line["failed"] == 0
    assert all(set(v) == {"value", "limit"}
               for v in line["compared"].values())
    assert report[-len(line["compared"]):] == [
        f"compared {k} = {v['value']!r} (limit {v['limit']!r})"
        for k, v in line["compared"].items()]
    json.dumps(line)


CELLS = [w["name"] for w in json.loads(
    (BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cells_read_on_the_card(cuda, name):
    """Each cell at a short window on the card: correct, and every metric
    it lists read, untraced and traced."""
    c = spec.find(name)
    if c.chips > 1:
        pytest.skip("a four-chip cell runs across ranks")
    for traced, metrics in ((False, c.end_to_end), (True, c.per_layer)):
        line, _ = cell_mod.execute(c, 2 ** 35 + 11, 4.0, traced, cuda,
                                   traffic.clock())
        assert line["correct"] is True, line["compared"]
        assert set(line["metrics"]) == {m["name"] for m in metrics}
        for m in line["metrics"].values():
            assert np.isfinite(m["value"]) and m["value"] > 0
