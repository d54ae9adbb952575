"""A rehearsal of each one-chip cell on the CPU at a tiny size, through the
program's plain path and the reference, and the harness's refusals: its
real mode needs the card and never falls back to the CPU, and it cannot
run from the benchmark's own files alone."""
import json
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, tiny_cell
from harness import cell as cell_mod
from harness import traffic

# each cell cut to a tiny size; ``open`` drives table1's configuration
# through the open loop and the server's worker thread, which the mix
# ``open_fixed_gaps`` names for a later open-loop cell
MIXES = {"gisette.dense": ("gisette.dense",
                           dict(pool=3, clients=2, max_batch=2)),
         "table1.closed": ("table1.closed",
                           dict(pool=8, clients=4, max_batch=4)),
         "open": ("table1.closed",
                  dict(loop="open", rate_per_s=6.0, pool=8, max_batch=4))}


@pytest.mark.parametrize("name", sorted(MIXES))
@pytest.mark.parametrize("traced", [False, True])
def test_cell_rehearsal(name, traced):
    cell, mix = MIXES[name]
    c = tiny_cell(cell, **mix)
    c.config = dict(c.config, max_iter=60)
    line, report = cell_mod.execute(c, 2 ** 41 + 17, 1.0, traced, "cpu",
                                    traffic.clock())
    assert line["correct"] is True, line["compared"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    names = set(line["metrics"])
    if traced:
        # the device's readings are left out: the CPU traces no kernel
        assert "breakdown" in line and line["device"]["busy_s"] == 0.0
        assert names <= {m["name"] for m in c.per_layer}
    else:
        assert names == {m["name"] for m in c.end_to_end}
    assert "datasets checked" in report[0]


def _bench(args, cwd):
    return subprocess.run([sys.executable, "bench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = _bench(["--workload", "gisette.dense", "--seed", "1",
                  "--seconds", "1", "--trace", "0"], BENCH.parent)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_the_benchmark_alone_cannot_run(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    out = _bench(["--workload", "table1.closed", "--seed", "3",
                  "--seconds", "1", "--trace", "1"], tmp_path)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_unknown_cell_is_refused():
    out = _bench(["--workload", "no.such", "--seed", "1", "--seconds", "1"],
                 BENCH.parent)
    assert out.returncode != 0 and "no workload" in out.stderr
    json.loads((BENCH.parent / "BENCHMARK.json").read_text())
