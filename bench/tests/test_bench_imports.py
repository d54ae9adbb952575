"""Nothing that the benchmark runs imports JAX, flax or the JAX package
(``repro``), and its reference imports nothing of the program
(``repro_torch``).  Top-level names are compared whole: ``repro_torch``
begins with ``repro`` and is not it."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

# every module a cell's run imports, in a fresh interpreter: the harness,
# the program's entry, each cell's readers and references
PROBE = """
import json, sys
sys.path[:0] = [{bench!r}, {src!r}]
from harness import cell, measure, spec, trace, traffic
import repro_torch.serving.fit, repro_torch.kernels.ops
import importlib
bench = json.load(open({root!r} + "/BENCHMARK.json"))
for w in bench["workloads"]:
    c = spec.find(w["name"])
    spec.system(c), spec.loop(c)
    importlib.import_module("reference." + c.config["reference"])
    for m in c.end_to_end + c.per_layer:
        spec.reader(m["name"])
import torch.profiler
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_a_cells_run_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(bench=str(BENCH),
                                            src=str(ROOT / "src"),
                                            root=str(ROOT))],
        capture_output=True, text=True, timeout=300, check=True)
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}, names


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = set(_top_level_imports(path))
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax",
                        "harness"}, names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_benchmark_file_imports_jax(path):
    assert not set(_top_level_imports(path)) & {"jax", "jaxlib", "flax",
                                                "repro"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    from harness import cell
    before = cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro_torch_probe", object())
    monkeypatch.setitem(sys.modules, "reprox.core", object())
    assert cell.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro" in cell.forbidden_modules()
