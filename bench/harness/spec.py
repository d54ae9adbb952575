"""What a cell is, found by name from ``BENCHMARK.json``, and the files
that run it, found by the names that the cell's files give.

- ``BENCHMARK.json`` names the cell's configuration and traffic mix.
- The configuration's ``file`` holds its sizes and settings, and names
  its system by ``"system"``: ``bench/systems/<system>.py``, the system
  under test with its inputs, its counters and the comparison that
  decides ``correct`` (``systems/decsvm_fit.py`` says what it gives).
- The mix is ``bench/traffic/<traffic>.json``; it names its loop by
  ``"loop"``: ``bench/loops/<loop>.py``.
- The limits of the comparison are ``bench/limits/<cell>.json``.
- Each metric is read by ``bench/metrics/<metric>.py``; a metric that has
  no file of its own and whose name has a dot, as
  ``<base>.<suffix>``, is read by ``<base>``'s file: the same reading in
  cells that report another end-to-end metric.

A later cell, configuration, system, traffic mix, loop or metric is a new
file and a new entry, never an edit.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: List[dict]     # the cell's end-to-end metrics
    per_layer: List[dict]      # the cell's per-layer metrics
    root: Path = ROOT          # the checkout whose files run it


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _for_cell(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    # without the key an end-to-end metric is every cell's, and a per-layer
    # metric is read wherever the end-to-end metric it moves is reported
    return "moves" not in metric or metric["moves"] in e2e_names


def find(name: str, bench: Optional[dict] = None,
         root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``) with its
    files read; raises ``KeyError`` for a name it does not hold."""
    bench = load_json(root / "BENCHMARK.json") if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(it has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _for_cell(m, name, ())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _for_cell(m, name, e2e_names)]
    return Cell(name=name, chips=int(w["chips"]), config_name=conf["name"],
                config=load_json(root / conf["file"]),
                traffic_name=w["traffic"],
                traffic=load_json(root / "bench" / "traffic"
                                  / f"{w['traffic']}.json"),
                limits=load_json(root / "bench" / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer, root=root)


@functools.lru_cache(maxsize=None)
def _load(path: Path, prefix: str) -> ModuleType:
    """The module in the file ``path``, loaded once (a name may hold dots
    and dashes, so it is loaded by its path, not imported)."""
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark has no {path}")
    safe = "".join(ch if ch.isalnum() else "_" for ch in path.stem)
    spec = importlib.util.spec_from_file_location(f"{prefix}_{safe}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def system(cell: Cell) -> ModuleType:
    """The system module the cell's configuration names."""
    return _load(cell.root / "bench" / "systems"
                 / f"{cell.config['system']}.py", "bench_system")


def loop(cell: Cell) -> ModuleType:
    """The loop module the cell's mix names."""
    return _load(cell.root / "bench" / "loops"
                 / f"{cell.traffic['loop']}.py", "bench_loop")


def reader(metric: str, root: Path = ROOT) -> ModuleType:
    """The reader module of ``metric``: ``bench/metrics/<metric>.py``, or,
    where that file is missing, that of the name up to its last dot."""
    folder = root / "bench" / "metrics"
    path = folder / f"{metric}.py"
    if not path.is_file() and "." in metric:
        path = folder / f"{metric.rsplit('.', 1)[0]}.py"
    return _load(path, "bench_metric")
