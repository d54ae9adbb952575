"""One run of a cell in one process: set-up, warm-up, the measured window,
the comparison with the reference, the metrics and the result line.

The system under test, its inputs and its comparison come from the
system module that the cell's configuration names, and the traffic from
the loop module that its mix names (``harness.spec``).  ``execute`` runs
on the device it is given; ``bench/run.py`` gives it the card and refuses
to start without one, and the CPU tests give it the CPU at a tiny size.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
from typing import Dict, List, Optional, Tuple

import torch

from harness import spec, trace, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    cell: spec.Cell
    seed: int
    seconds: float
    setup_s: float
    window: traffic.Window
    counters: Dict[str, int]        # the program's counters in the window
    trace: Optional[trace.Trace]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (``repro``), compared whole: ``repro_torch`` is not one."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def refusal(cell: spec.Cell, cards: int) -> Optional[str]:
    """Why this machine, with ``cards`` CUDA devices, cannot run ``cell``;
    None where it can.  The chip counts a cell may ask for are its system
    module's ``CHIPS``."""
    if cards < cell.chips:
        return (f"{cell.name} needs {cell.chips} CUDA device(s); this "
                f"machine has {cards}")
    chips = spec.system(cell).CHIPS
    if cell.chips not in chips:
        return (f"{cell.name} asks for {cell.chips} chips; its system "
                f"{cell.config['system']!r} runs on {chips}")
    return None


def execute(cell: spec.Cell, seed: int, seconds: float, traced: bool,
            device, started: float) -> Tuple[dict, List[str]]:
    """Run ``cell`` once; returns the result line (a dict) and the report
    lines for standard error.  ``started`` is the process's start on
    ``traffic.clock``."""
    sut_mod, loop = spec.system(cell), spec.loop(cell)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    marks = [traffic.clock()]
    made = sut_mod.make_inputs(cell.config, cell.traffic, seed, dev)
    if cuda:
        torch.cuda.synchronize(dev)
    marks.append(traffic.clock())
    sut = sut_mod.System(cell.config, cell.traffic, made, dev)
    loop.warm_up(sut, cell.traffic)
    if cuda:
        torch.cuda.synchronize(dev)
    marks.append(traffic.clock())
    setup_s = marks[-1] - started

    before = sut_mod.counters()
    with trace.Tracer(traced, dev) as tracer:
        window = loop.drive(sut, cell.traffic, seed, seconds)
    after = sut_mod.counters()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    run = Run(cell=cell, seed=seed, seconds=seconds, setup_s=setup_s,
              window=window,
              counters={k: after[k] - before[k] for k in after},
              trace=tracer.trace)
    del sut
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    answers = [sut_mod.answer(r.result, r.pool) for r in window.reqs
               if r.result is not None]
    failed = len(window.reqs) - len(answers)
    nums, limits, judged = sut_mod.judge(cell.config, cell.limits, made,
                                         answers, failed)
    ok = all(nums[k] <= limits[k] for k in limits)

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(m["name"], cell.root).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_line = {"platform": "gpu" if cuda else dev.type,
                "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    line = {"correct": ok, "attempted": len(window.reqs), "failed": failed,
            "metrics": metrics, "device": dev_line}
    if run.trace is not None:
        dev_line["busy_s"] = run.trace.busy_s
        dev_line["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": run.trace.device_ops,
                             "idle_gaps": run.trace.idle_gaps}
    line["compared"] = {k: {"value": nums[k], "limit": limits[k]}
                        for k in limits}
    late = max((r.sent - r.due for r in window.reqs), default=0.0)
    report = [f"cell {cell.name} seed {seed}: {len(window.reqs)} requests, "
              f"{len(answers)} answered, generator late by at most "
              f"{late:.4f} s, {judged}, counters {run.counters}",
              f"setup {setup_s:.3f} s: start to the cell "
              f"{marks[0] - started:.3f} s, inputs {marks[1] - marks[0]:.3f} s,"
              f" system and warm-up {marks[2] - marks[1]:.3f} s"]
    report += [f"compared {k} = {nums[k]!r} (limit {limits[k]!r})"
               for k in limits]
    return line, report
