"""Readings of the comparison that decides ``correct``, from which its
limits are set: the program's, over many seeds in one process, and the
control's.

    python3 bench/readings.py --workload <cell> --seconds <s> \
        --seeds <n> ... [--control-seeds <n> ...]

The program's readings are whole runs of the cell (``harness.cell``) at a
short window.  The control is the reference put in the program's place
and computed in the precision below the configuration's, as the cell's
system module's ``control`` gives it (for ``decsvm_fit``: TF32 for fp32
with TF32 off, every dataset of the seed's pool answered by
``reference.<name>.tuned_paths(tf32=True)`` and judged against the fp32
reference as the program's answers are).  One JSON line per reading; the benchmark's
own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    import torch
    from harness import cell as cell_mod
    from harness import spec, traffic

    cell = spec.find(args.workload)
    for seed in args.seeds:
        line, report = cell_mod.execute(cell, seed, args.seconds, False,
                                        args.device, traffic.clock())
        print(json.dumps({"side": "program", "seed": seed,
                          "attempted": line["attempted"],
                          "failed": line["failed"],
                          "compared": {k: v["value"] for k, v in
                                       line["compared"].items()}}),
              flush=True)
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        nums = spec.system(cell).control(cell.config, cell.limits,
                                         cell.traffic, seed,
                                         torch.device(args.device))
        print(json.dumps({"side": "control", "seed": seed, "compared": nums,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
