"""The sweep that finds the highest rate an open-loop cell sustains: the
cell run at each of ``--rates`` (its mix's other parameters as they are),
in one process, with each run's latency and backlog.

    python3 bench/sweep.py --workload table1.closed --traffic open_fixed_gaps \
        --seconds 30 --rates 7 8 9 10 11 12 13

(``--traffic`` puts an open-loop mix of ``bench/traffic/`` in the place of
the cell's own.)

A rate is sustained when the requests due in the window's last quarter
wait no longer than those of its first (``growth_s`` near 0) and every
request is answered; past it the queue grows all through the run.  One
JSON line per rate; the benchmark's own runs never run this.
"""
import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--traffic", default=None)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from harness import cell as cell_mod
    from harness import spec

    cell = spec.find(args.workload)
    if args.traffic:
        cell.traffic = spec.load_json(spec.BENCH / "traffic"
                                      / f"{args.traffic}.json")
    sut_mod, loop = spec.system(cell), spec.loop(cell)
    dev = torch.device(args.device)
    made = sut_mod.make_inputs(cell.config, cell.traffic, args.seed, dev)
    for rate in args.rates:
        mix = dict(cell.traffic, rate_per_s=rate)
        sut = sut_mod.System(cell.config, mix, made, dev)
        loop.warm_up(sut, mix)
        window = loop.drive(sut, mix, args.seed, args.seconds)
        del sut
        reqs = window.reqs
        lat = np.asarray([r.done - r.due if r.result is not None
                          else np.inf for r in reqs])
        q = max(1, len(reqs) // 4)
        answered = [r for r in reqs if r.result is not None]
        last = max(r.done for r in answered)
        print(json.dumps({
            "rate": rate, "attempted": len(reqs),
            "failed": len(reqs) - len(answered),
            "p50_s": float(np.percentile(lat, 50)),
            "p95_s": float(np.percentile(lat, 95)),
            "growth_s": float(np.median(lat[-q:]) - np.median(lat[:q])),
            "served_per_s": len(answered) / (last - window.start),
            "mean_bucket": float(np.mean([r.result.batch_size
                                          for r in answered]))}),
            flush=True)
    return 3 if cell_mod.forbidden_modules() else 0


if __name__ == "__main__":
    sys.exit(main())
