"""One cell run with the program's host spans on (``repro_torch.spans``):
where the device's idle time goes, by the span the server's thread was in.

    python3 bench/idle_by_span.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout, on the card (``--device cpu`` rehearses it).
It runs the cell as ``bench/run.py`` does, but turns the spans on over the
measured window, and prints one JSON line: ``correct``, ``fits_per_s``
(with the spans on: ``--trace 0`` against ``bench/run.py --trace 0`` at
the same seed is their cost), ``spans`` and ``dropped``, and
``bucket_wait_p95_s``; traced, also ``idle_share``, ``bucket_idle_share``,
``front_idle_share``, the window's idle seconds ``idle_s``, every span's
idle seconds ``idle_by_span``, and ``uncovered_pct``, the share of the
bucket's idle time that no span inside the bucket covers
(``harness.host_spans`` says how each is read).  The benchmark's own runs
never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def run(cell, seed: int, seconds: float, traced: bool, device) -> dict:
    """The cell's window with the spans on, and what they read."""
    import torch
    from harness import cell as cell_mod
    from harness import host_spans, measure, spec, trace
    from repro_torch import spans

    sut_mod, loop = spec.system(cell), spec.loop(cell)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    made = sut_mod.make_inputs(cell.config, cell.traffic, seed, dev)
    sut = sut_mod.System(cell.config, cell.traffic, made, dev)
    loop.warm_up(sut, cell.traffic)
    if cuda:
        torch.cuda.synchronize(dev)

    spans.take()
    spans.enable(True)
    with trace.Tracer(traced, dev) as tracer:
        start_ns = time.time_ns()
        window = loop.drive(sut, cell.traffic, seed, seconds)
    spans.enable(False)
    dropped = spans.dropped
    held = spans.take()
    del sut

    answers = [sut_mod.answer(r.result, r.pool) for r in window.reqs
               if r.result is not None]
    failed = len(window.reqs) - len(answers)
    nums, limits, _ = sut_mod.judge(cell.config, cell.limits, made, answers,
                                    failed)
    run_ = cell_mod.Run(cell=cell, seed=seed, seconds=seconds, setup_s=0.0,
                        window=window, counters={}, trace=tracer.trace)
    out = {"workload": cell.name, "seed": seed, "traced": traced,
           "device": torch.cuda.get_device_name(dev) if cuda else dev.type,
           "correct": all(nums[k] <= limits[k] for k in limits),
           "attempted": len(window.reqs), "failed": failed,
           "fits_per_s": measure.fits_per_s(run_),
           "spans": len(held), "dropped": dropped,
           "bucket_wait_p95_s": host_spans.bucket_wait_p95_s(window, held)}
    t = tracer.trace
    if t is not None:
        by = host_spans.idle_by_span(t, start_ns, held)
        gaps = host_spans.idle(t, start_ns)
        inside = host_spans.bucket_idle_share(t, start_ns, held)
        uncovered = dict(by).get(host_spans.BUCKET, 0.0)
        out.update(
            window_s=t.window_s, busy_s=t.busy_s,
            idle_s=int(sum(gaps[:, 1] - gaps[:, 0])) * 1e-9,
            idle_share=measure.idle_share(run_),
            bucket_idle_share=inside,
            front_idle_share=host_spans.front_idle_share(t, start_ns, held),
            uncovered_pct=None if not inside else
            100.0 * uncovered / (inside * t.window_s / 100.0),
            idle_by_span=by)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    from harness import spec
    print(json.dumps(run(spec.find(args.workload), args.seed, args.seconds,
                         bool(args.trace), args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
