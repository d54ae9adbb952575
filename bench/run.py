"""Run one cell of the benchmark of ``repro_torch`` on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is found by name in
``BENCHMARK.json``.  ``--trace 0`` prints the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a profiled window.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown`` when traced), and
last ``compared``, each number of the comparison that decides
``correct`` beside its limit; the same numbers are the last lines of
standard error.  Exits 2 with no result without a card, with fewer cards
than the cell asks for, or where the cell's system does not run on that
many (its module's ``CHIPS``), and 3 if JAX, flax or the JAX package
(``repro``) was loaded.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from harness import cell as cell_mod
    from harness import spec

    cell = spec.find(args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    why = cell_mod.refusal(cell, cards)
    if why:
        print(f"bench: {why}: no result", file=sys.stderr)
        return 2
    line, report = cell_mod.execute(cell, args.seed, args.seconds,
                                    bool(args.trace), "cuda:0", STARTED)
    found = cell_mod.forbidden_modules()
    if found:
        print(f"bench: loaded {found}, which the benchmark may not load: "
              f"no result", file=sys.stderr)
        return 3
    for text in report:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
