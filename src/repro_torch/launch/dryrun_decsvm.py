"""Dry run of the paper's own workload at production scale: one round of
decentralized penalized-CSVM ADMM (Algorithm 1) with one network node a
rank, p = 128Ki features, n = 2048 local samples, on meta tensors.

Counterpart of ``repro.launch.dryrun_decsvm``, which lowers JAX's
sharded loop (``core.decentral.build_sharded_admm``) on 256 (or 512)
placeholder TPU chips.  Here the port's ``build_sharded_admm`` runs on one
virtual rank of a ("node", 256 or 512) ``AbstractMesh`` (``mesh.dry``),
eagerly on meta, as ``launch.dryrun`` runs the LM steps; no card and no
group.  ``ADMMConfig(lam=0.01, h=0.1, max_iter=8)``, as JAX's; its
backend "auto" resolves to the plain update ("jnp": ``use_pallas`` is
off), on a card as here; ``run_one(..., backend="megakernel")`` or
``"pallas"`` runs the two-pass kernel's meta route instead (the sharded
engine's step carries no W, so no round kernel).

Two neighbour-exchange schedules are compared:
  - gather: all_gather(B) + local adjacency rows — any graph topology;
  - ring:   two boundary-row ppermutes.

Counted per round, as JAX's record counts: XLA counts the scan body once
plus what lies outside the loop.  The port runs every round eagerly, so
it runs the loop at ``max_iter`` rounds and at none: a round is the
difference over ``max_iter``, and what lies outside the loop is the run
at none.  The port's round makes its two neighbour exchanges in the round
(``solver.make_step``); JAX's HLO holds one in the loop body and one
outside it, so the bytes a round compare.  Outside the loop the port
makes one exchange, ``_shard``'s final gather of B into the global
result (JAX's out_specs keep B sharded): it is listed apart, under
``final_gather_bytes``, not in ``collective_bytes``.  ``comm_bytes`` is
the round's in the port's sizing and ``comm_bytes_fit`` the whole fit's,
as ``mesh.comm_bytes`` records it on a real group.

Usage: PYTHONPATH=src python -m repro_torch.launch.dryrun_decsvm \\
    [--p 131072] [--n 2048] [--schedule both] [--out results/dryrun]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import torch

from repro_torch.core import solver
from repro_torch.core.admm import ADMMConfig
from repro_torch.core.decentral import build_sharded_admm
from repro_torch.launch import mesh as M
from repro_torch.launch.dryrun import CARD, LINK, measure, roofline
from repro_torch.launch.mesh import P
from repro_torch.launch.sharding import block_shape

SPECS = (P("node"),) * 5 + (P(),)


def dry_fit(m, n, p, cfg, mesh, schedule, rank=0):
    """``dryrun.measure`` of one rank's dry fit of ``cfg.max_iter`` rounds
    through ``build_sharded_admm(m, p + 1, cfg, mesh, schedule)`` on (m,
    n, p + 1) meta operands (any mesh description with a "node" axis)."""
    f32 = torch.float32
    X = torch.empty((m, n, p + 1), dtype=solver.problem_dtype(cfg),
                    device="meta")
    args = [X] + [torch.empty(shape, dtype=f32, device="meta")
                  for shape in ((m, n), (m, m), (m,), (m,), (p + 1,))]
    sizes = [t.element_size() * int(torch.Size(block_shape(
        t.shape, spec, mesh)).numel()) for t, spec in zip(args, SPECS)]
    fitted = build_sharded_admm(m, p + 1, cfg, mesh, schedule)
    with M.dry(mesh, rank) as rec:
        return measure(lambda: fitted(*args), args, sizes, rec)


def run_one(m: int, n: int, p: int, schedule: str, multi_pod: bool,
            out: Path, backend: str = "auto"):
    """One rank's dry run of the sharded ADMM (module docstring); writes
    and returns JAX's record, with ``comm_bytes``, ``comm_bytes_fit``,
    ``final_gather_bytes``, ``backend`` and the kernels' counts besides.
    ``m`` is JAX's and unused: one node a rank, 256 or 512."""
    ndev = 512 if multi_pod else 256
    nodes = ndev                     # one network node per rank
    mesh = M.abstract_mesh((ndev,), ("node",))
    cfg = ADMMConfig(lam=0.01, h=0.1, max_iter=8, backend=backend)
    run = dry_fit(nodes, n, p, cfg, mesh, schedule)
    none = dry_fit(nodes, n, p, dataclasses.replace(cfg, max_iter=0), mesh,
                   schedule)
    R = cfg.max_iter
    k = (len(run.calls) - len(none.calls)) // R
    round_calls = run.calls[:k]
    if (run.calls[:R * k] != round_calls * R
            or run.calls[R * k:] != none.calls):
        raise RuntimeError("the dry fit's exchanges are not max_iter equal "
                           "rounds followed by the final gather")
    # a round, and what lies outside the loop
    flops = (run.flops - none.flops) / R + none.flops
    bytes_acc = ((run.bytes_accessed - none.bytes_accessed) / R
                 + none.bytes_accessed)
    coll = M.DryRecord.hlo_of(round_calls)
    terms, dominant = roofline(flops, bytes_acc, coll["total"])
    # useful flops per round: 2 passes over X (margin + X^T w) = 4*n*p
    useful = 4.0 * n * (p + 1)
    rec = {
        "arch": "decsvm-admm", "shape": f"m{nodes}_n{n}_p{p}_{schedule}",
        "mesh": "multi" if multi_pod else "single",
        "chips": ndev, "ok": True, "compile_s": round(run.wall_s, 2),
        "lower_s": 0.0, "backend": solver.resolve_backend(cfg),
        "memory_analysis": {
            "argument_bytes": run.argument_bytes,
            "output_bytes": run.output_bytes,
            "temp_bytes": run.temp_bytes,
        },
        "cost_analysis": {
            "flops": flops, "bytes_accessed": bytes_acc,
            "note": "per ADMM round (a round of the eager loop, plus what "
                    "lies outside the loop), as JAX's scan body counted "
                    "once"},
        "collective_bytes": coll,
        "comm_bytes": M.DryRecord.comm_of(round_calls),
        "comm_bytes_fit": M.DryRecord.comm_of(run.calls),
        "final_gather_bytes": {"comm": M.DryRecord.comm_of(none.calls),
                               "hlo": M.DryRecord.hlo_of(none.calls)},
        "kernels": {name: {key: c[key] / R for key in ("flops", "bytes",
                                                        "calls")}
                    for name, c in run.kernel_counts.items()},
        "roofline": {**terms, "dominant": dominant,
                     "model_flops_total": useful * ndev,
                     "hlo_flops_per_chip": flops,
                     "useful_flops_ratio": useful / flops if flops else 0.0,
                     "card": CARD, "link": LINK},
    }
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"decsvm_admm__{rec['shape']}__{rec['mesh']}.json"
    path.write_text(json.dumps(rec, indent=1))
    print(f"[decsvm x {rec['shape']} x {rec['mesh']}] dry={run.wall_s:.1f}s "
          f"flops/chip={flops:.3e} bytes={bytes_acc:.3e} "
          f"coll={coll['total']:.3e} ({ {k: f'{v:.2e}' for k, v in coll.items()} }) "
          f"dominant={dominant}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--p", type=int, default=131072)
    ap.add_argument("--schedule", default="both",
                    choices=["gather", "ring", "both"])
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    a = ap.parse_args(argv)
    scheds = ["gather", "ring"] if a.schedule == "both" else [a.schedule]
    for s in scheds:
        run_one(256, a.n, a.p, s, False, Path(a.out))
        if a.multi:
            run_one(512, a.n, a.p, s, True, Path(a.out))


if __name__ == "__main__":
    main()
