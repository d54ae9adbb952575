"""Quickstart in torch: the paper end to end on the card.

Generates the Section-4.1 simulation design, runs deCSVM (Algorithm 1,
one round-kernel launch under ``backend="megakernel"``) against the four
baselines and a BIC-tuned deCSVM whose lambda the warm-started path
engine (``repro_torch.core.path``: KKT early stop, one fused 4-round +
KKT launch a check) selects, and prints the Table-1-style comparison.
The torch counterpart of ``examples/quickstart.py``, at its design.

    PYTHONPATH=src python3 -m repro_torch.launch.quickstart            # card
    PYTHONPATH=src python3 -m repro_torch.launch.quickstart --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import (ADMMConfig, SimConfig, baselines, decsvm_fit,
                              generate, losses, metrics, tuning)
from repro_torch.core.admm import resolve_device
from repro_torch.core.graph import erdos_renyi

DESIGN = SimConfig(p=100, s=10, m=10, n=200, rho=0.5, p_flip=0.01)
ROWS = ("Pooled", "Local", "Avg.", "D-subGD", "deCSVM", "Tuned")


def run(device=None, log=print) -> dict:
    """Fit the six rows at ``DESIGN`` on ``device`` (default CUDA; raises
    without a card) and print the table through ``log``.  Returns
    {row: {"est_err", "f1", "acc", "supp"}} plus "Tuned"'s selected
    "best_lam" and per-point "iters"."""
    dev = resolve_device(None, device)
    cfg = DESIGN
    log(f"design: p={cfg.p} s={cfg.s} m={cfg.m} n={cfg.n} "
        f"rho={cfg.rho} p_flip={cfg.p_flip}  device: {dev}")
    X, y, bstar = generate(cfg, seed=0)
    W = erdos_renyi(cfg.m, cfg.p_connect, seed=0)
    h = losses.default_bandwidth(cfg.n_total, cfg.p)
    lam = 1.2 * float(np.sqrt(np.log(cfg.p) / cfg.n_total))
    acfg = ADMMConfig(lam=lam, h=h, kernel="epanechnikov", max_iter=300,
                      backend="megakernel")
    log(f"bandwidth h={h:.3f}  lambda={lam:.4f}\n")

    on = dict(device=dev)
    fits = {}
    fits["Pooled"] = baselines.pooled_csvm(
        X.reshape(-1, X.shape[-1]), y.reshape(-1), acfg, 1500, **on)[None]
    loc = baselines.local_csvm(X, y, acfg, 800, **on)
    fits["Local"] = loc
    fits["Avg."] = baselines.average_consensus(loc, W, **on)
    fits["D-subGD"] = baselines.d_subgd_fit(X, y, W, lam=lam, max_iter=100,
                                            **on)
    fits["deCSVM"] = decsvm_fit(X, y, W, acfg, **on)
    best_lam, _, _, res = tuning.select_lambda_path(
        X, y, W, acfg, num=12, mode="warm", tol=1e-3, **on)
    iters = res.iters.cpu().tolist()
    log(f"path engine: 12-point grid, warm-start continuation, KKT early "
        f"stop at 1e-3; BIC picked lambda={best_lam:.4f} (iters/lambda: "
        f"{iters})")
    fits["Tuned"] = res.best_B

    Xt, yt, _ = generate(cfg, seed=123)
    Xt2, yt2 = Xt.reshape(-1, X.shape[-1]), yt.reshape(-1)
    log(f"{'method':8s} {'est.err':>8s} {'F1':>6s} {'acc':>6s} {'supp':>6s}")
    rows = {}
    for name in ROWS:
        B = fits[name].cpu().numpy()
        rows[name] = dict(
            est_err=metrics.estimation_error(B, bstar),
            f1=metrics.mean_f1(B, bstar, tol=1e-3),
            acc=float(np.mean([metrics.accuracy(b, Xt2, yt2) for b in B])),
            supp=metrics.mean_support_size(B, tol=1e-3))
        r = rows[name]
        log(f"{name:8s} {r['est_err']:8.4f} {r['f1']:6.3f} {r['acc']:6.3f} "
            f"{r['supp']:6.1f}")
    log("\nexpected: deCSVM ~ Pooled, both << Local; deCSVM sparse, "
        "D-subGD dense")
    rows["Tuned"].update(best_lam=best_lam, iters=iters)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
