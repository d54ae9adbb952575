"""Production conveniences on top of Algorithm 1, in torch — thin drivers
over the unified step in ``repro_torch.core.solver``:

- ``decsvm_fit_tol``: early stopping on either the iterate-progress rule
  (progress = |B_t - B_{t-1}|) or the KKT/duality-gap rule of
  ``solver.kkt_residual`` (``stop_rule="kkt"``).
- ``decsvm_fit_uneven``: uneven local sample sizes n_l via sample masks
  (Section 2.1's extension); masked fits take the plain reference backend,
  because the kernels have no mask operand.

Counterpart of ``repro.core.admm_adaptive``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import solver
from repro_torch.core.admm import ADMMConfig, as_f32, resolve_device

Tensor = torch.Tensor


def decsvm_fit_tol(X, y, W, cfg: ADMMConfig, tol: float = 1e-6,
                   stop_rule: str = "progress", check_every: int = 4, *,
                   rho=None, device=None) -> Tuple[Tensor, Tensor]:
    """Run Algorithm 1 until max_iter OR stop statistic < tol.

    stop_rule: "progress" (max|B_t - B_{t-1}|) or "kkt" (stationarity +
    consensus residual of ``solver.kkt_residual``).  ``check_every``
    evaluates the statistic only every k-th round (default 4); under a
    megakernel backend each k-round block and its statistic is one
    kernel launch.  ``rho`` optionally fixes the per-node step sizes;
    ``device`` as in ``admm.decsvm_fit``.  Returns (B, t).
    """
    if stop_rule not in ("kkt", "progress"):
        raise ValueError(f"stop_rule {stop_rule!r} not in ('kkt', 'progress')")
    dev = resolve_device(X, device)
    X, y, W = as_f32(X, dev), as_f32(y, dev), as_f32(W, dev)
    prob = solver.make_problem(X, y, W, cfg,
                               rho=None if rho is None else as_f32(rho, dev))
    step = solver.make_step(cfg, lambda B: W @ B, W=W)
    residual_fn = (solver.kkt_residual_fn(cfg) if stop_rule == "kkt"
                   else None)
    final = solver.run_tol(step, prob, cfg.lam, max_iter=cfg.max_iter,
                           tol=tol, residual_fn=residual_fn,
                           check_every=check_every)
    return final.B, final.t


def decsvm_fit_uneven(X, y, mask, W, cfg: ADMMConfig, *, rho=None,
                      device=None) -> Tensor:
    """Algorithm 1 with per-node sample masks.

    X: (m, n_max, p) zero-padded designs; mask: (m, n_max) in {0,1} marking
    real rows (n_l = mask[l].sum()).  Updates are (7a')/(7b) with n
    replaced by n_l per node; rho comes from the masked second moment.
    """
    dev = resolve_device(X, device)
    X, y, W = as_f32(X, dev), as_f32(y, dev), as_f32(W, dev)
    mask = as_f32(mask, dev)
    prob = solver.make_problem(X, y, W, cfg, mask=mask,
                               rho=None if rho is None else as_f32(rho, dev))
    step = solver.make_step(cfg, lambda B: W @ B, W=W)
    final = solver.run_fixed(step, prob, cfg.lam, num_iters=cfg.max_iter)
    return final.B
