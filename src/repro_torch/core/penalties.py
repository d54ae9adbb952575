"""Folded-concave penalties via one-step local linear approximation (LLA),
in torch.

Paper Section 2.3(iii): SCAD (Fan & Li 2001), MCP (Zhang 2010) and the
adaptive lasso (Zou 2006) via the LLA of Zou & Li (2008): fit the l1
solution (stage 1), then re-fit with per-coordinate penalty weights
lam_j = pen'(|beta_j^(1)|; lam) / lam (stage 2).  The weights multiply the
soft-threshold level of the unified step (``repro_torch.core.solver``), so
under a megakernel backend stage 2 is one round-kernel launch with a
per-coordinate (p,) ``lam_vec``.

Counterpart of ``repro.core.penalties``: ``engine="sharded"`` routes both
stages through ``repro_torch.core.decentral`` (the pilot path on the
(node, lam) mesh engine, the fits on the sharded one), where every round
is one two-pass kernel launch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core import solver
from repro_torch.core.admm import (ADMMConfig, as_f32, decsvm_fit,
                                   resolve_device)

Tensor = torch.Tensor


def scad_weight(beta: Tensor, lam: float, a: float = 3.7) -> Tensor:
    """SCAD'(|b|)/lam: 1 on [0, lam], decays linearly, 0 beyond a*lam."""
    ab = torch.abs(torch.as_tensor(beta))
    return torch.where(ab <= lam, 1.0,
                       torch.clamp(a * lam - ab, min=0.0) / ((a - 1.0) * lam))


def mcp_weight(beta: Tensor, lam: float, gamma: float = 3.0) -> Tensor:
    """MCP'(|b|)/lam = max(0, 1 - |b|/(gamma*lam))."""
    return torch.clamp(1.0 - torch.abs(torch.as_tensor(beta)) / (gamma * lam),
                       min=0.0)


def adaptive_weight(beta: Tensor, lam: float, eps: float = 0.05,
                    power: float = 1.0) -> Tensor:
    """Adaptive-lasso weights (eps/(|b|+eps))^power in (0, 1]."""
    return (eps / (torch.abs(torch.as_tensor(beta)) + eps)) ** power


PENALTIES = {
    "scad": scad_weight,
    "mcp": mcp_weight,
    "adaptive": adaptive_weight,
}


def decsvm_fit_lla(X, y, W, cfg: ADMMConfig, penalty: str = "scad",
                   lams: Optional[Sequence[float]] = None,
                   path_mode: str = "warm", engine: str = "dense",
                   mesh=None, schedule: str = "gather", *, rho=None,
                   device=None, **pen_kwargs):
    """Two-stage LLA: l1 pilot -> penalty-weighted re-fit.

    When ``lams`` is given, the stage-1 pilot comes from the lambda-path
    engine (``repro_torch.core.path.decsvm_path_select`` in
    ``path_mode``): the modified BIC picks lambda, and both the pilot and
    the stage-2 penalty level use the selected value.  Otherwise the pilot
    is a single l1 fit at ``cfg.lam``.  Weights are computed from the
    network-average pilot.  ``rho`` (m,) optionally fixes the step sizes
    of both stages (by default ``compute_rho`` runs once for both);
    ``device`` as in ``admm.decsvm_fit``.

    engine: "dense" (single process) or "sharded" (both stages through
    ``repro_torch.core.decentral`` on ``mesh`` with ``schedule``: the
    pilot path on the (node, lam) mesh engine, the fits on the sharded
    engine).

    Returns (B_stage2, weights).
    """
    if penalty not in PENALTIES:
        raise ValueError(f"penalty {penalty!r} not in {sorted(PENALTIES)}")
    if engine not in ("dense", "sharded"):
        raise ValueError(f"engine {engine!r} not in ('dense', 'sharded')")
    dev = resolve_device(X, device)
    X, y, W = as_f32(X, dev), as_f32(y, dev), as_f32(W, dev)
    rho = (solver.compute_rho(X, cfg.h, cfg.kernel, cfg.rho_safety)
           if rho is None else as_f32(rho, dev))
    if engine == "sharded":
        from repro_torch.core import decentral  # local import: avoid cycle

        def fit(cfg, lam_weights=None):
            return decentral.decsvm_fit_sharded(
                X, y, W, cfg, mesh=mesh, schedule=schedule,
                lam_weights=lam_weights, rho=rho)
    else:
        def fit(cfg, lam_weights=None):
            return decsvm_fit(X, y, W, cfg, lam_weights=lam_weights, rho=rho)
    if lams is not None:
        if engine == "sharded":
            from repro_torch.core import decentral  # local: avoid cycle
            res = decentral.decsvm_path_mesh(X, y, W, lams, cfg, mesh=mesh,
                                             schedule=schedule,
                                             mode=path_mode, rho=rho)
        else:
            from repro_torch.core import path as path_mod  # local: avoid cycle
            res = path_mod.decsvm_path_select(X, y, W, lams, cfg,
                                              mode=path_mode, rho=rho)
        cfg = dataclasses.replace(cfg, lam=float(res.best_lam))
        B1 = res.best_B
    else:
        B1 = fit(cfg)
    pilot = torch.mean(B1, dim=0)
    w = PENALTIES[penalty](pilot, cfg.lam, **pen_kwargs)
    return fit(cfg, w), w
