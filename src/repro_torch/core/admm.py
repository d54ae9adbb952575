"""Dense single-process driver for the penalized convoluted SVM
(paper Algorithm 1, updates (7a') and (7b)), in torch.

Counterpart of ``repro.core.admm``.  The update math lives in
``repro_torch.core.solver``; this module binds its step to the dense
neighbour sum (``W @ B`` with node states stacked into B (m, p) / P
(m, p)) and keeps the public surface: ``ADMMConfig``, ``admm_step``,
``decsvm_fit``, ``objective``, ``hard_threshold_final``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import losses, solver
# Re-exported: the canonical home is core.solver.
from repro_torch.core.solver import (SolverState, compute_rho,  # noqa: F401
                                     power_iteration_lmax, soft_threshold)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    lam: float = 0.05          # l1 penalty
    lam0: float = 0.0          # l2 (elastic net) penalty; 0 => pure l1
    tau: float = 1.0           # ADMM penalty parameter
    h: float = 0.25            # smoothing bandwidth
    kernel: str = "epanechnikov"
    max_iter: int = 300
    rho_safety: float = 1.05   # multiply the c_h * lmax bound by this
    use_pallas: bool = False   # route the local update through the kernel
    backend: str = "auto"      # "auto" (use_pallas decides) | "jnp" |
    #                            "pallas" | "megakernel" | "megakernel_bf16"
    sanitize: bool = False     # E1-E7 term checks around every round, the
    #                            first non-finite term and round raised
    #                            (dense drivers only; see core.sanitize)


class ADMMState(NamedTuple):
    B: Tensor      # (m, p) primal node estimates
    P: Tensor      # (m, p) accumulated duals  p_l = sum_k (u_lk + v_lk)
    t: Tensor      # iteration counter


def resolve_device(X, device=None) -> torch.device:
    """The device a driver runs on: ``device`` when given, else X's device
    when X is a tensor, else CUDA.  Raises when CUDA is asked for and no
    card is present — a driver never carries on on the CPU silently."""
    if device is None:
        device = X.device if isinstance(X, torch.Tensor) else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain torch path on the CPU")
    return device


def as_f32(a, device) -> Tensor:
    """numpy or tensor -> a contiguous fp32 tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32).contiguous()
    return torch.as_tensor(np.array(a, np.float32), device=device)


def admm_step(X: Tensor, y: Tensor, W: Tensor, deg: Tensor, rho: Tensor,
              state: ADMMState, cfg: ADMMConfig,
              lam_weights: Optional[Tensor] = None) -> ADMMState:
    """One round of Algorithm 1 across all m nodes (compat wrapper over
    ``solver.make_step`` with the dense ``W @ B`` neighbour sum)."""
    omega = 1.0 / (2.0 * cfg.tau * deg + rho + cfg.lam0)
    prob = solver.Problem(X.to(solver.problem_dtype(cfg)).contiguous(), y,
                          deg, rho, omega, None)
    step = solver.make_step(cfg, lambda B: W @ B, W=W)
    st = solver.SolverState(state.B, state.P, state.t,
                            torch.tensor(float("inf"), device=state.B.device))
    new = step(prob, st, cfg.lam, lam_weights)
    return ADMMState(new.B, new.P, new.t)


def decsvm_fit(X, y, W, cfg: ADMMConfig, beta0=None,
               track_history: bool = False, lam_weights=None, *,
               rho=None, device=None):
    """Run Algorithm 1 for cfg.max_iter rounds.

    Args:
      X: (m, n, p) node-partitioned design (intercept included as a column).
      y: (m, n) labels in {-1, +1}.
      W: (m, m) adjacency.
      beta0: optional (m, p) warm start (A7 allows zeros).
      lam_weights: optional (p,) per-coordinate l1 multipliers (LLA stage 2).
      rho: optional (m,) per-node step sizes (default ``compute_rho``).
      device: where to run; default X's device for a tensor, else CUDA.
    Returns:
      B: (m, p) final node estimates; and, if track_history, H: (T, m, p).
    """
    dev = resolve_device(X, device)
    X, y, W = as_f32(X, dev), as_f32(y, dev), as_f32(W, dev)
    prob = solver.make_problem(X, y, W, cfg,
                               rho=None if rho is None else as_f32(rho, dev))
    step = solver.make_step(cfg, lambda B: W @ B, W=W)
    state = solver.init_state(
        prob, B0=None if beta0 is None else as_f32(beta0, dev))
    lw = None if lam_weights is None else as_f32(lam_weights, dev)
    out = solver.run_fixed(step, prob, cfg.lam, lw, num_iters=cfg.max_iter,
                           state=state, track_history=track_history)
    if track_history:
        final, hist = out
        return final.B, hist
    return out.B


def objective(X: Tensor, y: Tensor, beta: Tensor, cfg: ADMMConfig) -> Tensor:
    """Network-wide smoothed elastic-net objective (eq. 3/4) at a common beta."""
    k = losses.get_kernel(cfg.kernel)
    margins = y * torch.einsum("mnp,p->mn", X, beta)
    data = torch.mean(k.loss(margins, cfg.h))
    return (data + 0.5 * cfg.lam0 * torch.sum(beta**2)
            + cfg.lam * torch.sum(torch.abs(beta)))


def hard_threshold_final(B: Tensor, lam: float) -> Tensor:
    """Theorem 4 post-processing: keep coordinates with |beta_j| > lambda,
    passed through unshrunk (true *hard* thresholding)."""
    return B * (torch.abs(B) > lam)
