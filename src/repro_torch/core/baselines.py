"""Baseline estimators from the paper's Section 4 comparison, in torch:

  - Pooled  : l1/elastic-net penalized CSVM on ALL data (FISTA) — benchmark.
  - Local   : each node solves its own penalized CSVM on local data only.
  - Average : local estimates combined by average consensus (Yadav-Salapaka).
  - D-subGD : decentralized subgradient descent on the ORIGINAL (nonsmooth)
              hinge objective with Metropolis mixing — the slow competitor.

Counterpart of ``repro.core.baselines``: each ``lax.scan`` is a loop, and
``vmap`` over nodes a leading node dimension.  The FISTA momentum and the
D-subGD step sizes depend only on the iteration count; they are computed
on the host in fp32, as JAX computes them, and reach the loop as Python
floats.  Every function runs on ``device`` (default: X's device for a
tensor, else CUDA) and returns tensors there.  ``lmax`` optionally fixes
the power-iteration eigenvalue of the FISTA step, as ``rho=`` does for
the fits (the JAX package draws its start vector with another generator).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import losses
from repro_torch.core.admm import ADMMConfig, as_f32, resolve_device
from repro_torch.core.graph import metropolis_weights
from repro_torch.core.solver import power_iteration_lmax, soft_threshold

Tensor = torch.Tensor


def _fista_momenta(max_iter: int) -> List[float]:
    """(t_k - 1) / t_{k+1} of each FISTA iteration, in fp32."""
    one, half, four = np.float32(1.0), np.float32(0.5), np.float32(4.0)
    tk, out = one, []
    for _ in range(max_iter):
        tk_new = half * (one + np.sqrt(one + four * tk * tk))
        out.append(float((tk - one) / tk_new))
        tk = tk_new
    return out


def _fista(X: Tensor, y: Tensor, cfg: ADMMConfig, max_iter: int,
           lmax: Optional[Tensor]) -> Tensor:
    """FISTA on a stack of independent problems: X (m, n, p), y (m, n) ->
    (m, p); each problem has its own step 1 / (1.01 L)."""
    kern = losses.get_kernel(cfg.kernel)
    m, N, p = X.shape
    if lmax is None:
        lmax = power_iteration_lmax(X)
    L = kern.lipschitz(cfg.h) * lmax + cfg.lam0
    step = (1.0 / (L * 1.01))[:, None]

    def smooth_grad(b):
        margin = y * torch.bmm(X, b[..., None])[..., 0]
        w = kern.dloss(margin, cfg.h) * y
        return (torch.bmm(X.transpose(1, 2), w[..., None])[..., 0] / N
                + cfg.lam0 * b)

    b = z = torch.zeros((m, p), dtype=X.dtype, device=X.device)
    for coef in _fista_momenta(max_iter):
        b_new = soft_threshold(z - step * smooth_grad(z), step * cfg.lam)
        z = b_new + coef * (b_new - b)
        b = b_new
    return b


def pooled_csvm(X, y, cfg: ADMMConfig, max_iter: int = 500, *, lmax=None,
                device=None) -> Tensor:
    """FISTA for  (1/N) sum L_h(y x'b) + lam0/2 |b|^2 + lam |b|_1.

    X: (N, p) pooled design, y: (N,); lmax: optional scalar.  Returns (p,).
    """
    dev = resolve_device(X, device)
    X, y = as_f32(X, dev), as_f32(y, dev)
    lm = None if lmax is None else as_f32(lmax, dev).reshape(1)
    return _fista(X[None], y[None], cfg, max_iter, lm)[0]


def local_csvm(X, y, cfg: ADMMConfig, max_iter: int = 500, *, lmax=None,
               device=None) -> Tensor:
    """Per-node pooled solve.  X: (m, n, p), y: (m, n), lmax: optional
    (m,) -> (m, p)."""
    dev = resolve_device(X, device)
    X, y = as_f32(X, dev), as_f32(y, dev)
    lm = None if lmax is None else as_f32(lmax, dev).reshape(-1)
    return _fista(X, y, cfg, max_iter, lm)


def average_consensus(B_local, W: np.ndarray, rounds: int = 100, *,
                      device=None) -> Tensor:
    """Metropolis-weight gossip averaging of local estimates -> (m, p)."""
    dev = resolve_device(B_local, device)
    B = as_f32(B_local, dev)
    M = as_f32(metropolis_weights(np.asarray(W)), dev)
    for _ in range(rounds):
        B = M @ B
    return B


def d_subgd(X, y, Wmix, lam: float = 0.05, max_iter: int = 100,
            lr0: float = 0.05, *, device=None) -> Tensor:
    """Decentralized subgradient descent on the nonsmooth l1-hinge objective.

    b_l <- sum_k M_lk b_k - eta_t * ( (1/n) sum_i dL(y x'b) y x + lam sign(b) )
    with eta_t = lr0 / sqrt(t+1).  X: (m, n, p), Wmix: (m, m) mixing.
    """
    dev = resolve_device(X, device)
    X, y, Wmix = as_f32(X, dev), as_f32(y, dev), as_f32(Wmix, dev)
    m, n, p = X.shape
    B = torch.zeros((m, p), dtype=X.dtype, device=dev)
    for t in range(max_iter):
        mixed = Wmix @ B
        margin = y * torch.bmm(X, mixed[..., None])[..., 0]
        w = losses.hinge_subgrad(margin) * y
        G = (torch.bmm(X.transpose(1, 2), w[..., None])[..., 0] / n
             + lam * torch.sign(mixed))
        eta = float(np.float32(lr0) / np.sqrt(np.float32(t) + np.float32(1)))
        B = mixed - eta * G
    return B


def d_subgd_fit(X, y, W: np.ndarray, lam: float = 0.05, max_iter: int = 100,
                lr0: float = 0.05, *, device=None) -> Tensor:
    return d_subgd(X, y, metropolis_weights(np.asarray(W)), lam=lam,
                   max_iter=max_iter, lr0=lr0, device=device)
