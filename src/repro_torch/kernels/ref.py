"""Plain-torch oracles for the CSVM kernels of this package.

Counterpart of ``repro.kernels.ref``: each oracle is the exact math every
driver runs (``core.solver``), in fp32, independent of the kernels and of
their plain versions in ``csvm_update.py`` (which repeat the kernels'
bf16 rounding points).  ``mha`` waits for the port of the LM stack.
"""
from __future__ import annotations

import math
import types

import torch

from repro_torch.core import solver

Tensor = torch.Tensor


def decsvm_local_update(X: Tensor, y: Tensor, beta: Tensor, p_dual: Tensor,
                        neigh: Tensor, rho, omega, lam,
                        h: float, kernel: str = "epanechnikov") -> Tensor:
    """Oracle for the fused ADMM local update (paper eq. 7a'): the unified
    Algorithm-1 update of ``repro_torch.core.solver``, verbatim.

    X: (n, p), y: (n,), beta/p_dual/neigh: (p,); rho/omega scalars; lam a
    scalar or (p,) per-coordinate penalty vector.  Returns beta_new (p,).
    """
    return solver.local_update(X, y, beta, p_dual, neigh, rho, omega, lam,
                               h=h, kernel=kernel)


def decsvm_round_block(X: Tensor, y: Tensor, B: Tensor, P: Tensor,
                       W: Tensor, deg: Tensor, rho: Tensor, omega: Tensor,
                       lam_vec, nact: int, *, tau: float, lam0: float,
                       h: float, kernel: str = "epanechnikov",
                       want_kkt: bool = False):
    """Oracle for the round kernel: ``nact`` dense Algorithm-1 rounds (each
    one exactly ``solver.local_update`` + the dense W@B neighbour sums)
    followed by the stop statistic the kernel emits — the KKT residual of
    ``solver.kkt_residual`` when ``want_kkt``, else the last round's
    max|dB| (+inf after no round).  Returns (B, P, stat), all fp32.
    """
    X = X.to(torch.float32)
    y = y.to(torch.float32)
    B, P = B.to(torch.float32), P.to(torch.float32)
    delta = torch.tensor(math.inf, dtype=torch.float32, device=B.device)
    for _ in range(int(nact)):
        neigh = tau * (deg[:, None] * B + W @ B)
        B_new = solver.local_update(X, y, B, P, neigh, rho, omega, lam_vec,
                                    h=h, kernel=kernel)
        P = P + tau * (deg[:, None] * B_new - W @ B_new)
        delta = torch.max(torch.abs(B_new - B))
        B = B_new
    if want_kkt:
        cfg = types.SimpleNamespace(kernel=kernel, h=h, lam0=lam0)
        prob = solver.Problem(X, y, deg, rho, omega, None)
        lam_arr = torch.as_tensor(lam_vec, dtype=torch.float32,
                                  device=B.device).reshape(-1)
        if lam_arr.shape[0] == 1:
            stat = solver.kkt_residual(prob, cfg, B, float(lam_arr[0]))
        else:
            stat = solver.kkt_residual(prob, cfg, B, 1.0, lam_arr)
        return B, P, stat
    return B, P, delta
