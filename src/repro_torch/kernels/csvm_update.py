"""The CSVM update kernels for Hopper, and their plain torch versions.

The update (7a') is a matvec chain  margin -> L_h' weight -> X^T w ->
soft-threshold.  Three CUDA C++ kernels in ``csrc/csvm_update.cu`` carry
it (wrappers, launch counters and the residency rule in ``ops.py``):

- ``csvm_local_update``  replaces ``repro/kernels/csvm_update.py``'s
  ``csvm_local_update`` (``_margin_weights_kernel`` +
  ``_grad_update_kernel``): two launches, margins/weights over
  (row tile, node), then X^T w and the prox over (column tile, node).
  X is taken in fp32, as the Pallas wrapper casts it.  Torch cannot vmap
  a kernel, so the node is a grid axis.
- ``csvm_block_update``  replaces ``csvm_block_update``
  (``_block_update_kernel``): the same two launches over the stacked
  (m, n, p) block, X in fp32 or bf16.
- ``csvm_round_block``  replaces ``csvm_round_block``
  (``_round_megakernel``): ``num_rounds`` full ADMM rounds, and the
  optional KKT epilogue, in ONE cooperative launch with grid-wide
  barriers between the phases of a round.  Two instances
  (``ops.round_block_instance``): ``stream`` reads X once a round (p up
  to 8192), ``direct`` twice.

Each kernel's plain version below computes the same function with the
same bf16 rounding points (B, w and beta_bar are rounded to the compute
dtype before each dot, exactly where the JAX kernels' ``.astype(cd)``
sits); all accumulation is fp32.  The wrappers take the plain version
for tensors on the CPU only.  Ragged n, p and m need no padding here:
the CUDA kernels mask their edges, so the padding rules of the JAX
wrappers (y = 0 rows, X = lam = 0 columns, zero ghost nodes) have no
counterpart.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import losses, solver

Tensor = torch.Tensor


def _rounder(dtype):
    """Round an fp32 dot operand to the compute dtype (``.astype(cd)``)."""
    if dtype == torch.float32:
        return lambda a: a
    return lambda a: a.to(dtype).to(torch.float32)


def _weights(Xf, y, b, kern, h, scale, rnd):
    """w = L_h'(y * X rnd(b)) * y * scale, per node."""
    marg = solver._matvec(Xf, rnd(b))
    return kern.dloss(y * marg, h) * y * scale


def _prox_update(Xf, w, B, P, neigh, rho, omega, lam, rnd):
    grad = solver._rmatvec(Xf, rnd(w))
    z = rho[:, None] * B - grad - P + neigh
    # declint: disable=R1 plain version of the CUDA kernels' fused prox, parity-tested vs solver.local_update
    return solver.soft_threshold(omega[:, None] * z,
                                 lam[None, :] * omega[:, None])


def csvm_block_update_plain(X, y, B, P, neigh, rho, omega, lam_vec, *,
                            h: float, kernel: str = "epanechnikov"):
    """Fused primal update (7a') for a stacked node block.

    X (m, n, p) fp32 or bf16; y (m, n); B/P/neigh (m, p) fp32 (neigh is
    the precomputed tau*(deg*B + (WB)) rows); rho/omega (m,); lam_vec (p,).
    Returns B_new (m, p) fp32.
    """
    kern = losses.get_kernel(kernel)
    rnd = _rounder(X.dtype)
    Xf = X.to(torch.float32)
    w = _weights(Xf, y, B, kern, h, 1.0 / X.shape[1], rnd)
    return _prox_update(Xf, w, B, P, neigh, rho, omega, lam_vec, rnd)


def csvm_local_update_plain(X, y, beta, p_dual, neigh, rho, omega, lam, *,
                            h: float, kernel: str = "epanechnikov"):
    """Fused ADMM local update for a node stack: X (m, n, p), (m, p) rows,
    (m,) rho/omega.

    X is cast to fp32 first (the Pallas wrapper does the same); lam is a
    scalar or a (p,) per-coordinate level.  Returns X's dtype.
    """
    dev = X.device
    p = X.shape[-1]
    f32 = torch.float32
    lam_vec = torch.broadcast_to(
        torch.as_tensor(lam, dtype=f32, device=dev).reshape(-1), (p,))
    out = csvm_block_update_plain(
        X.to(f32), y.to(f32), beta.to(f32), p_dual.to(f32), neigh.to(f32),
        torch.as_tensor(rho, dtype=f32, device=dev).reshape(-1),
        torch.as_tensor(omega, dtype=f32, device=dev).reshape(-1),
        lam_vec, h=h, kernel=kernel)
    return out.to(X.dtype)


def csvm_round_block_plain(X, y, B, P, W, deg, rho, omega, lam_vec, nact, *,
                           tau: float, lam0: float, h: float,
                           kernel: str = "epanechnikov", num_rounds: int = 1,
                           want_kkt: bool = False):
    """``num_rounds`` ADMM rounds over the whole network; rounds with index
    >= ``nact`` are held.

    X (m, n, p) fp32 or bf16; y (m, n); B/P (m, p) fp32; W (m, m);
    deg/rho/omega (m,); lam_vec (p,); nact an int or an int tensor.
    Returns (B, P, stat) with stat the KKT residual (``want_kkt``) or the
    last active round's max|dB| (+inf when no round is active).
    """
    kern = losses.get_kernel(kernel)
    rnd = _rounder(X.dtype)
    Xf = X.to(torch.float32)
    m, n, _ = X.shape
    inv_n = 1.0 / n
    nact = min(max(int(nact), 0), num_rounds)
    delta = torch.tensor(math.inf, dtype=torch.float32, device=B.device)
    for _ in range(nact):
        neigh = tau * (deg[:, None] * B + W @ B)
        w = _weights(Xf, y, B, kern, h, inv_n, rnd)
        Bn = _prox_update(Xf, w, B, P, neigh, rho, omega, lam_vec, rnd)
        P = P + tau * (deg[:, None] * Bn - W @ Bn)
        delta = torch.max(torch.abs(Bn - B))
        B = Bn
    if not want_kkt:
        return B, P, delta
    bb = torch.sum(B, dim=0) * (1.0 / m)
    w = _weights(Xf, y, bb.expand(m, -1), kern, h, 1.0, rnd)
    g = torch.sum(solver._rmatvec(Xf, rnd(w)), dim=0) * (inv_n / m)
    g = g + lam0 * bb
    stat = torch.max(torch.abs(bb - solver.soft_threshold(bb - g, lam_vec)))
    cons = torch.max(torch.abs(B - bb[None, :]))
    return B, P, torch.maximum(stat, cons)
