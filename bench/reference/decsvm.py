"""Plain PyTorch reference of a tuned deCSVM fit: the paper's Algorithm 1
(updates (7a') and (7b)) at every point of a λ grid, each cold-started
for a fixed number of rounds, scored by the modified BIC of Zhang et al.
(2016) (paper §4.1), and the grid point of least BIC selected.

It imports torch and nothing of the program, takes only the inputs the
benchmark made (X, y, W, the grid and the configuration's settings) and
works out again everything the program derives from them: the step sizes
ρ, the path, the BIC table, the selected λ and the selected estimate.  It
runs in fp32 with TF32 switched off, the precision the configuration
states, and takes a block of datasets and every grid point in one batched
product a round.

ρ follows the rule the program states: ρ_l = safety · c_h · λmax(X_l'X_l
/ n), with λmax from 50 power steps started from the vector that a CPU
``torch.Generator`` seeded with ``n * 1000003 + p`` draws, so that both
sides take the same step sizes to rounding.

``tf32=True`` is the control: every matrix product takes its operands
rounded to TF32 (10 explicit mantissa bits, to nearest even) and adds in
fp32, as the tensor cores do under TF32.  It is rounded here by hand, so
that the control is the same on the CPU and on any card.
"""
from __future__ import annotations

import contextlib
import math
from typing import Tuple

import torch

Tensor = torch.Tensor

SUPPORT_TOL = 1e-8
POWER_STEPS = 50
# c_h = C_H[kernel] / h, the Lipschitz constant of the smoothed loss's
# derivative (paper Lemma 2.1)
C_H = {"epanechnikov": 0.75}


def round_tf32(x: Tensor) -> Tensor:
    """fp32 rounded to TF32's 10 explicit mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _mm(a: Tensor, b: Tensor, tf32: bool) -> Tensor:
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    return torch.bmm(a, b)


@contextlib.contextmanager
def fp32_products():
    """Matrix products in full fp32 (TF32 off) while inside."""
    cuda = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


def dloss(v: Tensor, h: float) -> Tensor:
    """Derivative of the Epanechnikov-smoothed hinge loss at margin v:
    -F_K((1 - v) / h), F_K(z) = (2 + 3z - z^3) / 4 on [-1, 1]."""
    z = torch.clamp((1.0 - v) / h, -1.0, 1.0)
    return -(2.0 + 3.0 * z - z ** 3) / 4.0


def lmax(X: Tensor, tf32: bool = False) -> Tensor:
    """Largest eigenvalue of X_l'X_l / n for each block X_l of X (b, n, p)."""
    b, n, p = X.shape
    gen = torch.Generator(device="cpu").manual_seed(n * 1000003 + p)
    v0 = torch.randn(p, generator=gen, dtype=torch.float32).to(X.device)
    v = (v0 / torch.linalg.vector_norm(v0)).expand(b, p).contiguous()
    Xt = X.transpose(1, 2)

    def apply(v):
        return _mm(Xt, _mm(X, v[..., None], tf32), tf32)[..., 0] / n

    for _ in range(POWER_STEPS):
        w = apply(v)
        nrm = torch.linalg.vector_norm(w, dim=1, keepdim=True)
        safe = torch.where(nrm > 0.0, nrm, torch.ones_like(nrm))
        v = torch.where(nrm > 0.0, w / safe, v)
    w = apply(v)
    vv = torch.sum(v * v, dim=1)
    return torch.where(vv > 0.0,
                       torch.sum(v * w, dim=1)
                       / torch.where(vv > 0.0, vv, torch.ones_like(vv)),
                       torch.zeros_like(vv))


def soft(v: Tensor, t: Tensor) -> Tensor:
    return torch.sign(v) * torch.clamp(torch.abs(v) - t, min=0.0)


def tuned_paths(X: Tensor, y: Tensor, W: Tensor, lams, settings: dict,
                tf32: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    """The path and its modified BIC for a block of datasets.

    X (K, m, n, p), y (K, m, n), W (K, m, m) fp32; ``lams`` (L,), taken in
    fp32; ``settings`` holds ``h``, ``tau``, ``lam0``, ``rho_safety``,
    ``max_iter`` and ``kernel``.  Returns the path (K, L, m, p), the BIC
    (K, L) and its mean support size a node (K, L); the selected point of
    dataset k is ``argmin`` of its BIC row.
    """
    if settings["kernel"] not in C_H:
        raise ValueError(f"reference: kernel {settings['kernel']!r} "
                         f"not in {sorted(C_H)}")
    with fp32_products():
        return _tuned_paths(X, y, W, lams, settings, tf32)


def _tuned_paths(X, y, W, lams, settings, tf32):
    K, m, n, p = X.shape
    h, tau, lam0 = settings["h"], settings["tau"], settings["lam0"]
    dev = X.device
    lam = torch.as_tensor(lams, dtype=torch.float32).to(dev).reshape(-1)
    L = lam.numel()
    Xb = X.reshape(K * m, n, p)
    Xt = Xb.transpose(1, 2)
    c_h = C_H[settings["kernel"]] / h
    rho = (settings["rho_safety"] * c_h * lmax(Xb, tf32)).reshape(K, m)
    deg = torch.sum(W, dim=2)                                  # (K, m)
    omega = 1.0 / (2.0 * tau * deg + rho + lam0)
    rho4, deg4, om4 = (a[:, :, None, None] for a in (rho, deg, omega))
    thr = lam[None, None, None, :] * om4                       # (K, m, 1, L)
    yl = y[..., None]                                          # (K, m, n, 1)

    def margins(B):                     # B (K, m, p, L) -> (K, m, n, L)
        return yl * _mm(Xb, B.reshape(K * m, p, L), tf32).reshape(
            K, m, n, L)

    def nbr(B):                         # (W B)_l = sum_k W_lk b_k
        return _mm(W, B.reshape(K, m, p * L), tf32).reshape(K, m, p, L)

    B = torch.zeros((K, m, p, L), dtype=torch.float32, device=dev)
    P = torch.zeros_like(B)
    for _ in range(int(settings["max_iter"])):
        w = dloss(margins(B), h) * yl
        grad = _mm(Xt, w.reshape(K * m, n, L), tf32).reshape(K, m, p, L) / n
        z = rho4 * B - grad - P + tau * (deg4 * B + nbr(B))
        B_new = soft(om4 * z, thr)
        P = P + tau * (deg4 * B_new - nbr(B_new))
        B = B_new
    N = m * n
    hinge = torch.sum(torch.clamp(1.0 - margins(B), min=0.0), dim=(1, 2)) / N
    supp = torch.mean(torch.sum((torch.abs(B) > SUPPORT_TOL).float(), dim=2),
                      dim=1)                                   # (K, L)
    bic = hinge + math.sqrt(math.log(N)) * math.log(p) * supp / N
    return B.permute(0, 3, 1, 2).contiguous(), bic, supp
