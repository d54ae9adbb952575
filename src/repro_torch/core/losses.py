"""Convolution-smoothed hinge losses (paper Section 2.2, Lemma 2.1), in torch.

The hinge loss L(u) = (1-u)_+ is convolved with a kernel K_h(u) = K(u/h)/h,
yielding L_h = L * K_h.  With z = (1 - v)/h every kernel admits closed forms:

    L_h (v) = (1-v) * F_K(z) - h * M_K(z)          (F_K = kernel CDF,
    L_h'(v) = -F_K(z)                               M_K(z) = int_-inf^z t K(t) dt)
    L_h''(v) = K(z) / h

Counterpart of ``repro.core.losses``: every function is elementwise on
tensors and runs on the tensor's device.  Autograd of ``loss`` equals
``dloss`` (the Laplacian routes its gradient through the closed form, as
the JAX package's ``custom_jvp`` does).  ``lipschitz(h)`` returns c_h of
Lemma 2.1: the Lipschitz constant of L_h'.  The CUDA kernels carry the
same ``dloss`` formulas in ``kernels/csrc/csvm_update.cu`` (``KERNEL_IDS``
below gives their enum).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

Tensor = torch.Tensor

KERNELS = ("laplacian", "logistic", "gaussian", "uniform", "epanechnikov")
# Enum of the smoothing kernel inside the CUDA sources (``dloss`` switch).
KERNEL_IDS = {name: i for i, name in enumerate(KERNELS)}


def hinge(v: Tensor) -> Tensor:
    """The original (unsmoothed) hinge loss (1 - v)_+."""
    return torch.clamp(1.0 - v, min=0.0)


def hinge_subgrad(v: Tensor) -> Tensor:
    """A subgradient of the hinge loss (used by the D-subGD baseline)."""
    return -(v < 1.0).to(v.dtype)


def _z(v: Tensor, h: float) -> Tensor:
    return (1.0 - v) / h


# -- Laplacian K(u) = exp(-|u|)/2 -------------------------------------------

def _laplacian_value(v, h):
    z = _z(v, h)
    return torch.clamp(1.0 - v, min=0.0) + 0.5 * h * torch.exp(-torch.abs(z))


def _laplacian_dloss(v, h):
    z = _z(v, h)
    # -F_K(z); F_K(z) = 0.5 e^z (z<0), 1 - 0.5 e^-z (z>=0)
    return -torch.where(z < 0, 0.5 * torch.exp(z), 1.0 - 0.5 * torch.exp(-z))


class _LaplacianLoss(torch.autograd.Function):
    """The value sums two kinks at v=1 that cancel mathematically but not
    under autograd's subgradient choices; route the gradient through the
    closed form instead."""

    @staticmethod
    def forward(ctx, v, h):
        ctx.save_for_backward(v)
        ctx.h = h
        return _laplacian_value(v, h)

    @staticmethod
    def backward(ctx, grad):
        (v,) = ctx.saved_tensors
        return grad * _laplacian_dloss(v, ctx.h), None


def _laplacian_loss(v, h):
    return _LaplacianLoss.apply(v, h)


def _laplacian_ddloss(v, h):
    z = _z(v, h)
    return 0.5 * torch.exp(-torch.abs(z)) / h


# -- Logistic K(u) = e^-u / (1+e^-u)^2 --------------------------------------

def _logistic_loss(v, h):
    z = _z(v, h)
    return h * torch.logaddexp(z, torch.zeros_like(z))


def _logistic_dloss(v, h):
    return -torch.sigmoid(_z(v, h))


def _logistic_ddloss(v, h):
    s = torch.sigmoid(_z(v, h))
    return s * (1.0 - s) / h


# -- Gaussian ----------------------------------------------------------------

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _norm_pdf(z):
    return torch.exp(-0.5 * z * z) * _INV_SQRT_2PI


def _gaussian_loss(v, h):
    z = _z(v, h)
    return (1.0 - v) * torch.special.ndtr(z) + h * _norm_pdf(z)


def _gaussian_dloss(v, h):
    return -torch.special.ndtr(_z(v, h))


def _gaussian_ddloss(v, h):
    return _norm_pdf(_z(v, h)) / h


# -- Uniform K(u) = I(|u|<=1)/2 ----------------------------------------------

def _uniform_loss(v, h):
    z = torch.clamp(_z(v, h), -1.0, 1.0)
    mid = 0.25 * h * (z + 1.0) ** 2
    return torch.where(_z(v, h) > 1.0, 1.0 - v, mid)


def _uniform_dloss(v, h):
    z = torch.clamp(_z(v, h), -1.0, 1.0)
    return -0.5 * (z + 1.0)


def _uniform_ddloss(v, h):
    z = _z(v, h)
    return torch.where(torch.abs(z) <= 1.0, 0.5 / h, 0.0).to(v.dtype)


# -- Epanechnikov K(u) = 0.75 (1-u^2) on [-1,1] -------------------------------

def _epanechnikov_loss(v, h):
    z = torch.clamp(_z(v, h), -1.0, 1.0)
    mid = h * (3.0 + 8.0 * z + 6.0 * z**2 - z**4) / 16.0
    return torch.where(_z(v, h) > 1.0, 1.0 - v, mid)


def _epanechnikov_dloss(v, h):
    z = torch.clamp(_z(v, h), -1.0, 1.0)
    return -(2.0 + 3.0 * z - z**3) / 4.0


def _epanechnikov_ddloss(v, h):
    z = _z(v, h)
    return torch.where(torch.abs(z) <= 1.0, 0.75 * (1.0 - z**2) / h,
                       torch.zeros_like(z))


@dataclasses.dataclass(frozen=True)
class SmoothedHinge:
    """A convolution-smoothed hinge loss for a fixed kernel family."""

    name: str
    _loss: Callable
    _dloss: Callable
    _ddloss: Callable
    _ch: float  # c_h = _ch / h  (Lemma 2.1)

    def loss(self, v: Tensor, h: float) -> Tensor:
        return self._loss(v, h)

    def dloss(self, v: Tensor, h: float) -> Tensor:
        return self._dloss(v, h)

    def ddloss(self, v: Tensor, h: float) -> Tensor:
        return self._ddloss(v, h)

    def lipschitz(self, h: float) -> float:
        """Lipschitz constant c_h of L_h' (Lemma 2.1)."""
        return self._ch / h


_REGISTRY = {
    "laplacian": SmoothedHinge("laplacian", _laplacian_loss, _laplacian_dloss,
                               _laplacian_ddloss, 0.5),
    "logistic": SmoothedHinge("logistic", _logistic_loss, _logistic_dloss,
                              _logistic_ddloss, 0.25),
    "gaussian": SmoothedHinge("gaussian", _gaussian_loss, _gaussian_dloss,
                              _gaussian_ddloss, _INV_SQRT_2PI),
    "uniform": SmoothedHinge("uniform", _uniform_loss, _uniform_dloss,
                             _uniform_ddloss, 0.5),
    "epanechnikov": SmoothedHinge("epanechnikov", _epanechnikov_loss,
                                  _epanechnikov_dloss, _epanechnikov_ddloss,
                                  0.75),
}


def get_kernel(name: str) -> SmoothedHinge:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown kernel {name!r}; choose from {KERNELS}") from None


def smoothed_hinge_loss(v: Tensor, h: float, kernel: str = "epanechnikov") -> Tensor:
    return get_kernel(kernel).loss(v, h)


def smoothed_hinge_grad(v: Tensor, h: float, kernel: str = "epanechnikov") -> Tensor:
    return get_kernel(kernel).dloss(v, h)


def default_bandwidth(n_total: int, p: int) -> float:
    """Paper Section 4.1: h = max{(log p / N)^(1/4), 0.05}."""
    return max((math.log(max(p, 2)) / max(n_total, 2)) ** 0.25, 0.05)
