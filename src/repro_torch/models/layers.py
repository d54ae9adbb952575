"""Shared neural-net layers: norms, RoPE, activations, initializers.

Counterpart of ``repro.models.layers``.  Norm parameters live in a small
``Norm`` module (``scale``, and ``bias`` for layernorm) under the JAX
package's names; every function here is a plain function on tensors.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    """The parameter dtype named by ``cfg.param_dtype``."""
    return getattr(torch, cfg.param_dtype)


# the functions ``placing`` installs, innermost last
_placing: list = []


@contextlib.contextmanager
def placing(fn):
    """Within: every parameter a model's init makes passes through ``fn``
    (the whole parameter -> the parameter to keep), in the order of the
    init's draws (``launch.sharding.init_sharded`` keeps a rank's block
    of each)."""
    _placing.append(fn)
    try:
        yield
    finally:
        _placing.pop()


def frozen(t: Tensor) -> nn.Parameter:
    """A parameter that autograd does not track, as serving wants it;
    ``model.trainable_`` unfreezes a model for training."""
    p = nn.Parameter(t, requires_grad=False)
    return _placing[-1](p) if _placing else p


class ShapeOnly:
    """Stands in for the generator of a model's init on the meta device:
    the parameters' names, shapes and dtypes, and no draw
    (``model.abstract_params``)."""
    device = torch.device("meta")


def dense_init(gen: torch.Generator, shape, dtype, scale: float = 0.02):
    """N(0, scale^2) drawn in fp32 from ``gen`` on its device, then cast to
    ``dtype`` (as ``repro.models.layers.dense_init`` casts); on the meta
    device an empty tensor."""
    if gen.device.type == "meta":
        return frozen(torch.empty(shape, dtype=dtype, device="meta"))
    draw = torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)
    return frozen((draw * scale).to(dtype))


def rmsnorm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    """RMS norm with a ``(1 + scale)`` gain, computed in fp32."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)


def layernorm(x: Tensor, scale: Tensor, bias: Tensor,
              eps: float = 1e-5) -> Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


class Norm(nn.Module):
    """rmsnorm: ``scale`` (zeros, the gain is 1 + scale); layernorm:
    ``scale`` (ones) and ``bias`` (zeros)."""

    def __init__(self, d: int, kind: str, dtype, device):
        super().__init__()
        if kind == "rmsnorm":
            self.scale = frozen(torch.zeros(d, dtype=dtype, device=device))
        else:
            self.scale = frozen(torch.ones(d, dtype=dtype, device=device))
            self.bias = frozen(torch.zeros(d, dtype=dtype, device=device))


def init_norm(d: int, kind: str, dtype, device) -> Norm:
    return Norm(d, kind, dtype, device)


def apply_norm(x: Tensor, params: Norm, kind: str) -> Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, params.scale)
    return layernorm(x, params.scale, params.bias)


def rope_freqs(head_dim: int, fraction: float, theta: float, device=None):
    rot = int(head_dim * fraction) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    inv = 1.0 / (theta ** exps)
    return inv, rot


def apply_rope(x: Tensor, positions: Tensor, *, fraction: float = 1.0,
               theta: float = 10000.0) -> Tensor:
    """x: (..., S, H, D); rotary on the leading ``fraction`` of D.

    Rotates interleaved pairs (x[..., 0::2], x[..., 1::2]) as the JAX
    package does, not the half-split layout of other code bases.
    positions: (..., S) integer positions (broadcastable to x's batch
    dims).
    """
    D = x.shape[-1]
    inv, rot = rope_freqs(D, fraction, theta, device=x.device)
    if rot == 0:
        return x
    ang = positions.to(torch.float32)[..., None] * inv      # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


def gelu(x: Tensor) -> Tensor:
    return torch.nn.functional.gelu(x, approximate="tanh")


def silu(x: Tensor) -> Tensor:
    return torch.nn.functional.silu(x)
