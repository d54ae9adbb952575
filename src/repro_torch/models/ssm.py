"""Mamba-2 (SSD, state-space duality) block — arXiv:2405.21060.

Counterpart of ``repro.models.ssm``.  Prefill runs the chunked SSD
algorithm (quadratic within a chunk, a linear recurrence across chunks);
decode carries a (B, nheads, headdim, state) SSM state.

The JAX package runs the XLA twin ``ssd_chunked`` on every path (and
trains through its XLA autodiff) and leaves its Pallas ``ssd_scan``
kernel off them.  Here ``ssd`` takes the twin's place as
``attention.self_attend`` does for attention: for tensors on the card it
launches the hand-written CUDA kernel (``repro_torch.kernels.ops.ssd_scan``)
at ``cfg.ssm_chunk``, which takes a ragged tail itself and also returns
the final state; under grad the call goes through ``ops.SSDScan``, whose
backward is the hand-written ``ssd_scan_backward`` kernel (serving, with
no grad, stays one ``ssd_scan`` launch).  For tensors on the CPU it runs
the plain ``ssd_chunked`` with the JAX package's chunk rule (the chunk
shrinks until it divides S), trained by torch autograd, so that the CPU
path mirrors JAX.

Oracle for tests: ``ssd_naive`` (the direct recurrence).  The decode step
updates its cache entries in place.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


class Mamba(nn.Module):
    """in_proj (d, 2·di + 2·g·n + nh), conv_w (W, conv_ch), conv_b, the fp32
    A_log, D and dt_bias (nh,), norm_scale (di,) and out_proj (di, d), under
    the names of ``repro.models.ssm.init_mamba``."""

    def __init__(self, cfg: ModelConfig, dtype, gen: torch.Generator):
        super().__init__()
        d = cfg.d_model
        di, n, nh, g = (cfg.ssm_dinner, cfg.ssm_state, cfg.ssm_nheads,
                        cfg.ssm_groups)
        zdim = 2 * di + 2 * g * n + nh
        conv_ch = di + 2 * g * n
        dev = gen.device
        f32 = torch.float32
        self.in_proj = layers.dense_init(gen, (d, zdim), dtype)
        self.conv_w = layers.dense_init(gen, (cfg.conv_width, conv_ch), dtype,
                                        0.2)
        self.conv_b = layers.frozen(torch.zeros(conv_ch, dtype=dtype,
                                                device=dev))
        # fp32 in every model dtype, as the JAX package keeps them
        self.A_log = layers.frozen(torch.log(torch.linspace(
            1.0, 16.0, nh, dtype=f32, device=dev)))
        self.D = layers.frozen(torch.ones(nh, dtype=f32, device=dev))
        self.dt_bias = layers.frozen(torch.zeros(nh, dtype=f32, device=dev))
        self.norm_scale = layers.frozen(torch.zeros(di, dtype=dtype,
                                                    device=dev))
        self.out_proj = layers.dense_init(gen, (di, d), dtype)


def init_mamba(cfg: ModelConfig, dtype, gen: torch.Generator) -> Mamba:
    return Mamba(cfg, dtype, gen)


def _segsum(a: Tensor) -> Tensor:
    """a: (..., l, h) -> (..., h, l, l) lower-triangular segment sums
    T[i,j] = sum_{j < k <= i} a_k (and -inf above the diagonal)."""
    l = a.shape[-2]
    a = a.movedim(-1, -2)                                # (..., h, l)
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]           # T[i,j] = cs_i - cs_j
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -math.inf)


def ssd_chunked(x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor,
                chunk: int, D: Optional[Tensor] = None,
                init_state: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
    """Chunked SSD (plain torch).

    x: (b, s, h, p); dt: (b, s, h) (already softplus'd, > 0); A: (h,) (< 0);
    B, C: (b, s, n) (single group, broadcast over heads); s % chunk == 0.
    Returns (y: (b, s, h, p) in x's dtype, final_state: (b, h, p, n) fp32).
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd_chunked: s={s} is not a multiple of "
                         f"chunk={chunk}")
    c, l = s // chunk, chunk
    f32 = torch.float32
    xf = x.to(f32)
    x_dt = xf * dt[..., None]                            # input scaled by dt
    A_dt = A[None, None, :] * dt                         # (b, s, h)

    def ch(t):  # (b, s, ...) -> (b, c, l, ...)
        return t.reshape(b, c, l, *t.shape[2:])

    x_c, Adt_c = ch(x_dt), ch(A_dt)
    B_c, C_c = ch(B.to(f32)), ch(C.to(f32))
    A_cum = torch.cumsum(Adt_c, dim=2)                   # (b, c, l, h)

    # intra-chunk (quadratic, "attention-like" dual form)
    L = torch.exp(_segsum(Adt_c))                        # (b, c, h, l, l)
    Y_diag = torch.einsum("bcln,bcsn,bchls,bcshp->bclhp", C_c, B_c, L, x_c)

    # per-chunk input states
    decay_states = torch.exp(A_cum[:, :, -1:, :] - A_cum)       # (b, c, l, h)
    states = torch.einsum("bcln,bclh,bclhp->bchpn", B_c, decay_states, x_c)

    # inter-chunk recurrence over the chunk index
    chunk_decay = torch.exp(A_cum[:, :, -1, :])          # (b, c, h)
    prev = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
            if init_state is None else init_state.to(f32))
    prev_states = []
    for k in range(c):
        prev_states.append(prev)
        prev = prev * chunk_decay[:, k, :, None, None] + states[:, k]
    final = prev
    prev_states = torch.stack(prev_states, dim=1)        # (b, c, h, p, n)

    decay_out = torch.exp(A_cum)                         # (b, c, l, h)
    Y_off = torch.einsum("bcln,bchpn,bclh->bclhp", C_c, prev_states,
                         decay_out)

    y = (Y_diag + Y_off).reshape(b, s, h, p)
    if D is not None:
        y = y + D[None, None, :, None] * xf
    return y.to(x.dtype), final


def ssd_naive(x, dt, A, B, C, D=None, init_state=None):
    """Direct recurrence oracle.  Same shapes as ``ssd_chunked``."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    f32 = torch.float32
    xf, Bf, Cf = x.to(f32), B.to(f32), C.to(f32)
    state = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    ys = []
    for t in range(s):
        da = torch.exp(A[None] * dt[:, t])               # (b, h)
        state = (state * da[..., None, None]
                 + (dt[:, t, :, None] * xf[:, t])[..., None]
                 * Bf[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + D[None, None, :, None] * xf
    return y.to(x.dtype), state


def jax_chunk(chunk: int, S: int) -> int:
    """The JAX package's chunk rule: the largest chunk <= min(chunk, S)
    that divides S."""
    c = min(chunk, S)
    while S % c:
        c -= 1
    return c


def ssd(x, dt, A, B, C, D, cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """The SSD scan of one layer: (y (b, s, h, p), final state (b, h, p, n)
    fp32).  On the card (and on meta, a dry run: the kernel's meta route):
    the CUDA ``ssd_scan`` kernel at ``cfg.ssm_chunk``, fed the model's
    strided slices of the conv output (no copy), through ``ops.SSDScan``
    (the ``ssd_scan_backward`` kernel) when an input requires grad; on the
    CPU: the plain ``ssd_chunked`` at the JAX package's chunk."""
    if x.device.type in ops.CARD_ROUTE:
        return ops.ssd_scan(x, dt, A, B, C, D, chunk=cfg.ssm_chunk)
    return ssd_chunked(x, dt, A, B, C, jax_chunk(cfg.ssm_chunk, x.shape[1]),
                       D=D)


def _causal_conv(u: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv.  u: (B, S, C), w: (W, C).  Summed in fp32 as
    W shifted products (no cuDNN, so no TF32 on the card)."""
    W, S = w.shape[0], u.shape[1]
    up = torch.nn.functional.pad(u.to(torch.float32), (0, 0, W - 1, 0))
    wf = w.to(torch.float32)
    out = up[:, 0:S] * wf[0]
    for k in range(1, W):
        out = out + up[:, k:k + S] * wf[k]
    return layers.silu(out + b.to(torch.float32)).to(u.dtype)


def _split_proj(zxbcdt: Tensor, cfg: ModelConfig):
    di, n, g = cfg.ssm_dinner, cfg.ssm_state, cfg.ssm_groups
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * g * n]
    dt = zxbcdt[..., di + di + 2 * g * n:]
    return z, xbc, dt


def softplus(x: Tensor) -> Tensor:
    """log(1 + e^x), as ``jax.nn.softplus`` (no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _gate_norm_out(params: Mamba, y: Tensor, z: Tensor) -> Tensor:
    """rmsnorm(y * silu(z)) @ out_proj, rounded where the JAX package
    rounds (silu in fp32, cast to y's dtype before the product)."""
    y = layers.rmsnorm(y * layers.silu(z.to(torch.float32)).to(y.dtype),
                       params.norm_scale)
    return y @ params.out_proj


def mamba_mix(params: Mamba, u: Tensor, cfg: ModelConfig):
    """The full-sequence mixer.  u: (B, S, d) -> (out (B, S, d), the
    pre-conv xbc (B, S, conv_ch), final SSM state (B, nh, hd, n) fp32)."""
    Bsz, S, _ = u.shape
    di, n, nh, hd = (cfg.ssm_dinner, cfg.ssm_state, cfg.ssm_nheads,
                     cfg.ssm_headdim)
    z, xbc_in, dt = _split_proj(u @ params.in_proj, cfg)
    xbc = _causal_conv(xbc_in, params.conv_w, params.conv_b)
    x = xbc[..., :di].reshape(Bsz, S, nh, hd)
    Bmat = xbc[..., di:di + n]
    Cmat = xbc[..., di + n:di + 2 * n]
    dt = softplus(dt.to(torch.float32) + params.dt_bias)
    A = -torch.exp(params.A_log)
    y, final = ssd(x, dt, A, Bmat, Cmat, params.D, cfg)
    out = _gate_norm_out(params, y.reshape(Bsz, S, di), z)
    return out, xbc_in, final


def mamba_forward(params: Mamba, u: Tensor, cfg: ModelConfig) -> Tensor:
    """Full-sequence Mamba-2 mixer.  u: (B, S, d) -> (B, S, d)."""
    return mamba_mix(params, u, cfg)[0]


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """{"conv": (B, W-1, conv_ch) in the model dtype, "ssm": (B, nh, hd, n)
    fp32}, zeros."""
    n, nh = cfg.ssm_state, cfg.ssm_nheads
    conv_ch = cfg.ssm_dinner + 2 * cfg.ssm_groups * n
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, nh, cfg.ssm_headdim, n),
                           dtype=torch.float32, device=device),
    }


def mamba_decode(params: Mamba, u1: Tensor, cache: dict, cfg: ModelConfig):
    """One-token step.  u1: (B, 1, d).  The cache entries are updated in
    place (the JAX package returns new ones); returns (out (B, 1, d),
    cache)."""
    Bsz = u1.shape[0]
    di, n, nh, hd = (cfg.ssm_dinner, cfg.ssm_state, cfg.ssm_nheads,
                     cfg.ssm_headdim)
    f32 = torch.float32
    z, xbc, dt = _split_proj(u1 @ params.in_proj, cfg)
    hist = torch.cat([cache["conv"], xbc], dim=1)              # (B, W, C)
    conv_out = ((hist.to(f32) * params.conv_w.to(f32)).sum(1)
                + params.conv_b.to(f32))
    xbc1 = layers.silu(conv_out)[:, None, :].to(u1.dtype)
    x = xbc1[..., :di].reshape(Bsz, nh, hd).to(f32)
    Bmat = xbc1[:, 0, di:di + n].to(f32)
    Cmat = xbc1[:, 0, di + n:di + 2 * n].to(f32)
    dtv = softplus(dt[:, 0].to(f32) + params.dt_bias)          # (B, nh)
    A = -torch.exp(params.A_log)
    da = torch.exp(A[None] * dtv)
    state = (cache["ssm"] * da[..., None, None]
             + (dtv[..., None] * x)[..., None] * Bmat[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", state, Cmat)
    y = y + params.D[None, :, None] * x
    y = y.reshape(Bsz, 1, di).to(u1.dtype)
    cache["conv"].copy_(hist[:, 1:])
    cache["ssm"].copy_(state)
    return _gate_norm_out(params, y, z), cache
