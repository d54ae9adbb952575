"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Counterpart of ``repro.models.rglru``.  Per channel:

    r_t = sigmoid(x_t W_a + b_a)                    (recurrence gate)
    i_t = sigmoid(x_t W_x + b_x)                    (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)          (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

and the block wraps it Griffin-style:
y = W_out[GeLU(x W_g) * RGLRU(conv4(x W_r))].

The JAX package runs the recurrence as ``jax.lax.associative_scan`` over
the (a, b) monoid, (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2): a compiled
scan of O(log S) depth and no Pallas kernel.  ``rglru_scan`` keeps that
form in torch ops: a Hillis-Steele inclusive scan, ceil(log2 S) rounds
each combining every position with the one 2^r before it, so the number
of launches grows with log S and not with S.  It never takes the closed
form exp(cumsum log a) * cumsum(b / ...), whose quotients overflow over
long sequences.  The decode step updates its cache entries in place.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.ssm import softplus

Tensor = torch.Tensor
_C = 8.0


class RGLRU(nn.Module):
    """w_rec_in, w_gate_in (d, w), w_out (w, d), conv_w (W, w), conv_b,
    wa, wx (w, w) in the model dtype; ba, bx and lam (w,) fp32; under the
    names of ``repro.models.rglru.init_rglru_block``."""

    def __init__(self, cfg: ModelConfig, dtype, gen: torch.Generator):
        super().__init__()
        d, w = cfg.d_model, cfg.lru_width
        dev = gen.device
        f32 = torch.float32
        self.w_rec_in = layers.dense_init(gen, (d, w), dtype)
        self.w_gate_in = layers.dense_init(gen, (d, w), dtype)
        self.w_out = layers.dense_init(gen, (w, d), dtype)
        self.conv_w = layers.dense_init(gen, (cfg.conv_width, w), dtype, 0.2)
        self.conv_b = layers.frozen(torch.zeros(w, dtype=dtype, device=dev))
        self.wa = layers.dense_init(gen, (w, w), dtype)
        self.ba = layers.frozen(torch.zeros(w, dtype=f32, device=dev))
        self.wx = layers.dense_init(gen, (w, w), dtype)
        self.bx = layers.frozen(torch.zeros(w, dtype=f32, device=dev))
        # a in (0.9, 0.999) at r = 1 (Griffin appendix)
        self.lam = layers.frozen(torch.linspace(-4.0, -1.0, w, dtype=f32,
                                                device=dev))


def init_rglru_block(cfg: ModelConfig, dtype, gen: torch.Generator) -> RGLRU:
    return RGLRU(cfg, dtype, gen)


def _gates(params: RGLRU, x: Tensor, cols: Optional[Tensor] = None):
    """x: (..., w) -> (log_a < 0, the gated input b), both fp32.  With
    ``cols``, a block of x's columns, the gates of those columns alone:
    ``params`` then holds the matching column blocks of wa and wx and
    slices of ba, bx and lam (the tensor-parallel decode)."""
    f32 = torch.float32
    xf = x.to(f32)
    r = torch.sigmoid(xf @ params.wa.to(f32) + params.ba)
    i = torch.sigmoid(xf @ params.wx.to(f32) + params.bx)
    log_a = -_C * softplus(params.lam) * r
    a2 = torch.exp(2.0 * log_a)
    xc = xf if cols is None else cols.to(f32)
    b = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * xc)
    return log_a, b


def linear_scan(a: Tensor, b: Tensor):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along axis 1:
    returns (prod a_1..t, h_t), each (B, S, w).  Hillis-Steele over the
    (a, b) monoid: round r combines position t with t - 2^r."""
    S = a.shape[1]
    shift = 1
    while shift < S:
        a_hi, b_hi = a[:, shift:], b[:, shift:]
        b = torch.cat([b[:, :shift], a_hi * b[:, :-shift] + b_hi], dim=1)
        a = torch.cat([a[:, :shift], a_hi * a[:, :-shift]], dim=1)
        shift *= 2
    return a, b


def rglru_scan(params: RGLRU, x: Tensor, init_h: Optional[Tensor] = None):
    """x: (B, S, w) -> (h_seq (B, S, w) fp32, final h (B, w))."""
    log_a, b = _gates(params, x)
    a_s, h = linear_scan(torch.exp(log_a), b)
    if init_h is not None:
        # fold the carried state into every prefix: h_t += (prod a_1..t) h_0
        h = h + a_s * init_h[:, None, :]
    return h, h[:, -1]


def _causal_conv(rec: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv of width W in fp32 (no activation), as W
    shifted products.  rec: (B, S, w) -> (B, S, w) fp32."""
    W, S = w.shape[0], rec.shape[1]
    rp = torch.nn.functional.pad(rec.to(torch.float32), (0, 0, W - 1, 0))
    wf = w.to(torch.float32)
    out = rp[:, 0:S] * wf[0]
    for k in range(1, W):
        out = out + rp[:, k:k + S] * wf[k]
    return out + b.to(torch.float32)


def rglru_mix(params: RGLRU, x: Tensor, cfg: ModelConfig):
    """The Griffin recurrent block.  x: (B, S, d) -> (out (B, S, d), the
    pre-conv branch rec (B, S, w), final h (B, w) fp32)."""
    rec = x @ params.w_rec_in
    gate = layers.gelu(x @ params.w_gate_in)
    conv = _causal_conv(rec, params.conv_w, params.conv_b)
    h, h_last = rglru_scan(params, conv.to(x.dtype))
    return (gate * h.to(x.dtype)) @ params.w_out, rec, h_last


def rglru_block_forward(params: RGLRU, x: Tensor, cfg: ModelConfig) -> Tensor:
    """Griffin recurrent block.  x: (B, S, d) -> (B, S, d)."""
    return rglru_mix(params, x, cfg)[0]


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """{"conv": (B, W-1, w) in the model dtype, "h": (B, w) fp32}, zeros."""
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.lru_width),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                         device=device),
    }


def rglru_block_decode(params: RGLRU, x1: Tensor, cache: dict,
                       cfg: ModelConfig):
    """One-token step.  x1: (B, 1, d).  The cache entries are updated in
    place; returns (out (B, 1, d), cache)."""
    f32 = torch.float32
    rec = x1 @ params.w_rec_in
    gate = layers.gelu(x1 @ params.w_gate_in)
    hist = torch.cat([cache["conv"], rec], dim=1)                # (B, W, w)
    conv = ((hist.to(f32) * params.conv_w.to(f32)).sum(1)
            + params.conv_b.to(f32))
    log_a, b = _gates(params, conv[:, None, :].to(x1.dtype))
    h = torch.exp(log_a[:, 0]) * cache["h"] + b[:, 0]
    out = (gate * h[:, None, :].to(x1.dtype)) @ params.w_out
    cache["conv"].copy_(hist[:, 1:])
    cache["h"].copy_(h)
    return out, cache
