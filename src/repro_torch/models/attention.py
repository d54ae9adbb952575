"""Grouped-query attention: init, full-sequence (prefill) forward, and
one-token decode against a preallocated KV cache; cross-attention of a
decoder over the encoder's output (``kv_x``) or its projected K/V
(``cross_kv``).

Counterpart of ``repro.models.attention``.  The full-sequence self-
attention is where the JAX package's Pallas ``flash_attention`` kernel
replaces its q-chunked XLA twin ``_attend`` 1:1.  Here ``self_attend``
runs the hand-written CUDA kernel (``repro_torch.kernels.ops.
flash_attention``) for tensors on the card and the plain ``_attend`` for
tensors on the CPU; the q chunking of the JAX twin is a memory measure for
XLA that neither needs (the kernel streams the keys itself).  The
full-sequence cross-attention (``cross_attend``: no RoPE, no mask, keys of
the encoder's length) runs the same kernel on the card; the Pallas kernel
takes one length for q and kv, so on the TPU it stayed with XLA.  The
one-token decode attention, self and cross, is plain torch, as the JAX
package leaves it to XLA.

Training: the JAX package differentiates ``_attend`` with XLA's autodiff
(its Pallas kernel has no VJP and never runs in training).  On the card
the port's kernel output carries no autograd graph, so ``self_attend``
and ``cross_attend`` go through ``ops.FlashAttention``, whose backward
is the hand-written ``flash_attention_backward`` kernel; on the CPU
autograd differentiates ``_attend``.

JAX's attention pins no activation layout here either; the port's
``models.shardctx.constrain`` is the identity, since its sharded train
step gives each rank whole rows (``launch.train``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor
NEG_INF = -1e30     # never -inf: a row with every key masked stays finite


class Attention(nn.Module):
    """wq (d, A), wk and wv (d, KV*D), wo (A, d); biases bq, bk, bv with
    ``attn_bias``; q_norm and k_norm (D,) with ``qk_norm``, except for
    cross-attention."""

    def __init__(self, cfg: ModelConfig, dtype, gen: torch.Generator,
                 cross: bool = False):
        super().__init__()
        d, A, KVD = cfg.d_model, cfg.attn_dim, cfg.kv_dim
        dev = gen.device
        self.wq = layers.dense_init(gen, (d, A), dtype)
        self.wk = layers.dense_init(gen, (d, KVD), dtype)
        self.wv = layers.dense_init(gen, (d, KVD), dtype)
        self.wo = layers.dense_init(gen, (A, d), dtype)
        if cfg.attn_bias:
            self.bq = layers.frozen(torch.zeros(A, dtype=dtype, device=dev))
            self.bk = layers.frozen(torch.zeros(KVD, dtype=dtype, device=dev))
            self.bv = layers.frozen(torch.zeros(KVD, dtype=dtype, device=dev))
        if cfg.qk_norm and not cross:
            D = cfg.head_dim
            self.q_norm = layers.frozen(torch.zeros(D, dtype=dtype, device=dev))
            self.k_norm = layers.frozen(torch.zeros(D, dtype=dtype, device=dev))


def init_attention(cfg: ModelConfig, dtype, gen: torch.Generator,
                   cross: bool = False) -> Attention:
    return Attention(cfg, dtype, gen, cross)


def _project(params: Attention, x, cfg: ModelConfig, which: str, heads: int,
             rope: bool, positions: Optional[Tensor]):
    """One of q ("q", ``heads`` = H) and k ("k", ``heads`` = KV) of x
    (B, S, d) as (B, S, heads, D): projection, bias, qk-norm and RoPE."""
    t = x @ getattr(params, f"w{which}")
    if cfg.attn_bias:
        t = t + getattr(params, f"b{which}")
    t = t.reshape(x.shape[0], -1, heads, cfg.head_dim)
    if cfg.qk_norm:
        t = layers.rmsnorm(t, getattr(params, f"{which}_norm"))
    if rope and cfg.pos_embedding == "rope":
        t = layers.apply_rope(t, positions, fraction=cfg.rope_fraction,
                              theta=cfg.rope_theta)
    return t


def project_q(params: Attention, x, cfg: ModelConfig, *, rope: bool,
              positions: Optional[Tensor] = None):
    """q (B, S, H, D) of x (B, S, d)."""
    return _project(params, x, cfg, "q", cfg.num_heads, rope, positions)


def project_kv(params: Attention, kv_x, cfg: ModelConfig, *, rope: bool,
               positions: Optional[Tensor] = None):
    """k and v (B, Skv, KV, D) of kv_x (B, Skv, d); v takes the bias but
    neither the norm nor RoPE."""
    k = _project(params, kv_x, cfg, "k", cfg.num_kv_heads, rope, positions)
    v = kv_x @ params.wv
    if cfg.attn_bias:
        v = v + params.bv
    return k, v.reshape(kv_x.shape[0], -1, cfg.num_kv_heads, cfg.head_dim)


def _project_qkv(params: Attention, x, kv_x, cfg: ModelConfig, *,
                 rope: bool, q_positions: Optional[Tensor],
                 k_positions: Optional[Tensor]):
    """q (B, S, H, D) and k, v (B, Skv, KV, D): projections, biases,
    qk-norm and RoPE.  (``attn_act_shard`` only pins layouts on a mesh.)"""
    k, v = project_kv(params, kv_x, cfg, rope=rope, positions=k_positions)
    return project_q(params, x, cfg, rope=rope, positions=q_positions), k, v


def _attend(q, k, v, q_pos, k_pos, *, causal: bool,
            window: Optional[int]):
    """Plain attention.  q: (B, Sq, H, D); k, v: (B, Sk, KV, D).  Returns
    (B, Sq, H, D); fp32 logits and softmax."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    g = H // KV
    f32 = torch.float32
    qg = q.reshape(B, Sq, KV, g, D).to(f32)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(f32)) * (D ** -0.5)
    mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(f32))
    return out.reshape(B, Sq, H, D).to(q.dtype)


def self_attend(q, k, v, *, causal: bool, window: Optional[int]):
    """Self-attention over positions 0..S-1: q (B, S, H, D), k and v
    (B, S, KV, D) -> (B, S, H, D).  On the card (and on meta, a dry run:
    the kernel's meta route): the CUDA flash kernel, fed the (B, S, H, D)
    tensors as strided (B, H, S, D) views (no copy), and under grad its
    backward kernel (``ops.FlashAttention``); on the CPU: the plain
    ``_attend``, which autograd differentiates."""
    if q.device.type in ops.CARD_ROUTE:
        out = ops.FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), causal, window,
                                       None)
        return out.transpose(1, 2)
    pos = torch.arange(q.shape[1], device=q.device)
    return _attend(q, k, v, pos, pos, causal=causal, window=window)


def cross_attend(q, k, v):
    """Cross-attention, every query against every key: q (B, S, H, D), k
    and v (B, F, KV, D) -> (B, S, H, D).  On the card (and on meta): the
    CUDA flash kernel, non-causal, with keys of their own length F, fed
    strided (B, heads, rows, D) views as ``self_attend`` feeds it,
    differentiated by its backward kernel under grad; on the CPU: the
    plain ``_attend``."""
    if q.device.type in ops.CARD_ROUTE:
        out = ops.FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), False, None, None)
        return out.transpose(1, 2)
    return _attend(q, k, v, torch.arange(q.shape[1], device=q.device),
                   torch.arange(k.shape[1], device=q.device), causal=False,
                   window=None)


def cross_forward(params: Attention, x, cfg: ModelConfig,
                  cross_kv: dict) -> Tensor:
    """Full-sequence cross-attention over projected encoder K/V
    (``cross_kv``: {"k", "v"} (B, F, KV, D), as ``project_kv`` gives
    them): x (B, S, d) -> (B, S, d); no RoPE and no mask."""
    B, S, _ = x.shape
    q = project_q(params, x, cfg, rope=False)
    out = cross_attend(q, cross_kv["k"], cross_kv["v"])
    return out.reshape(B, S, -1) @ params.wo


def attention_forward(params: Attention, x, cfg: ModelConfig, *,
                      causal: bool = True, window: Optional[int] = None,
                      kv_x: Optional[Tensor] = None) -> Tensor:
    """Full-sequence attention.  x: (B, S, d) -> (B, S, d).  With ``kv_x``
    (B, F, d), cross-attention over it: no RoPE and no mask."""
    if kv_x is not None:
        k, v = project_kv(params, kv_x, cfg, rope=False)
        return cross_forward(params, x, cfg, {"k": k, "v": v})
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(params, x, x, cfg, rope=True, q_positions=pos,
                           k_positions=pos)
    out = self_attend(q, k, v, causal=causal, window=window)
    return out.reshape(B, S, -1) @ params.wo


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device) -> dict:
    KV, D = cfg.num_kv_heads, cfg.head_dim
    shape = (batch, max_len, KV, D)
    if cfg.kv_cache_dtype == "int8":
        scales = (batch, max_len, KV, 1)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(scales, dtype=torch.float32, device=device),
            "v_scale": torch.zeros(scales, dtype=torch.float32, device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _quantize_kv(x):
    """(B, 1, KV, D) -> int8 values + per-(token, head) absmax scale."""
    xf = x.to(torch.float32)
    scale = torch.amax(torch.abs(xf), dim=-1, keepdim=True) / 127.0
    q = torch.round(xf / torch.clamp(scale, min=1e-9))
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def attention_decode(params: Attention, x1, cache: dict, pos,
                     cfg: ModelConfig, *, window: Optional[int] = None,
                     cross_kv: Optional[dict] = None):
    """One-token decode.  x1: (B, 1, d); pos: a scalar (lockstep batch) or
    a (B,) vector (every slot at its own position).

    The cache is a ring buffer (slot = pos mod cache length) and is
    updated in place (the JAX package returns a new one); returns
    (out (B, 1, d), cache).  With ``cross_kv`` ({"k", "v"}: (B, F, KV,
    D)), attends that fixed encoder K/V instead and leaves ``cache`` as it
    is.
    """
    B = x1.shape[0]
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cross_kv is not None:
        k, v = cross_kv["k"], cross_kv["v"]
        q = project_q(params, x1, cfg, rope=False)
        F = k.shape[1]
        out = _attend(q, k, v,
                      torch.full((1,), F, device=x1.device),
                      torch.arange(F, device=x1.device), causal=False,
                      window=None)
        return out.reshape(B, 1, -1) @ params.wo, cache
    pos_b = torch.as_tensor(pos, device=x1.device).reshape(-1).long()
    pos_b = pos_b.expand(B)                                       # (B,)
    q, k1, v1 = _project_qkv(params, x1, x1, cfg, rope=True,
                             q_positions=pos_b[:, None],
                             k_positions=pos_b[:, None])
    Smax = cache["k"].shape[1]
    slot = pos_b % Smax                                           # (B,)
    rows = torch.arange(B, device=x1.device)
    if cfg.kv_cache_dtype == "int8":
        for name, new in (("k", k1), ("v", v1)):
            vals, scale = _quantize_kv(new)
            cache[name][rows, slot] = vals[:, 0]
            cache[f"{name}_scale"][rows, slot] = scale[:, 0]
        k = cache["k"].to(torch.float32) * cache["k_scale"]
        v = cache["v"].to(torch.float32) * cache["v_scale"]
    else:
        cache["k"][rows, slot] = k1[:, 0].to(cache["k"].dtype)
        cache["v"][rows, slot] = v1[:, 0].to(cache["v"].dtype)
        k, v = cache["k"], cache["v"]
    mask = slot_mask(pos_b, torch.arange(Smax, device=x1.device), Smax,
                     window)
    out = decode_attend(q, k, v, mask).to(x1.dtype)
    return out @ params.wo, cache


def slot_mask(pos_b: Tensor, slots: Tensor, Smax: int,
              window: Optional[int]) -> Tensor:
    """(B, len(slots)) bool: whether each cache slot of a ring of Smax
    holds a position the query at ``pos_b`` (B,) attends."""
    # absolute position held by each slot: the largest p <= pos with
    # p = slot (mod Smax); negative => slot not yet written
    k_pos = pos_b[:, None] - ((pos_b[:, None] - slots[None, :]) % Smax)
    mask = (k_pos >= 0) & (k_pos <= pos_b[:, None])                # (B, S)
    if window is not None:
        mask &= k_pos > pos_b[:, None] - window
    return mask


def decode_logits(q, k, mask: Optional[Tensor]) -> Tensor:
    """One query a row against the keys k (B, S, KV, D): fp32 logits
    (B, KV, g, 1, S), the masked slots (``mask`` (B, S)) at NEG_INF."""
    B, _, H, D = q.shape
    KV = k.shape[2]
    f32 = torch.float32
    qg = q.reshape(B, 1, KV, H // KV, D).to(f32)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(f32)) * (D ** -0.5)
    if mask is None:
        return logits
    return torch.where(mask[:, None, None, None, :], logits, NEG_INF)


def decode_attend(q, k, v, mask: Optional[Tensor]) -> Tensor:
    """One-token attention: q (B, 1, H, D) over k, v (B, S, KV, D), the
    slots of ``mask`` (B, S) or all -> fp32 (B, 1, H * D)."""
    B, _, H, D = q.shape
    probs = torch.softmax(decode_logits(q, k, mask), dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(torch.float32))
    return out.reshape(B, 1, H * D)
