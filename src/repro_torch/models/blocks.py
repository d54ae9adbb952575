"""Decoder blocks: dispatch over block kinds.

Counterpart of ``repro.models.blocks``.  The port runs every decoder-only
kind: ``"attn"`` (pre-norm attention + MLP, the dense families), ``"moe"``
(pre-norm attention + the MoE mixer, granite-moe), ``"ssm"`` (pre-norm
Mamba-2 mixer, mamba2) and ``"rec"`` (pre-norm RG-LRU block + MLP, the
recurrent layers of recurrentgemma).  The media frontends and the
encoder-decoder stack wait for a later slice of the port and raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.models import attention, layers, mlp, moe, rglru, ssm
from repro_torch.models.config import ModelConfig

PORTED = ("attn", "moe", "ssm", "rec")


def block_kinds(cfg: ModelConfig) -> tuple[str, ...]:
    """Per-layer kind for the decoder stack."""
    if cfg.arch_type == "ssm":
        return ("ssm",) * cfg.num_layers
    if cfg.arch_type == "hybrid":
        pat = cfg.block_pattern or ("rec", "rec", "attn")
        return tuple(pat[i % len(pat)] for i in range(cfg.num_layers))
    if cfg.arch_type == "moe":
        return ("moe",) * cfg.num_layers
    return ("attn",) * cfg.num_layers


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port does not run
    yet, naming the slice (ROADMAP Queue 1 item 13) it waits for."""
    if cfg.is_encoder_decoder or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.arch_type} frontends and the encoder-"
            "decoder stack wait for a later slice of the port (ROADMAP "
            "Queue 1 item 13)")
    for kind in sorted(set(block_kinds(cfg))):
        require_ported(kind)


def require_ported(kind: str) -> None:
    if kind not in PORTED:
        raise NotImplementedError(
            f"'{kind}' blocks wait for a later slice of the port (ROADMAP "
            "Queue 1 item 13)")


class Block(nn.Module):
    """Pre-norm block.  Kind "attn": ln1 -> attn -> residual, ln2 -> mlp
    -> residual; "moe": the same with ``moe`` in place of ``mlp``; "rec":
    the same with the RG-LRU ``mixer`` in place of ``attn``.  Kind "ssm":
    ln1 -> mixer (Mamba-2) -> residual; it also holds an ``ln2`` that it
    never uses, because the JAX package's ``init_block`` creates one for
    every kind and the weight carrier (``convert.params_from_jax``) loads
    every leaf of the JAX tree."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype,
                 gen: torch.Generator):
        super().__init__()
        require_ported(kind)
        self.ln1 = layers.init_norm(cfg.d_model, cfg.norm, dtype, gen.device)
        self.ln2 = layers.init_norm(cfg.d_model, cfg.norm, dtype, gen.device)
        if kind == "ssm":
            self.mixer = ssm.init_mamba(cfg, dtype, gen)
            return
        if kind == "rec":
            self.mixer = rglru.init_rglru_block(cfg, dtype, gen)
        else:
            self.attn = attention.init_attention(cfg, dtype, gen)
        if kind == "moe":
            self.moe = moe.init_moe(cfg, dtype, gen)
        else:
            self.mlp = mlp.init_mlp(cfg, dtype, gen)


def init_block(cfg: ModelConfig, kind: str, dtype,
               gen: torch.Generator) -> Block:
    return Block(cfg, kind, dtype, gen)


def feed_forward(params: Block, x, cfg: ModelConfig, kind: str):
    """ln2 -> MLP or MoE -> residual.  Returns (x, aux_loss or None)."""
    h = layers.apply_norm(x, params.ln2, cfg.norm)
    if kind == "moe":
        y, aux = moe.moe_forward(params.moe, h, cfg)
        return x + y, aux
    return x + mlp.mlp_forward(params.mlp, h, cfg), None


def block_forward(params: Block, x, cfg: ModelConfig, kind: str, *,
                  causal: bool = True, window: Optional[int] = None):
    """Full-sequence block.  Returns (x, aux_loss): the MoE load-balance
    loss for kind "moe", else 0."""
    require_ported(kind)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    h = layers.apply_norm(x, params.ln1, cfg.norm)
    if kind == "ssm":
        return x + ssm.mamba_forward(params.mixer, h, cfg), zero
    if kind == "rec":
        x = x + rglru.rglru_block_forward(params.mixer, h, cfg)
    else:
        x = x + attention.attention_forward(params.attn, h, cfg,
                                            causal=causal, window=window)
    x, aux = feed_forward(params, x, cfg, kind)
    return x, zero if aux is None else aux


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, device, window: Optional[int] = None) -> dict:
    require_ported(kind)
    if kind == "ssm":
        return ssm.init_mamba_cache(cfg, batch, dtype, device)
    if kind == "rec":
        return rglru.init_rglru_cache(cfg, batch, dtype, device)
    cache_len = min(max_len, window) if window else max_len
    return attention.init_kv_cache(cfg, batch, cache_len, dtype, device)


def block_decode(params: Block, x1, cache, pos, cfg: ModelConfig,
                 kind: str, *, window: Optional[int] = None):
    """One-token block step (the cache is updated in place).  Returns
    (x1, cache)."""
    require_ported(kind)
    h = layers.apply_norm(x1, params.ln1, cfg.norm)
    if kind == "ssm":
        y, cache = ssm.mamba_decode(params.mixer, h, cache, cfg)
        return x1 + y, cache
    if kind == "rec":
        y, cache = rglru.rglru_block_decode(params.mixer, h, cache, cfg)
    else:
        y, cache = attention.attention_decode(params.attn, h, cache, pos,
                                              cfg, window=window)
    x1, _ = feed_forward(params, x1 + y, cfg, kind)
    return x1, cache
