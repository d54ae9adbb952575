"""Decoder blocks: dispatch over block kinds.

Counterpart of ``repro.models.blocks``.  The port runs kind ``"attn"``
(pre-norm attention + MLP, the dense decoder-only families); the other
kinds and the encoder-decoder stack wait for later slices of the port and
raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.models import attention, layers, mlp
from repro_torch.models.config import ModelConfig

_WAITS = {
    "ssm": "the mamba2 slice with the ssd_scan kernel",
    "moe": "the MoE slice",
    "rec": "the RG-LRU hybrid slice",
}


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
        require_attn(kind)


def require_attn(kind: str) -> None:
    if kind != "attn":
        raise NotImplementedError(
            f"'{kind}' blocks wait for {_WAITS.get(kind, 'a later slice')} "
            "of the port (ROADMAP Queue 1 item 13)")


class Block(nn.Module):
    """Pre-norm block of kind "attn": ln1 -> attn -> residual, ln2 -> mlp
    -> residual."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype,
                 gen: torch.Generator):
        super().__init__()
        require_attn(kind)
        self.ln1 = layers.init_norm(cfg.d_model, cfg.norm, dtype, gen.device)
        self.ln2 = layers.init_norm(cfg.d_model, cfg.norm, dtype, gen.device)
        self.attn = attention.init_attention(cfg, dtype, gen)
        self.mlp = mlp.init_mlp(cfg, dtype, gen)


def init_block(cfg: ModelConfig, kind: str, dtype,
               gen: torch.Generator) -> Block:
    return Block(cfg, kind, dtype, gen)


def block_forward(params: Block, x, cfg: ModelConfig, kind: str, *,
                  causal: bool = True, window: Optional[int] = None):
    """Full-sequence block.  Returns (x, aux_loss)."""
    require_attn(kind)
    h = layers.apply_norm(x, params.ln1, cfg.norm)
    x = x + attention.attention_forward(params.attn, h, cfg, causal=causal,
                                        window=window)
    h = layers.apply_norm(x, params.ln2, cfg.norm)
    x = x + mlp.mlp_forward(params.mlp, h, cfg)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, device, window: Optional[int] = None) -> dict:
    require_attn(kind)
    cache_len = min(max_len, window) if window else max_len
    return attention.init_kv_cache(cfg, batch, cache_len, dtype, device)


def block_decode(params: Block, x1, cache, pos, cfg: ModelConfig,
                 kind: str, *, window: Optional[int] = None):
    """One-token block step (the cache is updated in place).  Returns
    (x1, cache)."""
    require_attn(kind)
    h = layers.apply_norm(x1, params.ln1, cfg.norm)
    y, cache = attention.attention_decode(params.attn, h, cache, pos, cfg,
                                          window=window)
    x1 = x1 + y
    h = layers.apply_norm(x1, params.ln2, cfg.norm)
    return x1 + mlp.mlp_forward(params.mlp, h, cfg), cache
