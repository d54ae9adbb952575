"""Decoder and encoder blocks: dispatch over block kinds.

Counterpart of ``repro.models.blocks``.  The port runs every kind:
``"attn"`` (pre-norm attention + MLP: the dense families, internvl2's
language model, and both stacks of seamless-m4t), ``"moe"`` (pre-norm
attention + the MoE mixer, granite-moe), ``"ssm"`` (pre-norm Mamba-2
mixer, mamba2) and ``"rec"`` (pre-norm RG-LRU block + MLP, the recurrent
layers of recurrentgemma).  A decoder block of an encoder-decoder model
also holds ``cross`` and ``ln_cross``: cross-attention over the encoder's
output between its mixer and its MLP.

``block_forward`` names the mixer's output "mixer_out" and the MLP's (or
MoE's) "mlp_out", where JAX's ``checkpoint_name`` does.  A selective
checkpoint policy sees aten ops, not names, so under the "names" remat
policy (``naming``) each of the two passes through ``NAMED_OP``, an
identity op of its own (a copy) that the policy saves; otherwise
``checkpoint_name`` returns its tensor as it is.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from repro_torch.models import attention, layers, mlp, moe, rglru, ssm
from repro_torch.models.config import ModelConfig


@torch.library.custom_op("repro_torch::checkpoint_name", mutates_args=())
def _named(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


_named.register_fake(lambda x, name: torch.empty_like(x))
_named.register_autograd(lambda ctx, grad: (grad, None))
NAMED_OP = torch.ops.repro_torch.checkpoint_name.default
_naming = [False]


@contextlib.contextmanager
def naming(on: bool):
    """Within (when ``on``): ``checkpoint_name`` passes its tensor through
    ``NAMED_OP``."""
    old, _naming[0] = _naming[0], on
    try:
        yield
    finally:
        _naming[0] = old


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x``, named ``name`` for the "names" remat policy (module
    docstring)."""
    return _named(x, name) if _naming[0] else x


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


class Block(nn.Module):
    """Pre-norm block.  Kind "attn": ln1 -> attn -> residual, ln2 -> mlp
    -> residual; "moe": the same with ``moe`` in place of ``mlp``; "rec":
    the same with the RG-LRU ``mixer`` in place of ``attn``.  With
    ``cross``, ln_cross -> cross -> residual after the mixer.  Kind "ssm":
    ln1 -> mixer (Mamba-2) -> residual; it also holds an ``ln2`` that it
    never uses, because the JAX package's ``init_block`` creates one for
    every kind and the weight carrier (``convert.params_from_jax``) loads
    every leaf of the JAX tree."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype,
                 gen: torch.Generator, cross: bool = False):
        super().__init__()
        self.ln1 = layers.init_norm(cfg.d_model, cfg.norm, dtype, gen.device)
        self.ln2 = layers.init_norm(cfg.d_model, cfg.norm, dtype, gen.device)
        if kind == "ssm":
            self.mixer = ssm.init_mamba(cfg, dtype, gen)
            return
        if kind == "rec":
            self.mixer = rglru.init_rglru_block(cfg, dtype, gen)
        else:
            self.attn = attention.init_attention(cfg, dtype, gen)
        if cross:
            self.cross = attention.init_attention(cfg, dtype, gen,
                                                  cross=True)
            self.ln_cross = layers.init_norm(cfg.d_model, cfg.norm, dtype,
                                             gen.device)
        if kind == "moe":
            self.moe = moe.init_moe(cfg, dtype, gen)
        else:
            self.mlp = mlp.init_mlp(cfg, dtype, gen)


def init_block(cfg: ModelConfig, kind: str, dtype, gen: torch.Generator,
               cross: bool = False) -> Block:
    return Block(cfg, kind, dtype, gen, cross)


def feed_forward(params: Block, x, cfg: ModelConfig, kind: str):
    """ln2 -> MLP or MoE -> residual.  Returns (x, aux_loss or None)."""
    h = layers.apply_norm(x, params.ln2, cfg.norm)
    if kind == "moe":
        y, aux = moe.moe_forward(params.moe, h, cfg)
        return x + checkpoint_name(y, "mlp_out"), aux
    return x + checkpoint_name(mlp.mlp_forward(params.mlp, h, cfg),
                               "mlp_out"), None


def cross_residual(params: Block, x, cfg: ModelConfig, cross_kv: dict):
    """ln_cross -> cross-attention over the layer's projected encoder K/V
    (``cross_kv``: {"k", "v"} (B, F, KV, D)) -> residual."""
    h = layers.apply_norm(x, params.ln_cross, cfg.norm)
    return x + attention.cross_forward(params.cross, h, cfg, cross_kv)


def block_forward(params: Block, x, cfg: ModelConfig, kind: str, *,
                  causal: bool = True, window: Optional[int] = None,
                  enc_out: Optional[torch.Tensor] = None):
    """Full-sequence block; with ``enc_out``, cross-attention over it after
    the mixer.  Returns (x, aux_loss): the MoE load-balance loss for kind
    "moe", else 0."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    h = layers.apply_norm(x, params.ln1, cfg.norm)
    if kind == "ssm":
        return x + checkpoint_name(ssm.mamba_forward(params.mixer, h, cfg),
                                   "mixer_out"), zero
    if kind == "rec":
        y = rglru.rglru_block_forward(params.mixer, h, cfg)
    else:
        y = attention.attention_forward(params.attn, h, cfg, causal=causal,
                                        window=window)
    x = x + checkpoint_name(y, "mixer_out")
    if enc_out is not None:
        k, v = attention.project_kv(params.cross, enc_out, cfg, rope=False)
        x = cross_residual(params, x, cfg, {"k": k, "v": v})
    x, aux = feed_forward(params, x, cfg, kind)
    return x, zero if aux is None else aux


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, device, window: Optional[int] = None) -> dict:
    if kind == "ssm":
        return ssm.init_mamba_cache(cfg, batch, dtype, device)
    if kind == "rec":
        return rglru.init_rglru_cache(cfg, batch, dtype, device)
    cache_len = min(max_len, window) if window else max_len
    return attention.init_kv_cache(cfg, batch, cache_len, dtype, device)


def block_decode(params: Block, x1, cache, pos, cfg: ModelConfig,
                 kind: str, *, window: Optional[int] = None,
                 cross_kv: Optional[dict] = None):
    """One-token block step (the cache is updated in place); with
    ``cross_kv`` (the layer's {"k", "v"} (B, F, KV, D)), cross-attention
    over it after the mixer.  Returns (x1, cache)."""
    h = layers.apply_norm(x1, params.ln1, cfg.norm)
    if kind == "ssm":
        y, cache = ssm.mamba_decode(params.mixer, h, cache, cfg)
        return x1 + y, cache
    if kind == "rec":
        y, cache = rglru.rglru_block_decode(params.mixer, h, cache, cfg)
    else:
        y, cache = attention.attention_decode(params.attn, h, cache, pos,
                                              cfg, window=window)
    x1 = x1 + y
    if cross_kv is not None:
        h = layers.apply_norm(x1, params.ln_cross, cfg.norm)
        y, _ = attention.attention_decode(params.cross, h, None, pos, cfg,
                                          cross_kv=cross_kv)
        x1 = x1 + y
    x1, _ = feed_forward(params, x1, cfg, kind)
    return x1, cache
