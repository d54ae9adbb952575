"""Top-level language model: init, forward, decode.

Counterpart of ``repro.models.model`` for the dense decoder-only families
(qwen3-14b, qwen3-32b, glm4-9b, command-r-35b) and the SSM family
(mamba2-370m).  The JAX package stacks the per-layer parameters on a
leading L axis and scans over them; here the layers are an
``nn.ModuleList`` and ``forward`` / ``decode_step`` loop over it, each
layer dispatching on its kind.  The decode cache keeps the JAX layout, one
stacked tensor per name with a leading L axis ((L, B, S, KV, D) for k and
v; (L, B, W-1, conv_ch) for conv and (L, B, H, P, N) fp32 for ssm), and
each layer reads and writes its own view of it in place.

The training surface (``loss_fn``, remat), media frontends, the
encoder-decoder stack and the MoE and RG-LRU blocks wait for later slices
of the port (ROADMAP Queue 1 item 13); ``init_params`` raises
``NotImplementedError`` for their configurations.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from repro_torch.core.admm import resolve_device
from repro_torch.models import blocks, layers
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


class LM(nn.Module):
    """embed (V, d), final_norm, lm_head (d, V) unless the embeddings are
    tied, and the decoder layers."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        blocks.check_supported(cfg)
        dtype = layers.torch_dtype(cfg)
        V, d = cfg.padded_vocab, cfg.d_model
        self.embed = layers.dense_init(gen, (V, d), dtype)
        self.final_norm = layers.init_norm(d, cfg.norm, dtype, gen.device)
        if not cfg.tie_embeddings:
            self.lm_head = layers.dense_init(gen, (d, V), dtype)
        self.layers = nn.ModuleList(
            blocks.init_block(cfg, kind, dtype, gen)
            for kind in blocks.block_kinds(cfg))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> LM:
    """Random weights, N(0, 0.02^2) for every matrix (norm gains and biases
    as the JAX package sets them), drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` — on the card unless ``device="cpu"``;
    raises without a card.  The draws are not JAX's: tests that compare
    the two packages load JAX's weights (``convert.params_from_jax``)."""
    blocks.check_supported(cfg)
    device = resolve_device(None, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return LM(cfg, gen)


def _tokens(tokens, device) -> Tensor:
    return torch.as_tensor(tokens, device=device).long()


def _embed_tokens(params: LM, tokens: Tensor, cfg: ModelConfig) -> Tensor:
    return params.embed[tokens]


def _head(params: LM, cfg: ModelConfig) -> Tensor:
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def _decoder_window(cfg: ModelConfig, mode: str) -> Optional[int]:
    if cfg.sliding_window is not None:
        return cfg.sliding_window
    if mode == "long":
        return cfg.long_context_window
    return None


def forward(params: LM, batch: Dict[str, Any], cfg: ModelConfig, *,
            mode: str = "train"):
    """Returns (logits (B, S, V), aux_loss).  batch: {"tokens": (B, S)}.
    ``mode``: "train" | "prefill" | "long" (sliding-window fallback)."""
    x = _embed_tokens(params, _tokens(batch["tokens"], params.device), cfg)
    window = _decoder_window(cfg, mode)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, lp in zip(blocks.block_kinds(cfg), params.layers):
        x, a = blocks.block_forward(lp, x, cfg, kind, causal=True,
                                    window=window)
        aux = aux + a
    x = layers.apply_norm(x, params.final_norm, cfg.norm)
    return x @ _head(params, cfg), aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               mode: str = "decode", device="cuda") -> Dict[str, Any]:
    """Decode state, zeros: {"layers": {"k": (L, B, S, KV, D), "v": ...}}
    (plus the int8 scales) for attention stacks, {"layers": {"conv":
    (L, B, W-1, conv_ch) in the model dtype, "ssm": (L, B, H, P, N) fp32}}
    for SSM stacks.  In "long" mode (or with an always-on sliding window)
    the attention caches are ring buffers of the window's size.  (Every
    family the port runs has one block kind.)"""
    blocks.check_supported(cfg)
    device = resolve_device(None, device)
    window = _decoder_window(cfg, "long" if mode == "long" else "decode")
    kind, = set(blocks.block_kinds(cfg))
    one = blocks.init_block_cache(cfg, kind, batch, max_len,
                                  layers.torch_dtype(cfg), device,
                                  window=window)
    L = cfg.num_layers
    return {"layers": {name: torch.zeros((L, *t.shape), dtype=t.dtype,
                                         device=device)
                       for name, t in one.items()}}


def decode_step(params: LM, cache: Dict[str, Any], token, pos,
                cfg: ModelConfig, *, mode: str = "decode"):
    """One-token serve step.  token: (B,) ids; pos: a scalar or a (B,)
    vector of positions.  Updates ``cache`` in place; returns
    (logits (B, V), cache)."""
    x = _embed_tokens(params, _tokens(token, params.device), cfg)[:, None]
    window = _decoder_window(cfg, "long" if mode == "long" else "decode")
    for i, (kind, lp) in enumerate(zip(blocks.block_kinds(cfg),
                                       params.layers)):
        views = {name: t[i] for name, t in cache["layers"].items()}
        x, _ = blocks.block_decode(lp, x, views, pos, cfg, kind,
                                   window=window)
    x = layers.apply_norm(x, params.final_norm, cfg.norm)
    return (x @ _head(params, cfg))[:, 0], cache
