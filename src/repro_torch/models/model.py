"""Top-level language model: init, forward, decode.

Counterpart of ``repro.models.model`` for the decoder-only families: the
dense ones (qwen3-14b, qwen3-32b, glm4-9b, command-r-35b), MoE
(granite-moe), the SSM family (mamba2-370m) and the RG-LRU hybrid
(recurrentgemma).  The JAX package stacks the per-layer parameters on a
leading L axis and scans over them — for a hybrid, one stack per position
of the block pattern (``pattern_layers``, n_rep deep) and the remainder
layers apart (``tail_layers``).  Here the layers are one
``nn.ModuleList`` in forward order (layer l of a hybrid is pattern
position l mod len(pattern) while l < n_rep * len(pattern), then a tail
layer), and ``forward`` / ``decode_step`` loop over it, each layer
dispatching on its kind.

The decode cache keeps the JAX layout.  A stack of one kind has one
stacked tensor per name with a leading L axis: {"layers": {name: (L, B,
...)}} ((L, B, S, KV, D) for k and v; (L, B, W-1, conv_ch) for conv and
(L, B, H, P, N) fp32 for ssm).  A hybrid has {"pattern_layers": [{name:
(n_rep, B, ...)} per pattern position], "tail_layers": [{name: (B, ...)}
per tail layer]} (an RG-LRU layer holds conv (B, W-1, w) and h (B, w)
fp32).  Each layer reads and writes its own view of it in place
(``layer_cache``).

The training surface (``loss_fn``, remat), the media frontends and the
encoder-decoder stack wait for later slices of the port (ROADMAP Queue 1
item 13); ``init_params`` raises ``NotImplementedError`` for their
configurations.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

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


def hidden(params: LM, batch: Dict[str, Any], cfg: ModelConfig, *,
           mode: str = "train"):
    """The forward pass up to the LM head: (final-normed hidden states
    (B, S, d), aux_loss)."""
    x = _embed_tokens(params, _tokens(batch["tokens"], params.device), cfg)
    window = _decoder_window(cfg, mode)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, lp in zip(blocks.block_kinds(cfg), params.layers):
        x, a = blocks.block_forward(lp, x, cfg, kind, causal=True,
                                    window=window)
        aux = aux + a
    return layers.apply_norm(x, params.final_norm, cfg.norm), aux


def forward(params: LM, batch: Dict[str, Any], cfg: ModelConfig, *,
            mode: str = "train"):
    """Returns (logits (B, S, V), aux_loss: the MoE load-balance loss summed
    over the layers, else 0).  batch: {"tokens": (B, S)}.  ``mode``:
    "train" | "prefill" | "long" (sliding-window fallback)."""
    x, aux = hidden(params, batch, cfg, mode=mode)
    return x @ _head(params, cfg), aux


def hybrid_layout(cfg: ModelConfig):
    """(pattern, n_rep, number of tail layers) of a mixed stack."""
    pat = cfg.block_pattern
    n_rep, rem = divmod(cfg.num_layers, len(pat))
    return pat, n_rep, rem


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               mode: str = "decode", device="cuda") -> Dict[str, Any]:
    """Decode state, zeros, in the JAX layout (module docstring): one kind
    -> {"layers": {name: (L, B, ...)}}; a hybrid -> {"pattern_layers":
    [...], "tail_layers": [...]}.  In "long" mode (or with an always-on
    sliding window) the attention caches are ring buffers of the window's
    size."""
    blocks.check_supported(cfg)
    device = resolve_device(None, device)
    window = _decoder_window(cfg, "long" if mode == "long" else "decode")
    dtype = layers.torch_dtype(cfg)

    def one(kind):
        return blocks.init_block_cache(cfg, kind, batch, max_len, dtype,
                                       device, window=window)

    def stacked(kind, n):
        return {name: torch.zeros((n, *t.shape), dtype=t.dtype,
                                  device=device)
                for name, t in one(kind).items()}

    kinds = blocks.block_kinds(cfg)
    if len(set(kinds)) == 1:
        return {"layers": stacked(kinds[0], cfg.num_layers)}
    pat, n_rep, rem = hybrid_layout(cfg)
    return {"pattern_layers": [stacked(kind, n_rep) for kind in pat],
            "tail_layers": [one(pat[i % len(pat)]) for i in range(rem)]}


def layer_cache(cache: Dict[str, Any], i: int,
                cfg: ModelConfig) -> Dict[str, Tensor]:
    """Layer i's cache entries: views into ``cache``, written in place."""
    if "layers" in cache:
        return {name: t[i] for name, t in cache["layers"].items()}
    pat, n_rep, _ = hybrid_layout(cfg)
    if i < n_rep * len(pat):
        g, j = divmod(i, len(pat))
        return {name: t[g] for name, t in cache["pattern_layers"][j].items()}
    return cache["tail_layers"][i - n_rep * len(pat)]


def cache_leaves(cache: Dict[str, Any]) -> List[Tuple[Tensor, int]]:
    """Every tensor of a decode cache with its batch (slot) axis, in a
    fixed order: 1 in a stacked entry, 0 in a tail layer's."""
    leaves = [(t, 1) for t in cache.get("layers", {}).values()]
    for entry in cache.get("pattern_layers", []):
        leaves += [(t, 1) for t in entry.values()]
    for entry in cache.get("tail_layers", []):
        leaves += [(t, 0) for t in entry.values()]
    return leaves


def decode_step(params: LM, cache: Dict[str, Any], token, pos,
                cfg: ModelConfig, *, mode: str = "decode"):
    """One-token serve step.  token: (B,) ids; pos: a scalar or a (B,)
    vector of positions.  Updates ``cache`` in place; returns
    (logits (B, V), cache)."""
    x = _embed_tokens(params, _tokens(token, params.device), cfg)[:, None]
    window = _decoder_window(cfg, "long" if mode == "long" else "decode")
    for i, (kind, lp) in enumerate(zip(blocks.block_kinds(cfg),
                                       params.layers)):
        x, _ = blocks.block_decode(lp, x, layer_cache(cache, i, cfg), pos,
                                   cfg, kind, window=window)
    x = layers.apply_norm(x, params.final_norm, cfg.norm)
    return (x @ _head(params, cfg))[:, 0], cache
