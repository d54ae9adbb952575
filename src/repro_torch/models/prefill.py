"""Block prefill: one full-sequence forward that also seeds the decode
cache, so that serving pays one forward for the prompt instead of
len(prompt) decode steps.

Counterpart of ``repro.models.prefill`` for every decoder-only block
kind.  Each attention layer (kinds "attn" and "moe") runs
``attention.self_attend``: the CUDA flash kernel on the card (one launch
per layer), the plain ``_attend`` on the CPU.  Each SSM layer runs
``ssm.ssd``: the CUDA ``ssd_scan`` kernel on the card (one launch per
layer), whose final state seeds the layer's decode state, and the plain
``ssd_chunked`` on the CPU.  Each RG-LRU layer (kind "rec") seeds its
conv history from the last W-1 rows of its pre-conv branch and its state
from the scan's final h.  The entries are packed into the layout of
``model.init_cache`` (a hybrid's pattern and tail stacks included).  An
encoder-decoder prompt also carries "enc_media": the encoder runs once
(one non-causal flash launch per encoder layer on the card), its output
is projected once into "cross_kv" (``model.build_cross_cache``) and each
decoder layer attends its own K/V there after its self-attention
(``attention.cross_attend``: one more launch per layer).  As in the JAX package, prefill takes no "media" prefix.

Ring placement: decode writes slot = pos mod cache_len, so after
prefilling positions [0, S) the slot s must hold the largest position
p = s (mod L), p < S — a pure gather ``p(s) = S-1 - ((S-1-s) mod L)``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import attention, blocks, layers, rglru, ssm
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


def _ring_fill(kv_seq: Tensor, cache_len: int) -> Tensor:
    """kv_seq: (B, S, KV, D) -> ring cache (B, cache_len, KV, D)."""
    S = kv_seq.shape[1]
    if S >= cache_len:
        s_idx = torch.arange(cache_len, device=kv_seq.device)
        p = (S - 1) - ((S - 1 - s_idx) % cache_len)
        return kv_seq[:, p]
    return F.pad(kv_seq, (0, 0, 0, 0, 0, cache_len - S))


def _attn_prefill(params: attention.Attention, x, cfg: ModelConfig, *,
                  window, cache_len):
    """Attention block forward that also returns the seeded ring cache."""
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)
    q, k, v = attention._project_qkv(params, x, x, cfg, rope=True,
                                     q_positions=pos, k_positions=pos)
    out = attention.self_attend(q, k, v, causal=True, window=window)
    out = out.reshape(B, S, -1) @ params.wo
    cache = {"k": _ring_fill(k.to(x.dtype), cache_len),
             "v": _ring_fill(v.to(x.dtype), cache_len)}
    return out, cache


def _last_rows(t: Tensor, n: int) -> Tensor:
    """Last n rows along axis 1, left-zero-padded if the sequence is
    shorter."""
    S = t.shape[1]
    if S >= n:
        return t[:, S - n:]
    return F.pad(t, (0, 0, n - S, 0))


def _ssm_prefill(params: ssm.Mamba, u, cfg: ModelConfig):
    """Mamba forward that also returns {"conv": the last W-1 rows of the
    pre-conv xbc, "ssm": the final SSM state (B, H, P, N) fp32}."""
    out, xbc, final = ssm.mamba_mix(params, u, cfg)
    return out, {"conv": _last_rows(xbc, cfg.conv_width - 1), "ssm": final}


def _rec_prefill(params: rglru.RGLRU, x, cfg: ModelConfig):
    """RG-LRU block forward that also returns {"conv": the last W-1 rows
    of the pre-conv branch, "h": the final state (B, w) fp32}."""
    out, rec, h_last = rglru.rglru_mix(params, x, cfg)
    return out, {"conv": _last_rows(rec, cfg.conv_width - 1), "h": h_last}


def _block_prefill(params: blocks.Block, x, cfg: ModelConfig, kind: str, *,
                   window, cache_len, cross_kv=None):
    h = layers.apply_norm(x, params.ln1, cfg.norm)
    if kind == "ssm":
        y, cache = _ssm_prefill(params.mixer, h, cfg)
        return x + y, cache
    if kind == "rec":
        y, cache = _rec_prefill(params.mixer, h, cfg)
    else:
        y, cache = _attn_prefill(params.attn, h, cfg, window=window,
                                 cache_len=cache_len)
    x = x + y
    if cross_kv is not None:
        x = blocks.cross_residual(params, x, cfg, cross_kv)
    x, _ = blocks.feed_forward(params, x, cfg, kind)
    return x, cache


def _cache_len(max_len: int, window) -> int:
    """Length of a layer's ring cache (as ``blocks.init_block_cache``)."""
    return min(max_len, window) if window else max_len


def prefill(params: M.LM, batch: Dict[str, Any], cfg: ModelConfig,
            max_len: int, mode: str = "decode"
            ) -> Tuple[Tensor, Dict[str, Any], int]:
    """Run the prompt in one forward and seed the decode cache.

    Returns (logits (B, S, V), cache, next_pos = S).  The seeded cache is
    in the model's dtype; an int8 cache has no prefill (the JAX package's
    prefill seeds no scales either) and raises.
    """
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError("prefill seeds a cache in the model's "
                                  "dtype; the int8 cache is decode-only")
    tokens = M._tokens(batch["tokens"], params.device)
    B, S = tokens.shape
    x = M._embed_tokens(params, tokens, cfg)
    window = M._decoder_window(cfg, "long" if mode == "long" else "decode")
    cache = M.init_cache(cfg, B, max_len, mode, device=x.device)
    cross = None
    if cfg.is_encoder_decoder:
        cross = M.build_cross_cache(params, batch["enc_media"], cfg)
        cache["cross_kv"] = cross
    for i, (kind, lp) in enumerate(zip(blocks.block_kinds(cfg),
                                       params.layers)):
        x, entry = _block_prefill(
            lp, x, cfg, kind, window=window,
            cache_len=_cache_len(max_len, window),
            cross_kv=None if cross is None else {name: t[i] for name, t
                                                 in cross.items()})
        views = M.layer_cache(cache, i, cfg)
        for name, t in entry.items():
            views[name].copy_(t)
    x = layers.apply_norm(x, params.final_norm, cfg.norm)
    return x @ M._head(params, cfg), cache, S
