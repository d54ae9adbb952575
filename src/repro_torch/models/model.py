"""Top-level language model: init, forward, decode.

Counterpart of ``repro.models.model`` for every family of the registry:
the dense ones (qwen3-14b, qwen3-32b, glm4-9b, command-r-35b), MoE
(granite-moe), the SSM family (mamba2-370m), the RG-LRU hybrid
(recurrentgemma), the VLM (internvl2-1b: a text LM that ``forward`` also
runs behind a prefix of precomputed media embeddings, (B, F, d), scoring
the text positions only) and the encoder-decoder (seamless-m4t-large-v2:
learned positions, an encoder stack over precomputed frame embeddings
``enc_media`` (B, F, d), non-causal, and cross-attention in every decoder
layer).  The modality frontends are stubs in the JAX package too: the
embeddings arrive precomputed.  The JAX package stacks the per-layer
parameters on a leading L axis and scans over them — for a hybrid, one
stack per position of the block pattern (``pattern_layers``, n_rep deep)
and the remainder layers apart (``tail_layers``).  Here the layers are one
``nn.ModuleList`` in forward order (layer l of a hybrid is pattern
position l mod len(pattern) while l < n_rep * len(pattern), then a tail
layer), and ``forward`` / ``decode_step`` loop over it, each layer
dispatching on its kind; the encoder layers are a second list,
``enc_layers``.

The decode cache keeps the JAX layout.  A stack of one kind has one
stacked tensor per name with a leading L axis: {"layers": {name: (L, B,
...)}} ((L, B, S, KV, D) for k and v; (L, B, W-1, conv_ch) for conv and
(L, B, H, P, N) fp32 for ssm).  A hybrid has {"pattern_layers": [{name:
(n_rep, B, ...)} per pattern position], "tail_layers": [{name: (B, ...)}
per tail layer]} (an RG-LRU layer holds conv (B, W-1, w) and h (B, w)
fp32).  Each layer reads and writes its own view of it in place
(``layer_cache``).  An encoder-decoder cache also holds {"cross_kv": {"k",
"v": (L, B, F, KV, D)}}, each decoder layer's projection of the encoder's
output (``build_cross_cache``), which decode only reads.

Training: ``loss_fn`` is the next-token cross entropy of ``forward`` plus
the MoE aux loss, as JAX's.  A model built with ``trainable=True`` (or
passed through ``trainable_``) has parameters that require grad; serving
keeps them frozen.  In ``mode="train"`` with grad on and a trainable
model, each layer of ``hidden`` and ``encode`` runs under
``torch.utils.checkpoint`` (non-reentrant): the backward recomputes the
layer, the counterpart of JAX's per-layer ``jax.checkpoint``.  Its
policy is ``cfg.remat_policy``: "full" saves nothing; "dots" and "names"
go through ``torch.utils.checkpoint.create_selective_checkpoint_contexts``,
whose policy sees aten ops: "dots" saves the outputs of ``aten.mm`` and
``aten.addmm`` — the 2-D products of the projections, as
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` saves dot
products without batch dims; not ``bmm``, nor the flash kernel's output —
and "names" saves the two tensors that pass through
``blocks.checkpoint_name`` as "mixer_out" and "mlp_out" (JAX's
``save_only_these_names``); everything else is recomputed.  The
gradients are "full"'s.  ``loss_terms`` gives the loss's parts (the sum
of the masked cross entropy, its count, the aux loss), from which the
sharded train step forms the global mean.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.admm import resolve_device
from repro_torch.models import attention, blocks, layers
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor
MAX_LEARNED_POS = 8192


class LM(nn.Module):
    """embed (V, d), final_norm, lm_head (d, V) unless the embeddings are
    tied, pos_embed (MAX_LEARNED_POS, d) with learned positions, and the
    decoder layers; an encoder-decoder model also has the encoder's
    ``enc_layers`` and ``enc_norm``, and cross-attention in every decoder
    layer."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        dtype = layers.torch_dtype(cfg)
        self.cfg, self.param_dtype = cfg, dtype
        V, d = cfg.padded_vocab, cfg.d_model
        self.embed = layers.dense_init(gen, (V, d), dtype)
        self.final_norm = layers.init_norm(d, cfg.norm, dtype, gen.device)
        if not cfg.tie_embeddings:
            self.lm_head = layers.dense_init(gen, (d, V), dtype)
        if cfg.pos_embedding == "learned":
            self.pos_embed = layers.dense_init(gen, (MAX_LEARNED_POS, d),
                                               dtype)
        cross = cfg.is_encoder_decoder
        self.layers = nn.ModuleList(
            blocks.init_block(cfg, kind, dtype, gen, cross=cross)
            for kind in blocks.block_kinds(cfg))
        if cross:
            self.enc_layers = nn.ModuleList(
                blocks.init_block(cfg, "attn", dtype, gen)
                for _ in range(cfg.num_encoder_layers))
            self.enc_norm = layers.init_norm(d, cfg.norm, dtype, gen.device)

    @property
    def device(self) -> torch.device:
        # a parameter, not ``embed``: in a sharded model reading ``embed``
        # gathers it (``launch.sharding``)
        return next(self.parameters()).device


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                trainable: bool = False) -> LM:
    """Random weights, N(0, 0.02^2) for every matrix (norm gains and biases
    as the JAX package sets them), drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` — on the card unless ``device="cpu"``;
    raises without a card.  The draws are not JAX's: tests that compare
    the two packages load JAX's weights (``convert.params_from_jax``).
    Frozen for serving unless ``trainable``."""
    device = resolve_device(None, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    lm = LM(cfg, gen)
    return trainable_(lm) if trainable else lm


def abstract_params(cfg: ModelConfig) -> LM:
    """The model on the meta device: every parameter's name, shape and
    dtype, nothing allocated or drawn (the port's ``jax.eval_shape`` of
    ``init_params``)."""
    return LM(cfg, layers.ShapeOnly())


def trainable_(params: LM) -> LM:
    """Every parameter of ``params`` set to require grad, in place (a
    model built for serving is frozen); returns it."""
    for p in params.parameters():
        p.requires_grad_(True)
    return params


def _tokens(tokens, device) -> Tensor:
    return torch.as_tensor(tokens, device=device).long()


def _embed_tokens(params: LM, tokens: Tensor, cfg: ModelConfig,
                  pos=None) -> Tensor:
    """Token embeddings (B, S, d), plus, where the config learns them, the
    position embeddings of 0..S-1 (or, for one token a row, of ``pos``: a
    scalar or a (B,) vector)."""
    x = params.embed[tokens]
    if cfg.pos_embedding == "learned":
        if pos is None:
            pos = torch.arange(tokens.shape[1], device=x.device)[None]
        else:
            pos = torch.as_tensor(pos, device=x.device).reshape(-1, 1).long()
        x = x + params.pos_embed[pos % MAX_LEARNED_POS]
    return x


def _head(params: LM, cfg: ModelConfig) -> Tensor:
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def _decoder_window(cfg: ModelConfig, mode: str) -> Optional[int]:
    if cfg.sliding_window is not None:
        return cfg.sliding_window
    if mode == "long":
        return cfg.long_context_window
    return None


def _on_model(a, params: LM) -> Tensor:
    """An array (numpy or tensor) on the model's device in its dtype."""
    return torch.as_tensor(a, device=params.device).to(params.param_dtype)


def _remat(params: LM, cfg: ModelConfig, mode: str) -> bool:
    """Whether ``hidden`` checkpoints its layers: ``mode="train"``, grad
    on, and a trainable model."""
    return mode == "train" and torch.is_grad_enabled() and any(
        p.requires_grad for p in params.parameters())


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_names(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op is blocks.NAMED_OP
            else CheckpointPolicy.PREFER_RECOMPUTE)


_POLICIES = {"full": None, "dots": _save_dots, "names": _save_names}


def remat_policy(cfg: ModelConfig):
    """The selective-checkpoint policy of ``cfg.remat_policy`` (an aten op
    -> save or recompute), None for "full" (module docstring)."""
    if cfg.remat_policy not in _POLICIES:
        raise ValueError(f"remat_policy={cfg.remat_policy!r}: one of "
                         f"{tuple(_POLICIES)}")
    return _POLICIES[cfg.remat_policy]


def _layer(lp, x, cfg: ModelConfig, kind: str, remat: bool, **kw):
    """One block, under ``torch.utils.checkpoint`` when ``remat``, with
    ``cfg.remat_policy``."""
    if not remat:
        return blocks.block_forward(lp, x, cfg, kind, **kw)
    policy = remat_policy(cfg)

    def run(h, enc):
        with blocks.naming(cfg.remat_policy == "names"):
            return blocks.block_forward(lp, h, cfg, kind,
                                        **{**kw, "enc_out": enc})

    extra = {} if policy is None else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, policy)}
    return checkpoint(run, x, kw.get("enc_out"), use_reentrant=False,
                      **extra)


def encode(params: LM, enc_media, cfg: ModelConfig, *,
           mode: str = "prefill") -> Tensor:
    """The encoder of an encoder-decoder model: its layers, non-causal and
    without a window, over the frame embeddings ``enc_media`` (B, F, d)
    (in the model's dtype), then ``enc_norm``; returns (B, F, d).  Each
    layer is checkpointed under ``_remat`` (``mode="train"``)."""
    x = _on_model(enc_media, params)
    remat = _remat(params, cfg, mode)
    for lp in params.enc_layers:
        x, _ = _layer(lp, x, cfg, "attn", remat, causal=False, window=None)
    return layers.apply_norm(x, params.enc_norm, cfg.norm)


def hidden(params: LM, batch: Dict[str, Any], cfg: ModelConfig, *,
           mode: str = "train"):
    """The forward pass up to the LM head: (final-normed hidden states of
    the text positions (B, S, d), aux_loss)."""
    x = _embed_tokens(params, _tokens(batch["tokens"], params.device), cfg)
    prefix = 0
    if cfg.frontend == "vision" and "media" in batch:
        media = _on_model(batch["media"], params)
        prefix = media.shape[1]
        x = torch.cat([media, x], dim=1)
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = encode(params, batch["enc_media"], cfg, mode=mode)
    window = _decoder_window(cfg, mode)
    remat = _remat(params, cfg, mode)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, lp in zip(blocks.block_kinds(cfg), params.layers):
        x, a = _layer(lp, x, cfg, kind, remat, causal=True, window=window,
                      enc_out=enc_out)
        aux = aux + a
    x = layers.apply_norm(x, params.final_norm, cfg.norm)
    return x[:, prefix:], aux


def forward(params: LM, batch: Dict[str, Any], cfg: ModelConfig, *,
            mode: str = "train"):
    """Returns (logits (B, S, V), aux_loss: the MoE load-balance loss summed
    over the layers, else 0).  batch: {"tokens": (B, S)}; for the VLM
    optionally "media" (B, F, d), put in front of the token embeddings
    (the logits are the text positions' only); for the encoder-decoder
    "enc_media" (B, F, d), the encoder's input.  ``mode``: "train" |
    "prefill" | "long" (sliding-window fallback)."""
    x, aux = hidden(params, batch, cfg, mode=mode)
    return x @ _head(params, cfg), aux


def loss_terms(params: LM, batch: Dict[str, Any], cfg: ModelConfig, *,
               mode: str = "train"):
    """(the sum of the masked next-token cross entropy, the number of
    unmasked positions, aux_loss) of ``batch``: fp32 logits, labels below
    0 masked.  The gold logit is a ``gather``: the value of JAX's
    iota-mask sum (one nonzero term) without one more fp32 (B, S, V)
    buffer; JAX avoids the gather only for the vocab-sharded layout of its
    meshes."""
    logits, aux = forward(params, batch, cfg, mode=mode)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    mask = (labels >= 0).to(torch.float32)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    return torch.sum((logz - gold) * mask), torch.sum(mask), aux


# the MoE load-balance loss's weight in the loss (JAX's default)
AUX_WEIGHT = 0.01


def loss_fn(params: LM, batch: Dict[str, Any], cfg: ModelConfig, *,
            mode: str = "train", aux_weight: float = AUX_WEIGHT) -> Tensor:
    """Next-token cross entropy (+ ``aux_weight`` x the MoE load-balance
    loss), as ``repro.models.model.loss_fn``: the mean over the unmasked
    positions (at least 1) of ``loss_terms``' sum."""
    ce_sum, count, aux = loss_terms(params, batch, cfg, mode=mode)
    return ce_sum / torch.clamp(count, min=1.0) + aux_weight * aux


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
    size.  An encoder-decoder cache also holds "cross_kv" (zeros of F =
    ``cfg.frontend_len or 128`` frames; ``build_cross_cache`` fills it)."""
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
        cache = {"layers": stacked(kinds[0], cfg.num_layers)}
    else:
        pat, n_rep, rem = hybrid_layout(cfg)
        cache = {"pattern_layers": [stacked(kind, n_rep) for kind in pat],
                 "tail_layers": [one(pat[i % len(pat)]) for i in range(rem)]}
    if cfg.is_encoder_decoder:
        shape = (cfg.num_layers, batch, cfg.frontend_len or 128,
                 cfg.num_kv_heads, cfg.head_dim)
        cache["cross_kv"] = {name: torch.zeros(shape, dtype=dtype,
                                               device=device)
                             for name in ("k", "v")}
    return cache


def cross_kv_of(params: LM, enc_out: Tensor, cfg: ModelConfig
                ) -> Dict[str, Tensor]:
    """Each decoder layer's cross K/V of the encoder's output enc_out
    (B, F, d): {"k", "v": (L, B, F, KV, D)}."""
    kv = [attention.project_kv(lp.cross, enc_out, cfg, rope=False)
          for lp in params.layers]
    return {"k": torch.stack([k for k, _ in kv]),
            "v": torch.stack([v for _, v in kv])}


def build_cross_cache(params: LM, enc_media, cfg: ModelConfig
                      ) -> Dict[str, Tensor]:
    """Run the encoder over ``enc_media`` (B, F, d) and project every
    decoder layer's cross K/V: the "cross_kv" entry of a decode cache."""
    return cross_kv_of(params, encode(params, enc_media, cfg), cfg)


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
    fixed order: 1 in a stacked entry and in cross_kv, 0 in a tail
    layer's."""
    leaves = [(t, 1) for t in cache.get("layers", {}).values()]
    for entry in cache.get("pattern_layers", []):
        leaves += [(t, 1) for t in entry.values()]
    for entry in cache.get("tail_layers", []):
        leaves += [(t, 0) for t in entry.values()]
    leaves += [(t, 1) for t in cache.get("cross_kv", {}).values()]
    return leaves


def decode_step(params: LM, cache: Dict[str, Any], token, pos,
                cfg: ModelConfig, *, mode: str = "decode"):
    """One-token serve step.  token: (B,) ids; pos: a scalar or a (B,)
    vector of positions.  With learned positions each slot adds the
    embedding of its own position; an encoder-decoder cache's "cross_kv"
    gives each decoder layer its encoder K/V.  Updates ``cache`` in place;
    returns (logits (B, V), cache)."""
    x = _embed_tokens(params, _tokens(token, params.device)[:, None], cfg,
                      pos=pos)
    window = _decoder_window(cfg, "long" if mode == "long" else "decode")
    cross = cache.get("cross_kv")
    for i, (kind, lp) in enumerate(zip(blocks.block_kinds(cfg),
                                       params.layers)):
        x, _ = blocks.block_decode(
            lp, x, layer_cache(cache, i, cfg), pos, cfg, kind, window=window,
            cross_kv=None if cross is None else {name: t[i] for name, t
                                                 in cross.items()})
    x = layers.apply_norm(x, params.final_norm, cfg.norm)
    return (x @ _head(params, cfg))[:, 0], cache
