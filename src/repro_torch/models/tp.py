"""Tensor-parallel one-token decode over the "model" axis of a mesh, on the
blocks of a sharded model: the compute of the sharded serve step
(``launch.serve.make_jitted_serve_step``).

JAX's serve step places the weights on "model" alone (``param_pspecs(...,
fsdp=False)``) and the decode cache by ``cache_pspecs`` (S on "model",
the SSM and LRU states' feature dim on "model"), and GSPMD derives the
collectives.  The port has no GSPMD, so each block's decode is written
out here against the same placements, beside the one-card functions of
``models/{attention,mlp,moe,ssm,rglru,blocks,model}.py``, which stay as
they are.  Called inside ``launch.mesh.bound(mesh)``:

  - the residual stream (B, 1, d) is whole on every rank of "model";
  - ``linear``: a weight with its output dim on "model" is
    column-parallel (each rank its columns), one with its input dim on
    "model" row-parallel (each rank its rows; the partial products summed
    by one psum, in fp32), one on neither runs whole;
  - vocab tables split on V: each rank embeds the tokens in its range (a
    psum of one nonzero term) and the head's logits are all-gathered, so
    every rank returns whole logits; learned positions (d on "model")
    gather the rows of ``pos``, never the table;
  - attention: q, k and v are gathered whole, in one all-gather, before
    qk-norm and RoPE (a column block may end inside a head); the new k, v row is written only
    by the rank whose S-block holds pos mod Smax (JAX's select-write,
    restricted to the rows written), each rank attends its slots for
    every head, and a pmax and a psum combine the partial softmaxes
    exactly (a fully masked block weighs zero); wo is row-parallel.  The
    same combine serves the int8 cache (its scales S-split too) and a
    decoder's cross K/V, whose F axis is on "model";
  - MLP: gate and up column-parallel, down row-parallel; MoE: the fp32
    router whole, every chosen expert's f-slice on each rank (the stacked
    expert tensors split on f), the combined partial outputs psummed;
  - Mamba-2: ``in_proj``'s output is gathered (its blocks cut across z,
    x, B, C and dt), the depthwise conv runs on the cache's channel block
    and its output is gathered, each rank steps its heads of the SSM
    state, the gated RMSNorm sums its squares over "model", ``out_proj``
    is row-parallel on d_inner;
  - RG-LRU: the input projections column-parallel on w, the conv
    channel-local, the gates' (w, w) weights column-parallel over the
    gathered conv output, h kept w-split, ``w_out`` row-parallel.

A weight a rule leaves whole on "model", or one split on its output dim
where JAX's rule makes the layer's second matmul column-parallel (a
hybrid's tail layers), goes through the same ``linear``: the activations
are gathered or sliced to the layout the weight needs.  No weight is
gathered inside a step: ``prepare`` reads a sharded model's blocks once
(``sharding.blocks``), never through its ``Gather`` parametrizations, and
all-gathers the few small leaves the compute needs whole there (norm
gains, 1-D biases, the SSM's per-head constants, the depthwise conv
kernels, the MoE router).  At a model axis of 1 every function does the
one-card function's arithmetic, bit for bit.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Dict, Optional

import torch

from repro_torch.launch import mesh as M
from repro_torch.models import attention, layers, model, moe, rglru, ssm
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor
AX = "model"
# leaves of two or more dims that the compute reads whole (small): the
# depthwise conv kernels (W, channels) and the MoE router (d, E)
WHOLE = ("conv_w", "router")


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A weight as this rank holds it: its block, and the dim split on
    "model" (None where it is whole on this rank)."""
    block: Tensor
    dim: Optional[int]


def model_size() -> int:
    """The size of the bound mesh's "model" axis (1 without one)."""
    return M._mesh().shape.get(AX, 1)


def local(t: Tensor, dim: int = -1) -> Tensor:
    """This rank's block of a whole tensor along ``dim`` (a view)."""
    n = model_size()
    if n == 1:
        return t
    k = t.shape[dim] // n
    return t.narrow(dim, M.axis_index(AX) * k, k)


def gather(t: Tensor, dim: int = -1) -> Tensor:
    """The whole tensor from this rank's block along ``dim``."""
    if model_size() == 1:
        return t
    return M.collective("all_gather", t.movedim(dim, 0).contiguous(),
                        AX).movedim(0, dim)


def whole(t: Tensor, split: bool) -> Tensor:
    return gather(t) if split else t


def relayout(t: Tensor, split: bool, want: bool) -> Tensor:
    """t, split on its last dim or whole (``split``), as ``want`` has it."""
    if split == want:
        return t
    return gather(t) if split else local(t)


def psum(t: Tensor, wide: bool = True) -> Tensor:
    """The sum over "model" (in fp32 where ``wide``, cast back)."""
    if model_size() == 1:
        return t
    if not wide or t.dtype == torch.float32:
        return M.collective("psum", t, AX)
    return M.collective("psum", t.to(torch.float32), AX).to(t.dtype)


def linear(x: Tensor, split: bool, w: Leaf):
    """(x @ W, whether the product is split on its last dim) for x whole
    or split on its last dim (``split``) and W's block: row-parallel
    (its input dim on "model": this rank's slice of x, then a psum),
    column-parallel (its output dim on "model": x whole) or whole."""
    if w.dim is not None and w.dim == w.block.ndim - 2:
        return psum((x if split else local(x)) @ w.block), False
    return whole(x, split) @ w.block, w.dim == w.block.ndim - 1


def _namespace(tree):
    """Nested dicts to attribute access; a dict of "0", "1", ... a list."""
    if not isinstance(tree, dict):
        return tree
    if tree and all(k.isdigit() for k in tree):
        return [_namespace(tree[str(i)]) for i in range(len(tree))]
    return types.SimpleNamespace(**{k: _namespace(v) for k, v in tree.items()})


def prepare(blocks: Dict[str, Tensor], specs, mesh):
    """The leaves of a sharded model (``sharding.blocks``, under
    ``specs``) for the functions here, nested as the model's modules
    (``.layers[i].attn.wq``): a ``Leaf`` for each weight of two or more
    dims, the whole tensor for the small leaves (module docstring), which
    are all-gathered here.  Returns (the leaves, the bytes gathered).
    Every spec must place its leaf on "model" alone (``fsdp=False``)."""
    tree: dict = {}
    gathered = 0
    with M.bound(mesh), torch.no_grad():
        n = model_size()
        for name, b in blocks.items():
            spec = specs[name]
            if any(ax not in (None, AX) and M.axis_size(ax) > 1
                   for ax in spec):
                raise ValueError(f"{name}: spec {spec} splits it over "
                                 "another axis than \"model\" (the serve "
                                 "step reads fsdp=False blocks)")
            *path, leaf = name.split(".")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            b = b.detach()
            if b.ndim <= 1 or leaf in WHOLE:
                t = M.assemble(b, spec)
                gathered += t.numel() * t.element_size() if t is not b else 0
                node[leaf] = t
            else:
                dim = next((d for d, ax in enumerate(spec) if ax == AX),
                           None) if n > 1 else None
                node[leaf] = Leaf(b, dim)
    return _namespace(tree), gathered


# --------------------------------------------------------------------------
# Embedding and head
# --------------------------------------------------------------------------


def embed(w, tokens: Tensor, pos, cfg: ModelConfig) -> Tensor:
    """``model._embed_tokens`` of one token a row: tokens (B,), pos a
    scalar or (B,) -> (B, 1, d), whole."""
    tokens = tokens[:, None]
    table = w.embed
    if table.dim is None:
        x = table.block[tokens]
    else:
        rows = table.block.shape[0]
        here = tokens - M.axis_index(AX) * rows
        hit = (here >= 0) & (here < rows)
        x = psum(torch.where(hit[..., None],
                             table.block[here.clamp(0, rows - 1)], 0.0),
                 wide=False)
    if cfg.pos_embedding == "learned":
        pos = torch.as_tensor(pos, device=x.device).reshape(-1, 1).long()
        pe = w.pos_embed
        x = x + whole(pe.block[pos % model.MAX_LEARNED_POS], pe.dim == 1)
    return x


def head(w, x: Tensor, cfg: ModelConfig) -> Tensor:
    """Logits (B, 1, V) of the final-normed x, whole on every rank."""
    table = w.embed if cfg.tie_embeddings else w.lm_head
    W = table.block.T if cfg.tie_embeddings else table.block
    return whole(x @ W, table.dim is not None)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------


def wholes(parts):
    """Each (t, split) of ``parts`` whole: the split ones gathered in one
    all-gather of their blocks side by side."""
    split = [t for t, s in parts if s]
    if len(split) < 2:
        return [whole(t, s) for t, s in parts]
    g = M.collective("all_gather", torch.cat(split, dim=-1)[None], AX)
    done = iter(p.movedim(0, -2).flatten(-2) for p in torch.split(
        g, [t.shape[-1] for t in split], dim=-1))
    return [next(done) if s else t for t, s in parts]


def _project(w, x, cfg: ModelConfig, which: str, positions=None):
    """q, k and v (B, 1, heads, D) whole, for ``which`` a string of them:
    the projections and biases on this rank's columns, one gather of them
    all, then ``attention._project``'s qk-norm and RoPE of q and k where
    ``positions`` (a column block may end inside a head)."""
    parts = []
    for name in which:
        t, split = linear(x, False, getattr(w, f"w{name}"))
        if cfg.attn_bias:
            b = getattr(w, f"b{name}")
            t = t + (local(b) if split else b)
        parts.append((t, split))
    out = []
    for name, t in zip(which, wholes(parts)):
        heads = cfg.num_heads if name == "q" else cfg.num_kv_heads
        t = t.reshape(x.shape[0], -1, heads, cfg.head_dim)
        if name != "v" and cfg.qk_norm:
            t = layers.rmsnorm(t, getattr(w, f"{name}_norm"))
        if name != "v" and positions is not None \
                and cfg.pos_embedding == "rope":
            t = layers.apply_rope(t, positions, fraction=cfg.rope_fraction,
                                  theta=cfg.rope_theta)
        out.append(t)
    return out


def combine(q, k, v, mask: Optional[Tensor]) -> Tensor:
    """One-token attention over the slots of every rank of "model", each
    rank holding a block of them (k, v (B, S_block, KV, D), ``mask``
    (B, S_block)): the block's fp32 logits against the max over the
    ranks (pmax), then one psum of the unnormalised output and the sum
    of weights — exact, a fully masked block weighing zero.  Returns
    fp32 (B, 1, H * D)."""
    B, _, H, D = q.shape
    logits = attention.decode_logits(q, k, mask)          # (B, KV, g, 1, S)
    top = M.collective("pmax", torch.amax(logits, dim=-1, keepdim=True), AX)
    p = torch.exp(logits - top)
    out = torch.einsum("bkgqs,bskd->bkgqd", p, v.to(torch.float32))
    both = M.collective("psum", torch.cat(
        [out, torch.sum(p, dim=-1, keepdim=True)], dim=-1), AX)
    out = both[..., :D] / both[..., D:]
    return out.permute(0, 3, 1, 2, 4).reshape(B, 1, H * D)


def _write(buf: Tensor, new: Tensor, at: Tensor, mine: Tensor) -> None:
    """JAX's select-write of each row's new entry (B, ...) at its slot,
    restricted to the rows' slots: a rank whose block does not hold a
    row's slot (``mine`` False) writes that slot's own value back."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    shape = (-1,) + (1,) * (new.ndim - 1)
    buf[rows, at] = torch.where(mine.reshape(shape), new.to(buf.dtype),
                                buf[rows, at])


def attention_decode(w, x1, cache: dict, pos, cfg: ModelConfig, *,
                     window: Optional[int] = None,
                     cross_kv: Optional[dict] = None,
                     seq_split: bool = False):
    """``attention.attention_decode`` on this rank's blocks: ``cache``
    holds its S-block of every slot's k and v (``seq_split``: S is on
    "model"), ``cross_kv`` its F-block of the encoder K/V.  Updates the
    cache in place; returns (out (B, 1, d) whole, cache)."""
    B = x1.shape[0]
    if cross_kv is not None:
        q, = _project(w, x1, cfg, "q")
        k, v = cross_kv["k"], cross_kv["v"]
        if seq_split:
            out = combine(q, k, v, None).to(x1.dtype)
        else:
            F = k.shape[1]
            out = attention._attend(
                q, k, v, torch.full((1,), F, device=x1.device),
                torch.arange(F, device=x1.device), causal=False,
                window=None).reshape(B, 1, -1)
        return _out(w, out), cache
    pos_b = torch.as_tensor(pos, device=x1.device).reshape(-1).long()
    pos_b = pos_b.expand(B)
    q, k1, v1 = _project(w, x1, cfg, "qkv", pos_b[:, None])
    S = cache["k"].shape[1]
    lo = M.axis_index(AX) * S if seq_split else 0
    Smax = S * model_size() if seq_split else S
    here = pos_b % Smax - lo
    mine, at = (here >= 0) & (here < S), here.clamp(0, S - 1)
    if cfg.kv_cache_dtype == "int8":
        for name, new in (("k", k1), ("v", v1)):
            vals, scale = attention._quantize_kv(new)
            _write(cache[name], vals[:, 0], at, mine)
            _write(cache[f"{name}_scale"], scale[:, 0], at, mine)
        k = cache["k"].to(torch.float32) * cache["k_scale"]
        v = cache["v"].to(torch.float32) * cache["v_scale"]
    else:
        _write(cache["k"], k1[:, 0], at, mine)
        _write(cache["v"], v1[:, 0], at, mine)
        k, v = cache["k"], cache["v"]
    mask = attention.slot_mask(pos_b, lo + torch.arange(S, device=x1.device),
                               Smax, window)
    out = (combine(q, k, v, mask) if seq_split
           else attention.decode_attend(q, k, v, mask)).to(x1.dtype)
    return _out(w, out), cache


def _out(w, out: Tensor) -> Tensor:
    """wo over the whole attention output (B, 1, H * D)."""
    y, split = linear(out, False, w.wo)
    return whole(y, split)


# --------------------------------------------------------------------------
# MLP and MoE
# --------------------------------------------------------------------------


def mlp(w, x: Tensor, cfg: ModelConfig) -> Tensor:
    """``mlp.mlp_forward`` on the blocks: (B, 1, d) whole."""
    if cfg.mlp_act == "swiglu":
        g, split = linear(x, False, w.w_gate)
        u, _ = linear(x, False, w.w_up)
        y, out_split = linear(layers.silu(g) * u, split, w.w_down)
    else:
        h, split = linear(x, False, w.w_in)
        y, out_split = linear(layers.gelu(h), split, w.w_out)
    return whole(y, out_split)


def moe_block(w, x: Tensor, cfg: ModelConfig) -> Tensor:
    """``moe.moe_forward`` (either route) with the router whole and each
    expert's f-block: the partial outputs summed over "model"."""
    gate, down = w.w_gate, w.w_down
    if gate.dim not in (None, 2) or down.dim not in (None, 1):
        raise NotImplementedError(
            "the serve step splits the expert tensors on f (fsdp=False "
            "without expert_parallel)")
    y, _ = moe.moe_forward(types.SimpleNamespace(
        router=w.router, w_gate=gate.block, w_up=w.w_up.block,
        w_down=down.block), x, cfg)
    return psum(y) if down.dim is not None else y


# --------------------------------------------------------------------------
# Mamba-2 and RG-LRU
# --------------------------------------------------------------------------


def mamba_decode(w, u1: Tensor, cache: dict, cfg: ModelConfig,
                 split: Dict[str, bool]):
    """``ssm.mamba_decode`` on the blocks: ``cache["conv"]`` holds this
    rank's channel block where ``split["conv"]``, ``cache["ssm"]`` its
    heads where ``split["ssm"]``.  Returns (out (B, 1, d) whole, cache)."""
    Bsz = u1.shape[0]
    di, n, nh, hd = (cfg.ssm_dinner, cfg.ssm_state, cfg.ssm_nheads,
                     cfg.ssm_headdim)
    f32 = torch.float32
    zx, zx_split = linear(u1, False, w.in_proj)
    z, xbc, dt = ssm._split_proj(whole(zx, zx_split), cfg)
    conv_w, conv_b = w.conv_w, w.conv_b
    if split["conv"]:
        xbc, conv_w, conv_b = local(xbc), local(conv_w), local(conv_b)
    hist = torch.cat([cache["conv"], xbc], dim=1)
    conv_out = ((hist.to(f32) * conv_w.to(f32)).sum(1) + conv_b.to(f32))
    xbc1 = whole(layers.silu(conv_out)[:, None, :].to(u1.dtype),
                 split["conv"])
    x = xbc1[..., :di].reshape(Bsz, nh, hd).to(f32)
    Bmat = xbc1[:, 0, di:di + n].to(f32)
    Cmat = xbc1[:, 0, di + n:di + 2 * n].to(f32)
    dtv = ssm.softplus(dt[:, 0].to(f32) + w.dt_bias)          # (B, nh)
    A, D = -torch.exp(w.A_log), w.D
    if split["ssm"]:
        x, dtv, A, D = local(x, 1), local(dtv, 1), local(A, 0), local(D, 0)
    da = torch.exp(A[None] * dtv)
    state = (cache["ssm"] * da[..., None, None]
             + (dtv[..., None] * x)[..., None] * Bmat[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", state, Cmat)
    y = y + D[None, :, None] * x
    y = y.reshape(Bsz, 1, -1).to(u1.dtype)
    cache["conv"].copy_(hist[:, 1:])
    cache["ssm"].copy_(state)
    return _gate_norm_out(w, y, z, cfg, split["ssm"]), cache


def _gate_norm_out(w, y: Tensor, z: Tensor, cfg: ModelConfig,
                   split: bool) -> Tensor:
    """``ssm._gate_norm_out`` for y whole or its d_inner block
    (``split``): the block's sum of squares summed over "model"."""
    if not split:
        y = layers.rmsnorm(y * layers.silu(z.to(torch.float32)).to(y.dtype),
                           w.norm_scale)
        out, out_split = linear(y, False, w.out_proj)
        return whole(out, out_split)
    xf = (y * layers.silu(local(z).to(torch.float32)).to(y.dtype)).to(
        torch.float32)
    var = psum(torch.sum(torch.square(xf), dim=-1, keepdim=True)) \
        / cfg.ssm_dinner
    g = xf * torch.rsqrt(var + 1e-6)
    g = (g * (1.0 + local(w.norm_scale).to(torch.float32))).to(y.dtype)
    out, out_split = linear(g, True, w.out_proj)
    return whole(out, out_split)


def _columns(leaf: Leaf, split: bool) -> Tensor:
    """A (w, w) gate weight's columns of this rank's channels (all where
    the channels are whole)."""
    if leaf.dim == 1 and split:
        return leaf.block
    if leaf.dim is None:
        return local(leaf.block, 1) if split else leaf.block
    raise ValueError(f"a gate weight split on dim {leaf.dim} does not match "
                     "the cache's channels")


def rglru_decode(w, x1: Tensor, cache: dict, cfg: ModelConfig,
                 split: Dict[str, bool]):
    """``rglru.rglru_block_decode`` on the blocks: ``cache["conv"]`` and
    ``cache["h"]`` hold this rank's channel block where ``split["h"]``.
    Returns (out (B, 1, d) whole, cache)."""
    f32 = torch.float32
    sp = split["h"]
    if split["conv"] != sp:
        raise ValueError("the LRU's conv and h caches split differently")
    rec, rec_split = linear(x1, False, w.w_rec_in)
    gate, gate_split = linear(x1, False, w.w_gate_in)
    rec = relayout(rec, rec_split, sp)
    gate = layers.gelu(relayout(gate, gate_split, sp))
    conv_w, conv_b = w.conv_w, w.conv_b
    if sp:
        conv_w, conv_b = local(conv_w), local(conv_b)
    hist = torch.cat([cache["conv"], rec], dim=1)
    conv = ((hist.to(f32) * conv_w.to(f32)).sum(1) + conv_b.to(f32))
    xin = conv[:, None, :].to(x1.dtype)
    gates = types.SimpleNamespace(
        wa=_columns(w.wa, sp), wx=_columns(w.wx, sp),
        **{k: local(getattr(w, k)) if sp else getattr(w, k)
           for k in ("ba", "bx", "lam")})
    log_a, b = rglru._gates(gates, whole(xin, sp), cols=xin if sp else None)
    h = torch.exp(log_a[:, 0]) * cache["h"] + b[:, 0]
    out, out_split = linear(gate * h[:, None, :].to(x1.dtype), sp, w.w_out)
    cache["conv"].copy_(hist[:, 1:])
    cache["h"].copy_(h)
    return whole(out, out_split), cache


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------


def block_decode(w, x1: Tensor, cache: dict, pos, cfg: ModelConfig,
                 kind: str, split: Dict[str, bool], *,
                 window: Optional[int] = None,
                 cross_kv: Optional[dict] = None):
    """``blocks.block_decode`` on the blocks of layer ``w``: ``split``
    says which of its cache leaves (and "cross") hold a block of their
    split dim.  Returns (x1, cache)."""
    h = layers.apply_norm(x1, w.ln1, cfg.norm)
    if kind == "ssm":
        y, cache = mamba_decode(w.mixer, h, cache, cfg, split)
        return x1 + y, cache
    if kind == "rec":
        y, cache = rglru_decode(w.mixer, h, cache, cfg, split)
    else:
        y, cache = attention_decode(w.attn, h, cache, pos, cfg,
                                    window=window, seq_split=split["k"])
    x1 = x1 + y
    if cross_kv is not None:
        h = layers.apply_norm(x1, w.ln_cross, cfg.norm)
        y, _ = attention_decode(w.cross, h, None, pos, cfg,
                                cross_kv=cross_kv, seq_split=split["cross"])
        x1 = x1 + y
    h = layers.apply_norm(x1, w.ln2, cfg.norm)
    y = moe_block(w.moe, h, cfg) if kind == "moe" else mlp(w.mlp, h, cfg)
    return x1 + y, cache
