"""Sharding rules: every parameter, batch and cache leaf of the LM stack to
a partition spec of a mesh, and the sharded model that lives by them.

Counterpart of ``repro.launch.sharding``, with its rules, leaf for leaf:
  - weights 2D-sharded "FSDP x TP": the last free dim on "model", the one
    before it on "data", each only where it divides and is at least the
    axis size; row-parallel leaves (``wo``, ``w_down``, ``out_proj``,
    ``w_out``) put their input dim on "model" and their output dim on
    "data"; vocab tables are sharded on V only; ``fsdp=False`` leaves
    "data" out; ``expert_parallel`` puts a stacked (E, d, f) expert dim on
    "model";
  - the batch dim on the data axes ("pod", "data") where it divides;
  - the decode cache's S on "model", an SSM or LRU state's feature dim on
    "model".
JAX matches substrings of its own tree paths ("embed" but not
"pos_embed", "lm_head", the leaf name after the last "/") and never
shards the leading L axis of a stacked leaf.  The port's parameters are
per layer, so each one's spec is computed from its JAX path and JAX's
shape (``convert.jax_path``: ``layers.3.attn.wq`` is "layers/attn/wq" of
shape (L, d, f)), then the L entry is dropped.  A hybrid's tail layers
are not stacked in JAX, yet the rule treats them as stacked (their path
holds "layers"): a tail layer's 2-D weight never shards its dim 0, its
1-D leaves may shard theirs.  The cache has JAX's layout in both
packages, so its paths carry over as they are.  The spec functions read
only ``mesh.shape`` and ``mesh.axis_names``: a ``mesh.AbstractMesh`` of
16 x 16 serves in one process.

The sharded model: ``init_sharded`` gives each rank its blocks of exactly
the weights ``model.init_params(cfg, seed)`` draws (each leaf drawn whole
in ``LM.__init__``'s order, its block kept, the rest freed), and
``shard_params`` makes blocks of a model's own weights.  Each sharded
leaf is a ``torch.nn.utils.parametrize`` parametrization of its block: in
the bound mesh, reading ``lm.layers[3].attn.wq`` all-gathers the whole
weight, and the gradient that flows back to the block is reduce-scattered
in fp32 over the spec's axes, summed over the mesh's other axes, and cast
once to the block's dtype.  So ``model.loss_fn`` runs unchanged on a
sharded model, ZeRO-3 style (``launch.train.make_jitted_train_step``);
under remat each layer's weights are gathered again when the backward
recomputes it.  ``gather_params`` is the inverse: every whole weight.
The serve step (``launch.serve.make_jitted_serve_step``) reads the blocks
themselves (``blocks``) and never a parametrization: ``gathers`` counts
the ``Gather`` forwards.  ``init_cache_blocks`` and ``shard_cache`` make
a rank's blocks of the decode cache under ``cache_pspecs``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.utils.parametrize as parametrize
from torch import nn

from repro_torch.launch import mesh as M
from repro_torch.launch.mesh import P
from repro_torch.models import convert, layers, model
from repro_torch.models.config import ModelConfig

# parameter path fragments whose leading axis is a stacked-layer axis
_STACK_KEYS = ("layers", "pattern_layers", "tail_layers", "enc_layers")


def _axis_size(mesh, name: str) -> int:
    return dict(mesh.shape).get(name, 1)


def _leaf_spec(path: str, shape: tuple, mesh, *, fsdp: bool = True,
               expert_parallel: bool = False) -> P:
    """JAX's rule for the leaf at ``path`` of ``shape`` (module
    docstring), step for step."""
    ms, ds = _axis_size(mesh, "model"), _axis_size(mesh, "data")
    if "embed" in path and "pos_embed" not in path:
        spec = [None] * len(shape)
        if shape[0] % ms == 0:
            spec[0] = "model"
        return P(*spec)
    if "lm_head" in path:
        spec = [None] * len(shape)
        if shape[-1] % ms == 0:
            spec[-1] = "model"
        return P(*spec)
    stacked = any(k in path for k in _STACK_KEYS)
    dims = list(shape)
    spec: list = [None] * len(dims)
    start = 1 if (stacked and len(dims) >= 2) else 0
    free = list(range(start, len(dims)))
    if not free:
        return P()
    leaf_name = path.rsplit("/", 1)[-1]
    if leaf_name in ("wo", "w_down", "out_proj", "w_out") and len(free) >= 2:
        i_in, i_out = free[-2], free[-1]
        if dims[i_in] % ms == 0 and dims[i_in] >= ms:
            spec[i_in] = "model"
        if fsdp and dims[i_out] % ds == 0 and dims[i_out] >= ds:
            spec[i_out] = "data"
        if expert_parallel and len(free) == 3 and dims[free[0]] % ms == 0:
            spec = [None] * len(dims)
            spec[free[0]] = "model"
            if fsdp and dims[i_out] % ds == 0:
                spec[i_out] = "data"
        return P(*spec)
    if expert_parallel and len(free) == 3 and ("w_gate" in path or
                                               "w_up" in path or
                                               "w_down" in path):
        e = free[0]
        if dims[e] % ms == 0 and dims[e] >= ms:
            spec[e] = "model"
            if fsdp and dims[free[-1]] % ds == 0:
                spec[free[-1]] = "data"
            return P(*spec)
    last = free[-1]
    if dims[last] % ms == 0 and dims[last] >= ms:
        spec[last] = "model"
    if fsdp and len(free) >= 2:
        prev = free[-2]
        if dims[prev] % ds == 0 and dims[prev] >= ds:
            spec[prev] = "data"
    return P(*spec)


def _shapes(params) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of a model (whole weights: an unsharded ``LM`` or
    ``model.abstract_params``) or of a {name: tensor or shape} dict."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return {name: tuple(getattr(v, "shape", v)) for name, v in params.items()}


def param_pspecs(params, mesh, *, fsdp: bool = True,
                 expert_parallel: bool = False, cfg: ModelConfig = None
                 ) -> Dict[str, P]:
    """{the port's parameter name: its spec} (module docstring).
    ``params``: an ``LM`` of whole weights (``model.abstract_params(cfg)``
    allocates nothing) or {name: tensor or shape} with ``cfg``.  fsdp=False
    gives JAX's ZeRO-1 weight layout: weights on "model" only."""
    cfg = cfg if cfg is not None else params.cfg
    out = {}
    for name, shape in _shapes(params).items():
        path, depth = convert.jax_path(name, cfg)
        full = (depth, *shape) if depth else shape
        spec = _leaf_spec(path, full, mesh, fsdp=fsdp,
                          expert_parallel=expert_parallel)
        out[name] = P(*spec[1:]) if depth else spec
    return out


def _data_entry(mesh):
    """JAX's ``P(dp)`` entry: the data axes, a lone one as its name."""
    dp = M.data_axes(mesh)
    return dp if len(dp) != 1 else dp[0]


def batch_pspecs(batch, mesh):
    """The spec of each batch leaf (a dict of arrays, tensors or shapes):
    its dim 0 on the data axes where their product divides it, else
    replicated (``P()``)."""
    dp = M.data_axes(mesh)
    total = math.prod(_axis_size(mesh, a) for a in dp)

    def one(leaf):
        shape = tuple(getattr(leaf, "shape", leaf))
        if not shape:
            return P()
        b = shape[0]
        return P(_data_entry(mesh)) if b % total == 0 and b >= total else P()

    return {key: one(leaf) for key, leaf in batch.items()}


def _tree_map(fn, tree, path=""):
    """``fn(path, leaf)`` over nested dicts and lists, the path spelt as
    JAX's ``tree_map_with_path`` keys joined by "/"."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def cache_pspecs(cache, cfg: ModelConfig, mesh):
    """Decode-state layout (the cache's own nested layout, of tensors or
    shapes): the batch dim on the data axes, the KV cache's S (and its
    int8 scales') on "model", an SSM or LRU state's feature dim on
    "model"."""
    dp = M.data_axes(mesh)
    ms = _axis_size(mesh, "model")
    dtot = math.prod(_axis_size(mesh, a) for a in dp)

    def one(pstr, leaf):
        dims = list(getattr(leaf, "shape", leaf))
        spec: list = [None] * len(dims)
        off = 1 if ("layers" in pstr or "cross_kv" in pstr) and len(dims) > 1 \
            else 0
        if len(dims) > off and dims[off] % dtot == 0 and dims[off] >= dtot:
            spec[off] = dp if len(dp) > 1 else dp[0] if dp else None
        if pstr.endswith("k") or pstr.endswith("v") or "scale" in pstr:
            sdim = off + 1
            if len(dims) > sdim and dims[sdim] % ms == 0 and dims[sdim] >= ms:
                spec[sdim] = "model"
        if "ssm" in pstr or pstr.endswith("h") or "conv" in pstr:
            fdim = len(dims) - 1 if "ssm" not in pstr else 2
            if len(dims) > fdim and dims[fdim] % ms == 0 and dims[fdim] >= ms:
                spec[fdim] = "model"
        return P(*spec)

    return _tree_map(one, cache)


def _zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a cache and its specs (the same nesting)."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int,
                   mode: str = "decode"):
    """``model.init_cache``'s layout on the meta device: every leaf's
    shape and dtype, nothing allocated (the port's ``jax.eval_shape`` of
    it)."""
    return model.init_cache(cfg, batch, max_len, mode, device="meta")


def init_cache_blocks(cfg: ModelConfig, mesh, batch: int, max_len: int,
                      mode: str = "decode", device="cuda"):
    """This rank's blocks of ``model.init_cache(cfg, batch, max_len,
    mode)`` under ``cache_pspecs``: zeros, the whole cache built on no
    rank."""
    from repro_torch.core.admm import resolve_device
    device = resolve_device(None, device)
    meta = abstract_cache(cfg, batch, max_len, mode)
    return _zip_map(lambda t, s: torch.zeros(
        block_shape(t.shape, s, mesh), dtype=t.dtype, device=device),
        meta, cache_pspecs(meta, cfg, mesh))


def shard_cache(cache, cfg: ModelConfig, mesh):
    """This rank's blocks of a whole decode cache (e.g. the one-rank
    ``prefill``'s, an encoder-decoder's ``cross_kv`` filled) under
    ``cache_pspecs``.  Called on every rank."""
    with M.bound(mesh):
        return _zip_map(lambda t, s: M.block(t, s).clone(), cache,
                        cache_pspecs(cache, cfg, mesh))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec and the mesh it splits (JAX's ``NamedSharding``)."""
    mesh: Any
    spec: P


def to_named(tree, mesh):
    """Each spec of ``tree`` (nested dicts and lists) paired with ``mesh``."""
    if isinstance(tree, P):
        return NamedSharding(mesh, tree)
    if isinstance(tree, dict):
        return {k: to_named(v, mesh) for k, v in tree.items()}
    return type(tree)(to_named(v, mesh) for v in tree)


# --------------------------------------------------------------------------
# The sharded model
# --------------------------------------------------------------------------


def spec_axes(spec: P) -> Tuple[str, ...]:
    """The mesh axes a spec names, in its order."""
    out = []
    for ax in spec:
        if ax is not None:
            out += [ax] if isinstance(ax, str) else list(ax)
    return tuple(out)


def _other_axes(mesh, spec: P) -> Tuple[str, ...]:
    """The mesh's axes of size > 1 that ``spec`` does not name: a leaf is
    replicated along them."""
    named = set(spec_axes(spec))
    return tuple(a for a in mesh.axis_names
                 if a not in named and mesh.shape[a] > 1)


# forward calls of ``Gather`` (whole weights assembled from blocks) since
# the last ``reset_gathers``: the serve step reads blocks and makes none
gathers: Dict[str, int] = {"forward": 0}


def reset_gathers() -> None:
    gathers["forward"] = 0


class _GatherFn(torch.autograd.Function):
    """Forward: the whole weight from this rank's block (all-gathers along
    each split dim).  Backward: the whole weight's gradient summed over
    every rank of the mesh, this rank's block of it kept — a
    reduce-scatter along each split dim and a sum over the other axes, in
    fp32 — cast once to the block's dtype.  Each binds the mesh itself:
    on the card autograd runs the backward, and remat's recompute, on a
    thread of its own, where the caller's ``bound`` does not reach."""

    @staticmethod
    def forward(ctx, block, spec, others, mesh):
        ctx.spec, ctx.others, ctx.mesh = spec, others, mesh
        ctx.dtype = block.dtype
        with M.bound(mesh):
            return M.assemble(block, spec)

    @staticmethod
    def backward(ctx, grad):
        with M.bound(ctx.mesh):
            # under gloo the sums run in host memory: widen there, so the
            # card holds no fp32 copy of a whole weight's gradient
            live = tuple(a for a in spec_axes(ctx.spec) + ctx.others
                         if M.axis_size(a) > 1)
            g = grad.to(M.comm_device(live) if live else grad.device)
            g = g.to(torch.float32)
            for d in reversed(range(len(ctx.spec))):
                ax = ctx.spec[d]
                if ax is not None and M.axis_size(ax) > 1:
                    g = M.collective("psum_scatter",
                                     g.movedim(d, 0).contiguous(),
                                     ax).movedim(0, d)
            if ctx.others:
                g = M.collective("psum", g, ctx.others)
        return g.to(ctx.dtype).to(grad.device), None, None, None


class Gather(nn.Module):
    """The parametrization of a sharded leaf (module docstring)."""

    def __init__(self, spec: P, mesh):
        super().__init__()
        self.spec, self.mesh = spec, mesh
        self.others = _other_axes(mesh, spec)

    def forward(self, block):
        gathers["forward"] += 1
        if not spec_axes(self.spec) and not self.others:
            return block
        return _GatherFn.apply(block, self.spec, self.others, self.mesh)


def _owner(lm: nn.Module, name: str):
    *path, leaf = name.split(".")
    mod = lm
    for part in path:
        mod = getattr(mod, part)
    return mod, leaf


def _shard(lm: model.LM, specs: Mapping[str, P], mesh) -> model.LM:
    """Each parameter of ``lm`` (holding its block already) parametrized
    by its ``Gather``; the spec of each leaf is kept in ``lm.specs``."""
    for name, spec in specs.items():
        mod, leaf = _owner(lm, name)
        parametrize.register_parametrization(mod, leaf, Gather(spec, mesh),
                                             unsafe=True)
    lm.specs, lm.mesh = dict(specs), mesh
    return lm


def init_sharded(cfg: ModelConfig, mesh, seed: int = 0, device="cuda", *,
                 fsdp: bool = True, expert_parallel: bool = False,
                 trainable: bool = True) -> model.LM:
    """This rank's blocks (under ``param_pspecs(..., fsdp,
    expert_parallel)``) of the weights ``model.init_params(cfg, seed,
    device)`` draws, as a sharded model (module docstring).  Each leaf is
    drawn whole on ``device`` in ``LM.__init__``'s order and only the
    block is kept, so the whole model never sits on one rank.  Called on
    every rank of ``mesh``'s group."""
    from repro_torch.core.admm import resolve_device
    device = resolve_device(None, device)
    order, specs = _draw_order(cfg, mesh, fsdp, expert_parallel)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    drawn = iter(order)

    def keep(p):
        return nn.Parameter(M.block(p.data, specs[next(drawn)]).clone(),
                            requires_grad=False)

    with M.bound(mesh), layers.placing(keep):
        lm = model.LM(cfg, gen)
    lm = _shard(lm, specs, mesh)
    return model.trainable_(lm) if trainable else lm


def _draw_order(cfg: ModelConfig, mesh, fsdp: bool, expert_parallel: bool):
    """(the parameter names in ``LM.__init__``'s order of draws, {name:
    spec})."""
    made = []
    with layers.placing(lambda t: made.append(t) or t):
        abstract = model.abstract_params(cfg)
    by_id = {id(p): name for name, p in abstract.named_parameters()}
    return ([by_id[id(t)] for t in made],
            param_pspecs(abstract, mesh, fsdp=fsdp,
                         expert_parallel=expert_parallel))


def abstract_sharded(cfg: ModelConfig, mesh, *, fsdp: bool = True,
                     expert_parallel: bool = False,
                     trainable: bool = True) -> model.LM:
    """``init_sharded``'s model on the meta device: each leaf an unfilled
    block of its shape under the specs, nothing drawn (a dry run's
    weights, ``launch.dryrun``).  Needs no group: ``mesh`` may be any
    mesh description."""
    order, specs = _draw_order(cfg, mesh, fsdp, expert_parallel)
    drawn = iter(order)

    def keep(p):
        shape = block_shape(p.shape, specs[next(drawn)], mesh)
        return nn.Parameter(torch.empty(shape, dtype=p.dtype, device="meta"),
                            requires_grad=False)

    with layers.placing(keep):
        lm = model.LM(cfg, layers.ShapeOnly())
    lm = _shard(lm, specs, mesh)
    return model.trainable_(lm) if trainable else lm


def shard_params(lm: model.LM, mesh, *, fsdp: bool = True,
                 expert_parallel: bool = False) -> model.LM:
    """``lm`` (whole weights, e.g. ``convert.params_from_jax``'s) made a
    sharded model in place: each parameter keeps its block under
    ``param_pspecs``.  Called on every rank."""
    specs = param_pspecs(lm, mesh, fsdp=fsdp, expert_parallel=expert_parallel)
    with M.bound(mesh), torch.no_grad():
        for name, p in lm.named_parameters():
            p.data = M.block(p.data, specs[name]).clone()
    return _shard(lm, specs, mesh)


def blocks(lm: model.LM) -> Dict[str, nn.Parameter]:
    """{the port's parameter name: this rank's block} of a sharded model
    (``parametrizations.<leaf>.original`` under the leaf's own name)."""
    out = {}
    for name, p in lm.named_parameters():
        out[name.replace("parametrizations.", "").removesuffix(".original")] \
            = p
    return out


@torch.no_grad()
def gather_params(lm: model.LM) -> Dict[str, torch.Tensor]:
    """{name: the whole weight} of a sharded model, on every rank (the
    inverse of ``init_sharded`` / ``shard_params``)."""
    with M.bound(lm.mesh):
        return {name: M.assemble(b.detach(), lm.specs[name])
                for name, b in blocks(lm).items()}


def block_shape(shape, spec: P, mesh) -> Tuple[int, ...]:
    """The shape of a block of ``shape`` under ``spec`` on ``mesh``."""
    out = list(shape)
    for d, ax in enumerate(spec):
        if ax is not None:
            names = (ax,) if isinstance(ax, str) else ax
            out[d] //= math.prod(mesh.shape[a] for a in names)
    return tuple(out)


def init_opt_state(cfg: ModelConfig, mesh, device="cuda", *,
                   expert_parallel: bool = False) -> dict:
    """AdamW's state as this rank's blocks: zero fp32 moments under the
    ``fsdp=True`` specs (JAX's ``o_specs``, whatever the weights' layout),
    ``"step"`` 0."""
    from repro_torch.core.admm import resolve_device
    device = resolve_device(None, device)
    abstract = model.abstract_params(cfg)
    specs = param_pspecs(abstract, mesh, expert_parallel=expert_parallel)
    zeros = {name: torch.zeros(block_shape(p.shape, specs[name], mesh),
                               dtype=torch.float32, device=device)
             for name, p in abstract.named_parameters()}
    return {"m": zeros, "v": {k: torch.zeros_like(t) for k, t in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}
