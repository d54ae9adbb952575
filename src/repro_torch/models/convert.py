"""Carrier of weights and caches between the JAX package and the port.

The two packages draw their random weights from different generators, so
the tests that hold one against the other initialise the JAX model,
convert its parameter pytree to numpy, and load it here; then both
compute the same function.  Nothing here imports JAX: the trees are
nested dicts whose leaves ``numpy.asarray`` can read (numpy arrays, or
JAX arrays handed over as they are).

- ``params_from_jax(tree, cfg, device)``: the ``repro.models.model.
  init_params`` pytree -> the port's ``LM``, with ``tree["layers"]``
  (stacked on a leading L axis) unstacked into ``LM.layers``; a hybrid's
  ``tree["pattern_layers"]`` (one stack per pattern position, n_rep deep)
  and ``tree["tail_layers"]`` interleaved into forward order:
  ``pattern_layers[j][g]`` is layer g·len(pattern) + j, tail layer t is
  layer n_rep·len(pattern) + t.  An encoder-decoder's ``tree["enc_layers"]``
  is unstacked into ``LM.enc_layers`` the same way; its ``pos_embed``,
  ``enc_norm`` and each decoder layer's ``cross`` and ``ln_cross`` carry
  over by name.
  The mamba2 tree carries over as it is: its fp32 ``A_log``, ``D`` and
  ``dt_bias`` stay fp32 in a bf16 model (the port's ``ssm.Mamba`` holds
  them so, and the dtype check below holds it to that), and the SSM
  block's unused ``ln2`` has its counterpart in ``blocks.Block``.
- ``params_to_jax(lm, cfg)``: the inverse, JAX's stacked layout as numpy
  (``flat_to_jax`` stacks any {name: leaf} dict so, tensors included);
  ``opt_state_from_jax`` / ``opt_state_to_jax``: an AdamW state {"m",
  "v", "step"} whose moments have the parameter layout.  The checkpoints
  (``repro_torch.checkpoint``) and the gradient parity tests use them.
- ``cache_from_jax(tree, device)`` / ``cache_to_numpy(cache)``: the
  decode cache, whose layout both packages share (``{"layers": ...}`` or
  ``{"pattern_layers": [...], "tail_layers": [...]}``, and an
  encoder-decoder's ``{"cross_kv": {"k", "v"}}``, see
  ``repro_torch.models.model``).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.core.admm import resolve_device
from repro_torch.models import blocks
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


def to_tensor(a, device) -> Tensor:
    """A numpy-readable array -> a tensor on ``device`` with the same
    dtype and bits (bfloat16 included, carried as int16); a tensor moves
    as it is."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.array(a)          # a writable copy: JAX hands read-only buffers
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def to_numpy(t: Tensor) -> np.ndarray:
    """A tensor -> numpy (bfloat16 widened exactly to float32)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for name, value in tree.items():
        key = f"{prefix}{name}"
        if isinstance(value, dict):
            out.update(_flatten(value, key + "."))
        else:
            out[key] = value
    return out


def _unstack(flat: Dict[str, Any], stack: Dict[str, Any], layer_of,
             depth: int, what: str, into: str = "layers") -> None:
    """Each leaf of a stacked layer tree (leading axis ``depth``) into
    ``flat`` as ``{into}.{layer_of(g)}.{name}``."""
    for key, value in _flatten(stack).items():
        arr = value if isinstance(value, torch.Tensor) else np.asarray(value)
        if arr.shape[0] != depth:
            raise ValueError(f"{what}.{key}: leading axis {arr.shape[0]} "
                             f"!= {depth}")
        for g in range(depth):
            flat[f"{into}.{layer_of(g)}.{key}"] = arr[g]


_STACKS = ("layers", "pattern_layers", "tail_layers", "enc_layers")


def flat_from_jax(tree: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """A tree in JAX's parameter layout -> {the port's parameter name:
    leaf}, the stacks unstacked into forward order (module docstring)."""
    flat = _flatten({k: v for k, v in tree.items() if k not in _STACKS})
    if "layers" in tree:
        _unstack(flat, tree["layers"], lambda g: g, cfg.num_layers,
                 "layers")
    if "enc_layers" in tree:
        _unstack(flat, tree["enc_layers"], lambda g: g,
                 cfg.num_encoder_layers, "enc_layers", into="enc_layers")
    if "pattern_layers" in tree:
        pat, n_rep, _ = M.hybrid_layout(cfg)
        if len(tree["pattern_layers"]) != len(pat):
            raise ValueError(f"pattern_layers: {len(tree['pattern_layers'])}"
                             f" stacks for a pattern of {len(pat)}")
        for j, stack in enumerate(tree["pattern_layers"]):
            _unstack(flat, stack, lambda g, j=j: g * len(pat) + j, n_rep,
                     f"pattern_layers.{j}")
        for t, layer in enumerate(tree["tail_layers"]):
            for key, value in _flatten(layer).items():
                flat[f"layers.{n_rep * len(pat) + t}.{key}"] = value
    return flat


def jax_path(name: str, cfg: ModelConfig):
    """(JAX's tree path of the port's parameter ``name``, as
    ``repro.launch.sharding`` spells it — keys and list indices joined by
    "/" —, the depth of the stack whose leading axis JAX's leaf adds, or
    0): the mapping ``flat_from_jax`` inverts.  ``layers.3.attn.wq`` ->
    ("layers/attn/wq", L); a hybrid's layer l -> ("pattern_layers/{l mod
    len(pattern)}/...", n_rep) or, past the pattern's repeats,
    ("tail_layers/{t}/...", 0): tail layers are not stacked."""
    head, _, tail = name.partition(".")
    if head not in ("layers", "enc_layers"):
        return name.replace(".", "/"), 0
    idx, _, key = tail.partition(".")
    key = key.replace(".", "/")
    if head == "enc_layers":
        return f"enc_layers/{key}", cfg.num_encoder_layers
    if len(set(blocks.block_kinds(cfg))) == 1:
        return f"layers/{key}", cfg.num_layers
    pat, n_rep, _ = M.hybrid_layout(cfg)
    i = int(idx)
    if i < n_rep * len(pat):
        return f"pattern_layers/{i % len(pat)}/{key}", n_rep
    return f"tail_layers/{i - n_rep * len(pat)}/{key}", 0


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device="cuda") -> M.LM:
    """The port's model holding the weights of a JAX parameter tree.

    Every parameter of the port is set from the tree and every leaf of
    the tree is used, with its shape and dtype checked; anything else
    raises.  (The module is first built by ``init_params``, whose random
    draw is then overwritten.)
    """
    device = resolve_device(None, device)
    lm = M.init_params(cfg, seed=0, device=device)
    flat = flat_from_jax(tree, cfg)
    own = dict(lm.named_parameters())
    if set(own) != set(flat):
        raise ValueError(f"parameter names differ: only in the port "
                         f"{sorted(set(own) - set(flat))}, only in the tree "
                         f"{sorted(set(flat) - set(own))}")
    for name, param in own.items():
        value = to_tensor(flat[name], device)
        if value.shape != param.shape or value.dtype != param.dtype:
            raise ValueError(f"{name}: tree {tuple(value.shape)} "
                             f"{value.dtype}, port {tuple(param.shape)} "
                             f"{param.dtype}")
        with torch.no_grad():
            param.copy_(value)
    return lm


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{"a.b.c": leaf} -> {"a": {"b": {"c": leaf}}}."""
    out: Dict[str, Any] = {}
    for key, value in flat.items():
        *path, last = key.split(".")
        node = out
        for name in path:
            node = node.setdefault(name, {})
        node[last] = value
    return out


def _stack(layers: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-layer {name: leaf} dicts -> one nested dict of stacked leaves
    (a leading axis of len(layers))."""
    return _nest({name: _stack_leaves([lay[name] for lay in layers])
                  for name in layers[0]})


def _stack_leaves(leaves):
    if isinstance(leaves[0], torch.Tensor):
        return torch.stack(leaves)
    return np.stack(leaves)


def flat_to_jax(flat: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The inverse of ``flat_from_jax``: {the port's parameter name: leaf}
    -> JAX's layout, each stack's layers stacked on a leading axis (leaves
    stay tensors or numpy arrays, as given)."""
    per_layer: Dict[str, Dict[int, Dict[str, Any]]] = {}
    rest = {}
    for name, value in flat.items():
        head, _, tail = name.partition(".")
        if head in ("layers", "enc_layers"):
            idx, _, key = tail.partition(".")
            per_layer.setdefault(head, {}).setdefault(int(idx), {})[key] = \
                value
        else:
            rest[name] = value
    tree = _nest(rest)
    if "enc_layers" in per_layer:
        enc = per_layer["enc_layers"]
        tree["enc_layers"] = _stack([enc[i] for i in sorted(enc)])
    dec = per_layer.get("layers", {})
    if len(set(blocks.block_kinds(cfg))) == 1:
        tree["layers"] = _stack([dec[i] for i in range(cfg.num_layers)])
    else:
        pat, n_rep, rem = M.hybrid_layout(cfg)
        tree["pattern_layers"] = [
            _stack([dec[g * len(pat) + j] for g in range(n_rep)])
            for j in range(len(pat))]
        tree["tail_layers"] = [_nest(dec[n_rep * len(pat) + t])
                               for t in range(rem)]
    return tree


def params_to_jax(params: M.LM, cfg: ModelConfig) -> Dict[str, Any]:
    """The inverse of ``params_from_jax``: the port's model -> JAX's
    stacked parameter layout as numpy arrays (bf16 widened exactly to
    fp32; ``checkpoint.ckpt`` keeps bf16 bits itself)."""
    return flat_to_jax({name: to_numpy(p)
                        for name, p in params.named_parameters()}, cfg)


def opt_state_from_jax(state: Dict[str, Any], cfg: ModelConfig,
                       device="cuda") -> Dict[str, Any]:
    """A JAX AdamW state {"m", "v" (trees in the parameter layout),
    "step"} -> the port's {"m": {name: fp32}, "v": {...}, "step": 0-d
    int32} (``repro_torch.optim.adamw``)."""
    device = resolve_device(None, device)
    out: Dict[str, Any] = {
        key: {name: to_tensor(a, device).to(torch.float32)
              for name, a in flat_from_jax(state[key], cfg).items()}
        for key in ("m", "v")}
    out["step"] = to_tensor(np.asarray(state["step"], np.int32), device)
    return out


def opt_state_to_jax(state: Dict[str, Any], cfg: ModelConfig
                     ) -> Dict[str, Any]:
    """The inverse of ``opt_state_from_jax``, as numpy arrays."""
    out: Dict[str, Any] = {
        key: flat_to_jax({name: to_numpy(t)
                          for name, t in state[key].items()}, cfg)
        for key in ("m", "v")}
    out["step"] = np.asarray(to_numpy(state["step"]), np.int32)
    return out


def _map_cache(cache: Dict[str, Any], fn) -> Dict[str, Any]:
    """``fn`` on every array of a decode cache, keeping its layout."""
    out: Dict[str, Any] = {}
    if "layers" in cache:
        out["layers"] = {name: fn(a) for name, a in cache["layers"].items()}
    for key in ("pattern_layers", "tail_layers"):
        if key in cache:
            out[key] = [{name: fn(a) for name, a in entry.items()}
                        for entry in cache[key]]
    if "cross_kv" in cache:
        out["cross_kv"] = {name: fn(a)
                           for name, a in cache["cross_kv"].items()}
    return out


def cache_from_jax(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """A JAX decode cache -> the port's cache (the same layout and
    dtypes)."""
    device = resolve_device(None, device)
    return _map_cache(tree, lambda a: to_tensor(a, device))


def cache_to_numpy(cache: Dict[str, Any]) -> Dict[str, Any]:
    """The port's cache -> the same layout of numpy arrays."""
    return _map_cache(cache, to_numpy)
