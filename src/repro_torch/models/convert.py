"""Carrier of weights and caches between the JAX package and the port.

The two packages draw their random weights from different generators, so
the tests that hold one against the other initialise the JAX model,
convert its parameter pytree to numpy, and load it here; then both
compute the same function.  Nothing here imports JAX: the trees are
nested dicts whose leaves ``numpy.asarray`` can read (numpy arrays, or
JAX arrays handed over as they are).

- ``params_from_jax(tree, cfg, device)``: the ``repro.models.model.
  init_params`` pytree -> the port's ``LM``, with ``tree["layers"]``
  (stacked on a leading L axis) unstacked into ``LM.layers``.
  The mamba2 tree carries over as it is: its fp32 ``A_log``, ``D`` and
  ``dt_bias`` stay fp32 in a bf16 model (the port's ``ssm.Mamba`` holds
  them so, and the dtype check below holds it to that), and the SSM
  block's unused ``ln2`` has its counterpart in ``blocks.Block``.
- ``cache_from_jax(tree, device)`` / ``cache_to_numpy(cache)``: the
  decode cache, whose layout both packages share ((L, B, S, KV, D) k and
  v; (L, B, W-1, conv_ch) conv and (L, B, H, P, N) ssm).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.admm import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


def to_tensor(a, device) -> Tensor:
    """A numpy-readable array -> a tensor on ``device`` with the same
    dtype and bits (bfloat16 included, carried as int16)."""
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
    flat = {k: v for k, v in _flatten(tree).items()
            if not k.startswith("layers.")}
    stacked = _flatten(tree["layers"]) if "layers" in tree else {}
    for key, value in stacked.items():
        arr = np.asarray(value)
        if arr.shape[0] != cfg.num_layers:
            raise ValueError(f"layers.{key}: leading axis {arr.shape[0]} "
                             f"!= num_layers {cfg.num_layers}")
        for i in range(cfg.num_layers):
            flat[f"layers.{i}.{key}"] = arr[i]
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


def cache_from_jax(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """A JAX decode cache {"layers": {"k": (L, B, S, KV, D), ...}} or
    {"layers": {"conv": ..., "ssm": ...}} -> the port's cache (the same
    layout and dtypes)."""
    device = resolve_device(None, device)
    return {"layers": {name: to_tensor(a, device)
                       for name, a in tree["layers"].items()}}


def cache_to_numpy(cache: Dict[str, Any]) -> Dict[str, Any]:
    """The port's cache -> {"layers": {name: numpy array}}."""
    return {"layers": {name: to_numpy(t)
                       for name, t in cache["layers"].items()}}
