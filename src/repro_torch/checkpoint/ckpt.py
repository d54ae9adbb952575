"""Checkpoints: a numpy ``.npz`` payload plus a JSON manifest.

Counterpart of ``repro.checkpoint.ckpt``, with the same files: an
``arrays.npz`` keyed by each leaf's path in the tree ("/"-joined dict keys
and list indices, as JAX names pytree paths) and a ``manifest.json`` with
the step and each key's shape and dtype.  Trees are nested dicts and lists
whose leaves are tensors or numpy arrays.  A bfloat16 leaf (numpy has no
such type without JAX's ml_dtypes) is stored as its 16 bits and named
"bfloat16" in the manifest, and restores bit for bit.

A model's parameters are saved in JAX's key layout (``convert.
flat_to_jax``: the stacked layers), so for fp32 trees a checkpoint
written by either package restores in the other.  ``save_train_state`` /
``restore_train_state`` hold a training run: {"params": the model in
JAX's layout, "opt": {"m", "v" in the same layout, "step"}}.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import adamw_init


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, value in items:
        out.update(_flatten(value, f"{prefix}/{key}" if prefix else str(key)))
    return out


def _unflatten(like: Any, leaf, prefix: str = "") -> Any:
    """``like``'s structure with ``leaf(key, like_leaf)`` at each leaf."""
    if isinstance(like, dict):
        return {k: _unflatten(v, leaf, f"{prefix}/{k}" if prefix else str(k))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaf, f"{prefix}/{i}" if prefix
                                     else str(i))
                          for i, v in enumerate(like))
    return leaf(prefix, like)


def _to_numpy(a) -> Tuple[np.ndarray, str]:
    """A leaf -> (the array to store, the dtype to name)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        a = t.numpy()
    a = np.asarray(a)
    return a, str(a.dtype)


def save_checkpoint(path: str | Path, tree: Any, step: int = 0) -> None:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    stored = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    np.savez(path / "arrays.npz", **{k: a for k, (a, _) in stored.items()})
    manifest = {
        "step": int(step),
        "keys": {k: {"shape": list(a.shape), "dtype": dt}
                 for k, (a, dt) in stored.items()},
    }
    (path / "manifest.json").write_text(json.dumps(manifest, indent=1))


def _torch_dtype(like):
    if isinstance(like, torch.Tensor):
        return like.dtype
    if isinstance(like, np.ndarray) and like.dtype.name != "bfloat16":
        return torch.from_numpy(np.zeros((), like.dtype)).dtype
    return None


def restore_checkpoint(path: str | Path, like: Any,
                       device="cpu") -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (nested dicts and lists of
    tensors or arrays): tensors on ``device``, each in its ``like`` leaf's
    dtype where that is a tensor or numpy dtype, else in the stored one.
    Returns (tree, step)."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    data = np.load(path / "arrays.npz")
    missing = set(_flatten(like)) - set(data.files)
    if missing:
        raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")

    def leaf(key, like_leaf):
        arr = data[key]
        if manifest["keys"][key]["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        dtype = _torch_dtype(like_leaf)
        return t.to(device=device, dtype=dtype or t.dtype)
    return _unflatten(like, leaf), int(manifest["step"])


def train_state_tree(params: M.LM, opt_state: dict,
                     cfg: ModelConfig) -> Dict[str, Any]:
    """{"params", "opt": {"m", "v", "step"}} in JAX's layout, tensors as
    leaves (bf16 parameters keep their bits)."""
    return {"params": convert.flat_to_jax(dict(params.named_parameters()),
                                          cfg),
            "opt": {"m": convert.flat_to_jax(opt_state["m"], cfg),
                    "v": convert.flat_to_jax(opt_state["v"], cfg),
                    "step": opt_state["step"]}}


def save_train_state(path: str | Path, params: M.LM, opt_state: dict,
                     cfg: ModelConfig, step: int = 0) -> None:
    """The model and its AdamW state (``train_state_tree``) at ``step``."""
    save_checkpoint(path, train_state_tree(params, opt_state, cfg), step)


def restore_train_state(path: str | Path, cfg: ModelConfig, device="cuda"):
    """A fresh trainable model and AdamW state holding a checkpoint of
    ``save_train_state`` (or of JAX's ``save_checkpoint`` of {"params",
    "opt"}); returns (params, opt_state, step)."""
    params = M.init_params(cfg, seed=0, device=device, trainable=True)
    opt_state = adamw_init(params)
    tree, step = restore_checkpoint(
        path, train_state_tree(params, opt_state, cfg), device=params.device)
    flat = convert.flat_from_jax(tree["params"], cfg)
    with torch.no_grad():
        for name, p in params.named_parameters():
            p.copy_(flat[name])
    for key in ("m", "v"):
        opt_state[key] = convert.flat_from_jax(tree["opt"][key], cfg)
    opt_state["step"] = tree["opt"]["step"].reshape(())
    return params, opt_state, step
