"""Synthetic data pipeline and the assigned input shapes.

Counterpart of ``repro.data.synthetic``.  ``input_specs(cfg, shape)``
returns tensors on the ``meta`` device (shapes and dtypes, no
allocation), where JAX returns ShapeDtypeStructs; ``sample_batch``,
``sample_decode_state`` and ``token_stream`` make the same
``np.random.default_rng`` draws in the same order as JAX's, so their
arrays equal JAX's bit for bit, and put them on an explicit device (the
card unless ``device="cpu"``).  The modality frontends are stubs, as in
JAX: audio and vision inputs are precomputed frame or patch embeddings.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator

import numpy as np
import torch

from repro_torch.core.admm import resolve_device
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def _shape(shape: str | InputShape) -> InputShape:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _text_len(cfg: ModelConfig, seq: int) -> int:
    if cfg.frontend == "vision":
        return seq - cfg.frontend_len
    return seq


def _enc_len(cfg: ModelConfig, seq: int) -> int:
    # audio encoder frames: a quarter of the decoder length, capped at the
    # stub frontend length
    return min(cfg.frontend_len, max(seq // 4, 16))


def _ints(a: np.ndarray, device) -> torch.Tensor:
    """int32, as JAX's ``jnp.asarray(..., jnp.int32)``."""
    return torch.from_numpy(np.asarray(a).astype(np.int32)).to(device)


def _floats(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """float64 draws in ``dtype``, through float32 as JAX converts them
    (its 64-bit types are off)."""
    return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                      dtype=dtype)


def input_specs(cfg: ModelConfig, shape: str | InputShape,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Stand-ins on the ``meta`` device for every model input of a step."""
    sh = _shape(shape)
    B, S = sh.global_batch, sh.seq_len

    def f(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")
    if sh.kind in ("train", "prefill"):
        st = _text_len(cfg, S)
        batch = {"tokens": f((B, st), torch.int32),
                 "labels": f((B, st), torch.int32)}
        if cfg.frontend == "vision":
            batch["media"] = f((B, cfg.frontend_len, cfg.d_model), dtype)
        if cfg.is_encoder_decoder:
            batch["enc_media"] = f((B, _enc_len(cfg, S), cfg.d_model), dtype)
        return batch
    # decode: one token and a position
    return {"token": f((B,), torch.int32), "pos": f((), torch.int32)}


def sample_batch(cfg: ModelConfig, shape: str | InputShape, seed: int = 0,
                 device="cuda") -> Dict[str, torch.Tensor]:
    """A concrete random batch matching ``input_specs``, on ``device``."""
    device = resolve_device(None, device)
    sh = _shape(shape)
    rng = np.random.default_rng(seed)
    B, S = sh.global_batch, sh.seq_len
    st = _text_len(cfg, S)
    V = cfg.vocab_size
    batch = {"tokens": _ints(rng.integers(0, V, (B, st)), device),
             "labels": _ints(rng.integers(0, V, (B, st)), device)}
    dt = getattr(torch, cfg.param_dtype)
    if cfg.frontend == "vision":
        batch["media"] = _floats(
            rng.standard_normal((B, cfg.frontend_len, cfg.d_model)) * 0.02,
            dt, device)
    if cfg.is_encoder_decoder:
        batch["enc_media"] = _floats(
            rng.standard_normal((B, _enc_len(cfg, S), cfg.d_model)) * 0.02,
            dt, device)
    return batch


def sample_decode_state(cfg: ModelConfig, shape: str | InputShape,
                        seed: int = 0, device="cuda"):
    """(token (B,) int32, pos () int32) on ``device``."""
    device = resolve_device(None, device)
    sh = _shape(shape)
    rng = np.random.default_rng(seed)
    token = _ints(rng.integers(0, cfg.vocab_size, (sh.global_batch,)),
                  device)
    pos = torch.tensor(sh.seq_len // 2, dtype=torch.int32, device=device)
    return token, pos


def token_stream(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                 device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    """Endless synthetic LM batches with a learnable bigram structure (so
    a real model's loss visibly falls in training): {"tokens", "labels"}
    (batch, seq) int32 on ``device``."""
    device = resolve_device(None, device)
    rng = np.random.default_rng(seed)
    V = min(cfg.vocab_size, 4096)
    perm = rng.permutation(V)
    while True:
        start = rng.integers(0, V, batch)
        toks = np.empty((batch, seq + 1), np.int64)
        toks[:, 0] = start
        noise = rng.random((batch, seq)) < 0.1
        nxt = rng.integers(0, V, (batch, seq))
        for t in range(seq):
            det = perm[toks[:, t] % V]
            toks[:, t + 1] = np.where(noise[:, t], nxt[:, t], det)
        yield {"tokens": _ints(toks[:, :-1], device),
               "labels": _ints(toks[:, 1:], device)}
