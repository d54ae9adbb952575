"""Feed-forward blocks: SwiGLU (llama-family) and GeLU (classic).

Counterpart of ``repro.models.mlp``; the weights keep the JAX package's
names and (in, out) layout.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, gen: torch.Generator):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        if cfg.mlp_act == "swiglu":
            self.w_gate = layers.dense_init(gen, (d, f), dtype)
            self.w_up = layers.dense_init(gen, (d, f), dtype)
            self.w_down = layers.dense_init(gen, (f, d), dtype)
        else:
            self.w_in = layers.dense_init(gen, (d, f), dtype)
            self.w_out = layers.dense_init(gen, (f, d), dtype)


def init_mlp(cfg: ModelConfig, dtype, gen: torch.Generator) -> MLP:
    return MLP(cfg, dtype, gen)


def mlp_forward(params: MLP, x, cfg: ModelConfig):
    if cfg.mlp_act == "swiglu":
        g = x @ params.w_gate
        u = x @ params.w_up
        return (layers.silu(g) * u) @ params.w_down
    h = layers.gelu(x @ params.w_in)
    return h @ params.w_out
