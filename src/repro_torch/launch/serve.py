"""Serving: batched one-token decode (serve_step) and a tiny greedy loop.

Counterpart of ``repro.launch.serve``.  ``make_jitted_serve_step`` places
the step on a device mesh with tensor-parallel decode over "model", which
waits for ROADMAP Queue 1 item 13.5, sub-step 3 (the meshes and placements
it needs are ``launch.mesh`` and ``launch.sharding``); torch runs the step
eagerly on one card.
"""
from __future__ import annotations

import torch

from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import refuse_encoder_decoder


def make_serve_step(cfg: ModelConfig, mode: str = "decode"):
    """serve_step(params, cache, token, pos) -> (next_token (B,) int32,
    logits (B, V), cache); the cache is updated in place."""
    def serve_step(params, cache, token, pos):
        logits, cache = model.decode_step(params, cache, token, pos, cfg,
                                          mode=mode)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, cache

    return serve_step


def greedy_generate(cfg: ModelConfig, params: model.LM, prompt,
                    max_new: int = 32) -> torch.Tensor:
    """Greedy generation that prefills by stepping the prompt.  prompt:
    (B, S0) token ids; returns (B, S0 + max_new) int32 on the params'
    device.  An encoder-decoder config raises NotImplementedError, as in
    ``ServeEngine``."""
    refuse_encoder_decoder(cfg, "greedy_generate")
    prompt = torch.as_tensor(prompt, device=params.device,
                             dtype=torch.int32)
    B, S0 = prompt.shape
    cache = model.init_cache(cfg, B, S0 + max_new, device=params.device)
    step = make_serve_step(cfg)
    tok = prompt[:, 0]
    out = [tok]
    for t in range(S0 + max_new - 1):
        nxt, _, cache = step(params, cache, tok, t)
        tok = prompt[:, t + 1] if t + 1 < S0 else nxt
        out.append(tok)
    return torch.stack(out, dim=1)
