"""Training driver: the train step and (run as a script) training on
synthetic data.

Counterpart of ``repro.launch.train``.  ``make_train_step`` returns the
eager step: ``model.loss_fn``, its gradient by autograd (on the card the
attention's through the ``flash_attention_backward`` kernel and mamba2's
SSD scan through the ``ssd_scan_backward`` kernel, so every family trains
there; each layer recomputed under ``torch.utils.checkpoint``), then
``adamw_update`` in place at ``cosine_schedule(step, total_steps,
warmup=20)``, as JAX's.
``make_jitted_train_step`` places the step on a device mesh and waits
for the LM half of the meshes (ROADMAP Queue 1 item 13.5).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.admm import resolve_device
from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    total_steps: int = 1000, mode: str = "train"):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "gnorm"}); ``params`` (a trainable ``LM``) and the moments
    are updated in place."""
    def train_step(params, opt_state, batch):
        params.zero_grad(set_to_none=True)
        loss = model.loss_fn(params, batch, cfg, mode=mode)
        loss.backward()
        grads = {name: p.grad for name, p in params.named_parameters()}
        lr_scale = cosine_schedule(opt_state["step"], total_steps, warmup=20)
        params, opt_state, gnorm = adamw_update(params, grads, opt_state,
                                                opt_cfg, lr_scale)
        params.zero_grad(set_to_none=True)
        return params, opt_state, {"loss": loss.detach(), "gnorm": gnorm}

    return train_step


def make_jitted_train_step(*args, **kwargs):
    raise NotImplementedError(
        "make_jitted_train_step shards the step over a device mesh; the "
        "port's LM meshes wait for ROADMAP Queue 1 item 13.5 (the step "
        "runs eagerly on one device: make_train_step)")


def train_loop(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
               lr: float = 3e-4, log_every: int = 10, seed: int = 0,
               device="cuda"):
    """End-to-end training on synthetic bigram data (``token_stream``),
    printing JAX's lines; on the card unless ``device="cpu"``.  Returns
    (params, losses)."""
    from repro_torch.data.synthetic import token_stream

    device = resolve_device(None, device)
    opt_cfg = AdamWConfig(lr=lr)
    params = model.init_params(cfg, seed=seed, device=device, trainable=True)
    opt_state = adamw_init(params)
    step_fn = make_train_step(cfg, opt_cfg, total_steps=steps)
    stream = token_stream(cfg, batch, seq, seed=seed, device=device)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"model={cfg.name} params={n_params/1e6:.1f}M "
          f"batch={batch} seq={seq}")
    t0 = time.time()
    losses = []
    for i in range(steps):
        params, opt_state, m = step_fn(params, opt_state, next(stream))
        losses.append(float(m["loss"]))
        if i % log_every == 0 or i == steps - 1:
            dt = time.time() - t0
            print(f"step {i:4d} loss={losses[-1]:.4f} "
                  f"gnorm={float(m['gnorm']):.3f} ({dt:.1f}s)")
    return params, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import repro_torch.configs as configs
    cfg = configs.get_reduced(args.arch)
    train_loop(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
               lr=args.lr, device=args.device)


if __name__ == "__main__":
    main()
