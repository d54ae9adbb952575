"""AdamW with fp32 moments whatever the parameter dtype.

Counterpart of ``repro.optim.adamw``, with JAX's arithmetic (not
``torch.optim.AdamW``'s): ``gnorm`` is the global fp32 norm of all
gradients, reported before the clip ``min(1, grad_clip / (gnorm +
1e-9))``; the bias corrections come from ``step + 1`` in fp32; weight
decay applies to every leaf; the update is computed in fp32 and cast to
the parameter's dtype once.

The parameters are an ``nn.Module`` (the port's ``LM``) or a dict of
tensors, keyed as ``named_parameters`` names them; the state is
{"m": {name: fp32}, "v": {name: fp32}, "step": 0-d int32}.  Where JAX
returns new trees, ``adamw_update`` writes the parameters and the moments
in place under ``torch.no_grad()`` (at qwen3-14b's width a second copy of
the fp32 moments would not fit beside the first).  A parameter whose
gradient is None (autograd never reached it, as mamba2's unused ``ln2``)
takes a zero gradient, as JAX's ``grad`` gives it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch
from torch import nn

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def named(params) -> Dict[str, Tensor]:
    """{name: tensor} of a module's parameters, or the dict itself."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params) -> dict:
    p = named(params)
    return {
        "m": {k: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
              for k, t in p.items()},
        "v": {k: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
              for k, t in p.items()},
        "step": torch.zeros((), dtype=torch.int32,
                            device=next(iter(p.values())).device),
    }


def global_norm(grads: Mapping[str, Optional[Tensor]]) -> Tensor:
    """sqrt of the sum over leaves of each fp32 sum of squares."""
    sq = [torch.sum(torch.square(g.to(torch.float32)))
          for g in grads.values() if g is not None]
    return torch.sqrt(sum(sq[1:], sq[0]))


# the largest piece of a leaf that one pass of ``_update`` takes: its fp32
# temporaries stay at a few times 256 MB however large the leaf
PIECE = 1 << 26


def _pieces(p, g, m, v):
    """(p, g, m, v) of a leaf in pieces of at most about PIECE entries:
    views of consecutive rows (dim 0), each updated by the same
    elementwise arithmetic as the whole."""
    if p.dim() == 0 or p.numel() <= PIECE:
        return [(p, g, m, v)]
    rows = max(1, PIECE * p.shape[0] // p.numel())
    return [(p[i:i + rows], None if g is None else g[i:i + rows],
             m[i:i + rows], v[i:i + rows])
            for i in range(0, p.shape[0], rows)]


def _update(p, g, m, v, cfg: AdamWConfig, clip, bc1, bc2, lr) -> None:
    """JAX's AdamW arithmetic on one piece, in place."""
    g32 = (torch.zeros_like(m) if g is None
           else g.to(torch.float32) * clip)
    m.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
    v.mul_(cfg.b2).add_((g32 * (1 - cfg.b2)) * g32)
    del g32
    delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
    p32 = p.to(torch.float32)
    delta.add_(cfg.weight_decay * p32)
    p.copy_(p32 - lr * delta)


@torch.no_grad()
def adamw_update(params, grads: Mapping[str, Optional[Tensor]], state: dict,
                 cfg: AdamWConfig, lr_scale=1.0, norm=global_norm):
    """One AdamW step on every parameter; returns (params, state, gnorm)
    with ``params`` and ``state["m"]``, ``state["v"]`` updated in place
    and a new ``state["step"]``.  ``norm(grads)`` gives the global norm
    (a sharded step passes one that sums each block once across ranks,
    ``launch.train.make_jitted_train_step``)."""
    p_all = named(params)
    gnorm = norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state["step"] + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=t.device)
    for name, p in p_all.items():
        g = grads.get(name)
        m, v = state["m"][name], state["v"][name]
        for piece in _pieces(p, g, m, v):
            _update(*piece, cfg, clip, bc1, bc2, lr)
    return params, {"m": state["m"], "v": state["v"], "step": step}, gnorm
