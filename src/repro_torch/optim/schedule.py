"""Learning-rate schedules.  Counterpart of ``repro.optim.schedule``: the
same float32 arithmetic on a step that may be a Python int or a 0-d
tensor (the optimizer state's int32 step); returns a 0-d float32
tensor."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step)


def linear_warmup(step, warmup: int) -> torch.Tensor:
    s = _step(step)
    return torch.clamp((s + 1) / max(warmup, 1), max=1.0).to(torch.float32)


def cosine_schedule(step, total: int, warmup: int = 0,
                    floor: float = 0.1) -> torch.Tensor:
    s = _step(step)
    w = linear_warmup(s, warmup)
    frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0,
                       1.0).to(torch.float32)
    cos = floor + (1 - floor) * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return w * cos
