"""Learning-rate schedules: port of `repro.optim.schedules`.

Pure functions of the integer step (an int or a 0-d integer tensor),
evaluated in float32 as the reference evaluates them on its int32 step;
each returns a 0-d float32 tensor on the step's device.
"""
from __future__ import annotations

import math

import torch

f32 = torch.float32


def _step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step
    return torch.tensor(step, dtype=torch.int32)


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def f(step):
        t = torch.clamp(_step(step).to(f32) / max(total_steps, 1), 0, 1)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return base_lr * (min_frac + (1 - min_frac) * cos)
    return f


def linear_warmup_cosine(base_lr: float, warmup_steps: int,
                         total_steps: int, min_frac: float = 0.1):
    """Linear from 0 over `warmup_steps`, then cosine to min_frac: the
    step a train step passes is the one before its increment, so the
    first step's rate is 0 under warmup, as in the reference."""
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1),
                          min_frac)

    def f(step):
        step = _step(step)
        warm = base_lr * step.to(f32) / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm,
                           cos(step - warmup_steps))
    return f
