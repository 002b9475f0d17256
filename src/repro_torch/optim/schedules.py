"""Learning-rate schedules (pure functions of the step counter).

``repro.optim.schedules`` on torch: each returns a float32 scalar tensor
for an int or tensor ``step``, on the step's device.
"""
from __future__ import annotations

import math

import torch


def _f32(v, like=None) -> torch.Tensor:
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(v, dtype=torch.float32, device=dev)


def constant(lr: float):
    return lambda step: _f32(lr, step)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup then cosine decay to final_frac*peak."""

    def fn(step):
        step = _f32(step, step)
        warm = peak_lr * torch.clamp(
            (step + 1.0) / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1),
            0.0, 1.0)
        cos = final_frac + (1.0 - final_frac) * 0.5 * (
            1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)

    return fn


def step_decay(lr: float, decay: float, every: int):
    def fn(step):
        k = torch.floor(_f32(step, step) / every)
        return _f32(lr, step) * (decay ** k)

    return fn
