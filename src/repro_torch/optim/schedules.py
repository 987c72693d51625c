"""Learning-rate schedules as functions of the step counter.

Ported from the JAX package's ``src/repro/optim/schedules.py``.  The step
is a Python int or a 0-d tensor; the rate is a 0-d float32 tensor, on the
step's device where the step is a tensor (so a rate read off the
optimizer's device-side counter needs no host sync), on the CPU otherwise.
"""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def linear_warmup(step, peak_lr: float, warmup_steps: int) -> torch.Tensor:
    return peak_lr * torch.clamp((_f32(step) + 1) / max(1, warmup_steps),
                                 max=1.0)


def cosine_schedule(step, peak_lr: float, warmup_steps: int,
                    total_steps: int, floor: float = 0.1) -> torch.Tensor:
    s = _f32(step)
    warm = linear_warmup(s, peak_lr, warmup_steps)
    t = torch.clamp((s - warmup_steps) / max(1, total_steps - warmup_steps),
                    0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(s < warmup_steps, warm, peak_lr * cos)
