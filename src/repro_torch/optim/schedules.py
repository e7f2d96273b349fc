"""Learning-rate schedules (pure functions of the step).

The port of ``repro.optim.schedules``: ``step`` is a Python int or an
integer tensor; the result is a 0-d fp32 tensor.
"""

from __future__ import annotations

import math

import torch


def linear_warmup(step, warmup_steps: int, peak: float) -> torch.Tensor:
    step = torch.as_tensor(step)
    return peak * torch.clamp((step + 1) / max(warmup_steps, 1), max=1.0)


def cosine_schedule(step, warmup_steps: int, total_steps: int, peak: float,
                    floor: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step)
    warm = linear_warmup(step, warmup_steps, peak)
    t = torch.clamp((step - warmup_steps)
                    / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm, cos)


__all__ = ["linear_warmup", "cosine_schedule"]
