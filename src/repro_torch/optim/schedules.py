"""LR schedules, pure functions of the step counter (reference:
``repro/optim/schedules.py``).  ``step`` is an int or a tensor; the result
is an f32 tensor."""

from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(step, warmup_steps: int, peak_lr: float) -> torch.Tensor:
    s = _step(step)
    return peak_lr * torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)


def cosine_schedule(step, warmup_steps: int, total_steps: int,
                    peak_lr: float, final_frac: float = 0.1) -> torch.Tensor:
    s = _step(step)
    warm = linear_warmup(s, warmup_steps, peak_lr)
    t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                    0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(s < warmup_steps, warm, peak_lr * cos)
