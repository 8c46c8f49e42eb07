"""Learning-rate schedules, pure functions of the step counter (a 0-d
int tensor) that return a 0-d fp32 tensor on its device (counterpart of
``repro/optim/schedules.py``)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = step / max(warmup_steps, 1)
        frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        frac = torch.clamp(frac, 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(float(math.pi) * frac))
        return base_lr * torch.where(step < warmup_steps, warm, cos)
    return schedule


def constant(base_lr: float):
    return lambda step: torch.full((), base_lr, dtype=torch.float32,
                                   device=step.device)
