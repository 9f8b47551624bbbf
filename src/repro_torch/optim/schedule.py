"""LR schedules (counterpart of ``repro.optim.schedule``): cosine with
linear warmup.

The step arrives as a 0-d tensor and the scale is computed in fp32, in the
JAX package's order of operations, so the lr has the reference's bits."""

from __future__ import annotations

import math

import torch


def cosine_with_warmup(warmup_steps: int, total_steps: int,
                       min_ratio: float = 0.1):
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = step / max(warmup_steps, 1)
        t = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        t = torch.clamp(t, 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, cos)
    return fn


__all__ = ["cosine_with_warmup"]
