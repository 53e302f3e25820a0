"""LR schedules (as step -> multiplicative scale, composable with AdamWConfig).

Each schedule takes the optimizer's step counter (an int32 tensor) and
returns an f32 tensor on its device, so a step never waits for the host.
"""

from __future__ import annotations

import math

import torch

__all__ = ["constant", "linear_warmup_cosine"]


def linear_warmup_cosine(warmup: int, total: int, final_scale: float = 0.1):
    """Linear warmup to 1.0 over ``warmup`` steps, cosine decay to final_scale."""

    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_scale + (1.0 - final_scale) * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)

    return fn


def constant():
    def fn(step: torch.Tensor) -> torch.Tensor:
        return torch.ones((), dtype=torch.float32, device=step.device)

    return fn
