"""LR schedules (pure functions of the step counter) — the port of
:mod:`repro.optim.schedules`."""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_warmup"]


def cosine_warmup(step, *, warmup: int = 100, total: int = 10_000,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warmup → cosine decay to ``floor`` of peak.  Returns the
    multiplicative scale in [0, 1], a float32 scalar on the device of
    ``step`` (the CPU for a Python int)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return torch.where(step < warmup, warm, cos)
