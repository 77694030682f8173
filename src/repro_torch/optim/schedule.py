"""Learning-rate schedules (the port of `repro.optim.schedule`)."""

from __future__ import annotations

import math

import torch

F32 = torch.float32


def warmup_cosine(step, *, warmup: int = 100, total: int = 10_000,
                  floor: float = 0.1):
    """Multiplier in [floor, 1]: linear warmup then cosine decay. `step`
    is a number or a tensor (the optimizer's step count on the device, so
    the schedule reads nothing back to the host); returns an f32
    tensor on its device."""
    step = torch.as_tensor(step).to(F32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return warm * cos
