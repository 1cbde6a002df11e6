"""LR schedules (port of ``repro/optim/schedule.py``): pure functions of the
step counter, computed in fp32 as the JAX package computes them."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, warmup: int = 100, total: int = 10_000,
                    floor: float = 0.1) -> torch.Tensor:
    """Linear warmup → cosine decay to ``floor`` × peak; returns the scale
    as a 0-dim fp32 tensor (0 at step 0) on the step's device: a tensor
    step's own (a compiled train step reads its step on the card and
    nothing from the host), an int's on the CPU."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp_max(step / max(warmup, 1), 1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
