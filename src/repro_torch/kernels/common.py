"""Block-size helpers shared with the JAX package's kernels (no VMEM model:
the Hopper kernels pick their own tiles)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

LANE = 128


def largest_divisor(dim: int, target: int, multiple_of: int = 1) -> int:
    """Largest d ≤ target with dim % d == 0 and d % multiple_of == 0."""
    target = min(target, dim)
    for d in range(target, 0, -1):
        if dim % d == 0 and d % multiple_of == 0:
            return d
    return multiple_of if dim % multiple_of == 0 else 1


def pick_block(dim: int, target: int, align: int = LANE) -> int:
    """Prefer an ``align``-aligned divisor of ``dim`` near ``target``."""
    if dim % align == 0:
        d = largest_divisor(dim, target, align)
        if d >= align:
            return d
    return largest_divisor(dim, target)


def pad_dim(x: torch.Tensor, axis: int, multiple: int) -> torch.Tensor:
    """Zero-pad ``axis`` of x up to the next multiple."""
    rem = (-x.shape[axis]) % multiple
    if rem == 0:
        return x
    pads = [0, 0] * x.dim()
    # F.pad lists (left, right) pairs from the last axis backwards
    pads[2 * (x.dim() - 1 - axis) + 1] = rem
    return F.pad(x, pads)
