"""Device resolution for the port's entry points.

Entry points (the serving engine, the serve launcher) run on the card by
default. A missing CUDA runtime is an error, never a silent move to the CPU:
only a caller that asks for ``device="cpu"`` gets the plain CPU path.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; raises if CUDA is requested but unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; the port runs on the "
            "GPU by default — pass device='cpu' to run its plain PyTorch "
            "path on the CPU")
    return dev


def dtype_name(dtype: Optional[torch.dtype]) -> str:
    """``torch.bfloat16`` → ``"bfloat16"`` (the JAX package's dtype names,
    which plan-cache keys and problem descriptors use)."""
    return str(dtype).replace("torch.", "")
