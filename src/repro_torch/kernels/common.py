"""Block-size helpers shared with the JAX package's kernels (no VMEM model:
the Hopper kernels pick their own tiles), and the operand checks every CUDA
kernel wrapper makes before a launch."""
from __future__ import annotations

import torch
import torch.nn.functional as F

LANE = 128
# dynamic shared memory a block may use on an H100 (227 KB)
MAX_SMEM = 227 * 1024

# activation dtypes the float GEMM kernels take, by the code their C
# launchers expect
KERNEL_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def align128(n: int) -> int:
    """``n`` rounded up to a multiple of 128 (the kernels' shared-memory
    alignment)."""
    return (n + 127) // 128 * 128


def check_operands(device: torch.device, **tensors) -> None:
    """Each given tensor (None skipped) lies on ``device``, is contiguous
    and 16-byte aligned, as the kernels' 16-byte loads need."""
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def kernel_dtype(dtype: torch.dtype, what: str) -> int:
    """The launcher's code for ``dtype``; raises for any other dtype."""
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"the {what} kernel takes bf16/fp16/fp32 "
                         f"activations, got {dtype}")
    return KERNEL_DTYPES[dtype]


def check_split(K: int, split_k: int, multiple: int = 32) -> None:
    """K cut into ``split_k`` slices that are multiples of ``multiple``."""
    if split_k < 1 or K % split_k or (K // split_k) % multiple:
        raise ValueError(f"split_k={split_k} must leave K slices that are "
                         f"multiples of {multiple} (K={K})")


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
