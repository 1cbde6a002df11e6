"""Fused W4A16 GEMM: ``C = x · Dequant(W)`` with the dequant on chip.

Port of ``repro/kernels/w4a16_fused.py``. On a CUDA tensor the wrapper
launches the hand-written Hopper kernel ``csrc/w4a16_gemm.cu`` (see the
note at the top of that file); on a CPU tensor it runs
:func:`w4a16_fused_plain`, the same function written in plain PyTorch. There
is no fallback between the two: a CUDA tensor the kernel cannot take raises.

Both compute exactly what the Pallas kernel does: the dequantized weight
tile is rounded to ``x.dtype`` before the product, products accumulate in
fp32, and ``split_k = S`` produces S fp32 partials over K slices that are
summed in fp32, in slice order, before one cast to ``out_dtype``. The
kernel takes the sum itself when one thread-block cluster holds the S
slices and the output is in x's dtype (:func:`gemm.sums_in_kernel`: S ≤ 8
in bf16/fp16), so a GEMM is one device op; otherwise it writes the (S, M,
N) partials and the wrapper sums them (``torch.sum``, as the JAX package
leaves the sum to XLA) and casts.

An MoE layer's expert stack (x (E, M, K) against packed (E, K/2, N); the
JAX package vmaps its planned execute over the experts) is one launch of
the same kernel, counted on :data:`W4A16_GEMM` and on its expert-batched
form :data:`W4A16_GEMM_EXPERTS`; the plain version runs it expert by
expert.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import QuantizedTensor
from repro_torch.kernels import build, ref
from repro_torch.kernels.common import (check_operands, check_split,
                                        kernel_dtype)
from repro_torch.kernels.gemm import gemm_geometry, sm_count, sums_in_kernel

W4A16_GEMM = build.CudaKernel(
    "w4a16_gemm", "w4a16_gemm.cu", "w4a16_gemm",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 14 + [ctypes.c_longlong] * 4
    + [ctypes.c_void_p])
# its expert-batched form: one launch for an MoE layer's expert stack
W4A16_GEMM_EXPERTS = build.KernelForm(W4A16_GEMM, "w4a16_gemm_experts")


def stack_size(x: torch.Tensor, qt: QuantizedTensor) -> int:
    """E for x (E, M, K) against an expert stack (packed (E, K/p, N)), 1
    for x (M, K) against one weight; raises when the two do not chain."""
    if x.dim() == 2 and qt.packed.dim() == 2 and x.shape[1] == qt.K:
        return 1
    if x.dim() == 3 and qt.packed.dim() == 3 \
            and x.shape[0] == qt.packed.shape[0] and x.shape[2] == qt.K:
        return int(x.shape[0])
    raise ValueError(f"x {tuple(x.shape)} does not chain with packed "
                     f"{tuple(qt.packed.shape)} (x (M, K) with one weight, "
                     f"or x (E, M, K) with an (E, K/p, N) expert stack)")


def w4a16_fused_plain(x: torch.Tensor, qt: QuantizedTensor, *,
                      split_k: int = 1, out_dtype=None) -> torch.Tensor:
    """The plain PyTorch version of the kernel's function: x (M, K), or x
    (E, M, K) against an expert stack, one expert at a time."""
    stack_size(x, qt)
    if x.dim() == 3:
        return torch.stack([
            w4a16_fused_plain(x[e], qt.layer(e), split_k=split_k,
                              out_dtype=out_dtype)
            for e in range(x.shape[0])])
    w = ref.dequant_ref(qt.packed, qt.scales, qt.zeros, qt.group_size,
                        out_dtype=x.dtype)
    return ref.splitk_matmul_plain(x, w, split_k, out_dtype or x.dtype)


def _check_kernel_operands(x: torch.Tensor, qt: QuantizedTensor,
                           split_k: int) -> None:
    M, K = x.shape[-2:]
    lead = tuple(x.shape[:-2])
    check_operands(x.device, x=x, packed=qt.packed, scales=qt.scales,
                   zeros=qt.zeros)
    kernel_dtype(x.dtype, "W4A16")
    if qt.packed.dtype != torch.int8 or qt.format.packing != "int4_pairs_k":
        raise ValueError("the W4A16 kernel takes int4 pairs packed in int8")
    if qt.scales.dtype != torch.float32 or (
            qt.zeros is not None and qt.zeros.dtype != torch.float32):
        raise ValueError("the W4A16 kernel takes fp32 scales and zeros")
    N = qt.N
    if qt.packed.shape != lead + (K // 2, N) or K != qt.K:
        raise ValueError(f"x {tuple(x.shape)} does not match packed "
                         f"{tuple(qt.packed.shape)}")
    if qt.group_size % 2 or K % qt.group_size:
        raise ValueError(f"group_size {qt.group_size} must be even and "
                         f"divide K={K}")
    if qt.scales.shape != lead + (K // qt.group_size, N) or (
            qt.zeros is not None and qt.zeros.shape != qt.scales.shape):
        raise ValueError(f"scales {tuple(qt.scales.shape)} do not match "
                         f"K={K}, N={N}, group {qt.group_size}")
    check_split(K, split_k)
    if N % 16 or K % 8:
        raise ValueError(f"the W4A16 kernel needs N % 16 == 0 and "
                         f"K % 8 == 0, got N={N}, K={K}")
    if M < 1:
        raise ValueError("x has no rows")


def w4a16_fused(x: torch.Tensor, qt: QuantizedTensor, *, split_k: int = 1,
                out_dtype=None) -> torch.Tensor:
    """C = x · Dequant(W); x: (M, K) float, W packed (K//2, N). An expert
    stack — x (E, M, K), packed (E, K//2, N) — gives (E, M, N) in one
    launch (partials (split_k, E, M, N), summed in slice order here)."""
    out_dtype = out_dtype or x.dtype
    E = stack_size(x, qt)
    if x.device.type == "cpu":
        return w4a16_fused_plain(x, qt, split_k=split_k, out_dtype=out_dtype)
    _check_kernel_operands(x, qt, split_k)
    M, K = x.shape[-2:]
    N = qt.N
    lead = tuple(x.shape[:-2])
    # the shape rule: one launch when a cluster holds the split_k slices
    # and the output is in x's dtype; else partials, summed here
    direct = sums_in_kernel(split_k, x.dtype, out_dtype)
    geo = gemm_geometry("int4", M, N, K, split_k, x.dtype, direct=direct,
                        group=qt.group_size, has_zeros=qt.zeros is not None,
                        sms=sm_count(x.device), batch=E)
    if direct:
        out = torch.empty(lead + (M, N), dtype=x.dtype, device=x.device)
    else:
        out = torch.empty((split_k,) + lead + (M, N), dtype=torch.float32,
                          device=x.device)
    strides = (0, 0, 0, 0) if E == 1 else (
        x.stride(0), qt.packed.stride(0), qt.scales.stride(0), M * N)
    (W4A16_GEMM if E == 1 else W4A16_GEMM_EXPERTS).launch(
        build.ptr(x), build.ptr(qt.packed), build.ptr(qt.scales),
        build.ptr(qt.zeros), build.ptr(out), M, N, K, qt.group_size,
        split_k, kernel_dtype(x.dtype, "W4A16"), int(direct),
        *geo.launch_args(), E, *strides, build.stream_ptr(x.device))
    if direct:
        return out
    return torch.sum(out, dim=0).to(out_dtype)
