"""Fused W8A16 GEMM: per-channel INT8 weights, dequantized on chip.

Port of ``repro/kernels/w8a16_fused.py``. On a CUDA tensor the wrapper
launches the hand-written Hopper kernel ``csrc/w8a16_gemm.cu``; on a CPU
tensor it runs :func:`w8a16_fused_plain`. Both dequantize as the Pallas
stage does — ``(q − z)·s`` in fp32, rounded to x's dtype before the
product — accumulate in fp32 and, with ``split_k = S``, sum S fp32 partials
in slice order before one cast: inside the kernel when one cluster holds
the S slices and the output is in x's dtype (:func:`gemm.sums_in_kernel`),
else in the wrapper (``torch.sum``). An expert stack (x (E, M, K), rows
(E, K, N)) is one launch, as for the W4A16 kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import QuantizedTensor, per_channel_scales
from repro_torch.kernels import build, ref
from repro_torch.kernels.common import (check_operands, check_split,
                                        kernel_dtype)
from repro_torch.kernels.gemm import gemm_geometry, sm_count, sums_in_kernel
from repro_torch.kernels.w4a16_fused import stack_size

W8A16_GEMM = build.CudaKernel(
    "w8a16_gemm", "w8a16_gemm.cu", "w8a16_gemm",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_longlong] * 4
    + [ctypes.c_void_p])


def _channel_operands(x: torch.Tensor, qt: QuantizedTensor):
    """(E, scales, zeros): the stack size (1 for one weight) and the
    per-channel scales and zero-points, (1, N) a weight."""
    E = stack_size(x, qt)
    if qt.format.packing != "int8_rows":
        raise ValueError(f"w8a16_fused needs int8_rows packing, got format "
                         f"{qt.format.name!r} ({qt.format.packing})")
    if x.dim() == 2:
        return E, *per_channel_scales(qt)
    parts = [per_channel_scales(qt.layer(e)) for e in range(E)]
    return E, torch.stack([s for s, _ in parts]), \
        None if qt.zeros is None else torch.stack([z for _, z in parts])


def w8a16_fused_plain(x: torch.Tensor, qt: QuantizedTensor, *,
                      split_k: int = 1, out_dtype=None) -> torch.Tensor:
    """The plain PyTorch version of the kernel's function: x (M, K), or x
    (E, M, K) against an expert stack, one expert at a time."""
    E, scales, zeros = _channel_operands(x, qt)
    if x.dim() == 3:
        return torch.stack([
            w8a16_fused_plain(x[e], qt.layer(e), split_k=split_k,
                              out_dtype=out_dtype) for e in range(E)])
    q = qt.packed.view(torch.int8).to(torch.float32)
    if zeros is not None:
        q = q - zeros.to(torch.float32)
    w = (q * scales.to(torch.float32)).to(x.dtype)
    return ref.splitk_matmul_plain(x, w, split_k, out_dtype or x.dtype)


def w8a16_fused(x: torch.Tensor, qt: QuantizedTensor, *, split_k: int = 1,
                out_dtype=None) -> torch.Tensor:
    """C = x · Dequant(W) for per-channel INT8 weights; x: (M, K) float. An
    expert stack — x (E, M, K), rows (E, K, N) — gives (E, M, N) in one
    launch."""
    out_dtype = out_dtype or x.dtype
    E, scales, zeros = _channel_operands(x, qt)
    if x.device.type == "cpu":
        return w8a16_fused_plain(x, qt, split_k=split_k, out_dtype=out_dtype)
    scales = scales.contiguous()
    zeros = None if zeros is None else zeros.contiguous()
    M, K = x.shape[-2:]
    N = qt.N
    lead = tuple(x.shape[:-2])
    check_operands(x.device, x=x, rows=qt.packed, scales=scales, zeros=zeros)
    code = kernel_dtype(x.dtype, "W8A16")
    if qt.packed.dtype != torch.int8 or qt.packed.shape != lead + (K, N):
        raise ValueError(f"the W8A16 kernel takes (K, N) int8 rows, got "
                         f"{tuple(qt.packed.shape)} {qt.packed.dtype}")
    if scales.dtype != torch.float32 or (
            zeros is not None and zeros.dtype != torch.float32):
        raise ValueError("the W8A16 kernel takes fp32 scales and zeros")
    check_split(K, split_k)
    if N % 16 or K % 8 or M < 1:
        raise ValueError(f"the W8A16 kernel needs N % 16 == 0, K % 8 == 0 "
                         f"and M >= 1, got M={M}, N={N}, K={K}")
    # the shape rule: one launch when a cluster holds the split_k slices
    # and the output is in x's dtype; else partials, summed here
    direct = sums_in_kernel(split_k, x.dtype, out_dtype)
    geo = gemm_geometry("int8", M, N, K, split_k, x.dtype, direct=direct,
                        sms=sm_count(x.device), batch=E)
    if direct:
        out = torch.empty(lead + (M, N), dtype=x.dtype, device=x.device)
    else:
        out = torch.empty((split_k,) + lead + (M, N), dtype=torch.float32,
                          device=x.device)
    strides = (0, 0, 0, 0) if E == 1 else (
        x.stride(0), qt.packed.stride(0), N, M * N)
    W8A16_GEMM.launch(build.ptr(x), build.ptr(qt.packed), build.ptr(scales),
                      build.ptr(zeros), build.ptr(out), M, N, K, split_k,
                      code, int(direct), *geo.launch_args(), E, *strides,
                      build.stream_ptr(x.device))
    if direct:
        return out
    return torch.sum(out, dim=0).to(out_dtype)
