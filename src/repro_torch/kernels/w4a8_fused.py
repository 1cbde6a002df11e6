"""Fused W4A8 GEMM: int8 tensor-core dots with INT4 weights unpacked on chip.

Port of ``repro/kernels/w4a8_fused.py``:

  1. activations are quantized per token to INT8 outside the kernel
     (``quantize_activations_int8``, plain PyTorch, as in the JAX package);
  2. the kernel (``csrc/w4a8_gemm.cu``) unpacks INT4 nibbles to INT8 in
     shared memory, takes exact int32 dots per scale group on the int8
     tensor cores, subtracts ``z·Σx_q`` for asymmetric formats and
     multiplies by the group scale into fp32, writing (S, M, N) partials;
  3. the partials are summed, multiplied by the per-token scale and cast
     (the JAX package's ``finalize``).

On a CPU tensor :func:`w4a8_fused` runs :func:`w4a8_fused_plain`, the same
arithmetic in plain PyTorch. Both match ``w4a8_matmul_ref`` up to the fp32
order of summation over groups: the group sums themselves are exact.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import (QuantizedTensor, quantize_activations_int8,
                                    w4a8_group_sums)
from repro_torch.kernels import build
from repro_torch.kernels.common import check_operands

W4A8_GEMM = build.CudaKernel(
    "w4a8_gemm", "w4a8_gemm.cu", "w4a8_gemm",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def _check(x: torch.Tensor, qt: QuantizedTensor, split_k: int) -> None:
    if x.dim() != 2 or x.shape[1] != qt.K:
        raise ValueError(f"x {tuple(x.shape)} vs weight {qt.shape}")
    if qt.format.packing != "int4_pairs_k":
        raise ValueError(f"w4a8_fused needs int4_pairs_k packing, got format "
                         f"{qt.format.name!r} ({qt.format.packing})")
    K, g = qt.K, qt.group_size
    if split_k < 1 or K % split_k or (K // split_k) % g:
        raise ValueError(f"split_k={split_k} must keep K slices "
                         f"group-aligned (K={K}, group_size={g})")


def _finish(y: torch.Tensor, xs: torch.Tensor, out_dtype) -> torch.Tensor:
    """Σ over K slices, × the per-token scale, cast (``finalize``)."""
    y = y[0] if y.shape[0] == 1 else torch.sum(y, dim=0)
    return (y * xs).to(out_dtype)


def w4a8_fused_plain(x: torch.Tensor, qt: QuantizedTensor, *,
                     split_k: int = 1, out_dtype=None) -> torch.Tensor:
    """The plain PyTorch version of the wrapper's function (x: (M, K))."""
    _check(x, qt, split_k)
    xq, xs = quantize_activations_int8(x)
    terms = w4a8_group_sums(xq, qt)                     # (M, G, N)
    M, G, N = terms.shape
    parts = terms.reshape(M, split_k, G // split_k, N).sum(dim=2)
    return _finish(parts.transpose(0, 1), xs, out_dtype or x.dtype)


def w4a8_fused(x: torch.Tensor, qt: QuantizedTensor, *, split_k: int = 1,
               out_dtype=None) -> torch.Tensor:
    """C = (s_x · x_q) · Dequant(W) with integer sums; x: (M, K) float."""
    out_dtype = out_dtype or x.dtype
    _check(x, qt, split_k)
    if x.device.type == "cpu":
        return w4a8_fused_plain(x, qt, split_k=split_k, out_dtype=out_dtype)
    M, K = x.shape
    N, g = qt.N, qt.group_size
    xq, xs = quantize_activations_int8(x)
    check_operands(x.device, xq=xq, packed=qt.packed, scales=qt.scales,
                   zeros=qt.zeros)
    if qt.packed.dtype != torch.int8 or qt.packed.shape != (K // 2, N) \
            or qt.scales.dtype != torch.float32 \
            or qt.scales.shape != (K // g, N) \
            or (qt.zeros is not None and qt.zeros.dtype != torch.float32):
        raise ValueError("the W4A8 kernel takes (K/2, N) int8 packed bytes "
                         "and (K/group, N) fp32 scales and zeros")
    if g % 32 or N % 16 or M < 1:
        raise ValueError(f"the W4A8 kernel needs group % 32 == 0, "
                         f"N % 16 == 0 and M >= 1, got group {g}, N={N}, "
                         f"M={M}")
    out = torch.empty((split_k, M, N), dtype=torch.float32, device=x.device)
    W4A8_GEMM.launch(build.ptr(xq), build.ptr(qt.packed),
                     build.ptr(qt.scales), build.ptr(qt.zeros),
                     build.ptr(out), M, N, K, g, split_k,
                     build.stream_ptr(x.device))
    return _finish(out, xs, out_dtype)
