"""Fused W4A8 GEMM: int8 tensor-core dots with INT4 weights unpacked on chip.

Port of ``repro/kernels/w4a8_fused.py``, which computes

  1. the activations quantized per token to INT8
     (``quantize_activations_int8``);
  2. exact int32 dots of x_q with the INT4 weights per scale group, minus
     ``z·Σx_q`` for asymmetric formats, times the group scale, summed in fp32
     (over K slices too, with Split-K);
  3. times the per-token scale, cast (the JAX package's ``finalize``).

On a CUDA tensor :func:`w4a8_fused` runs all three in the hand-written
Hopper kernels of ``csrc/w4a8_gemm.cu`` (see the note at the top of that
file): :func:`w4a8_quantize` (x_q, the row scales and Σx_q per group), then
the GEMM, launched so that its blocks start while the quantize runs. The
GEMM sums the K slices in a thread-block cluster, scales and casts, while
one cluster holds the ``split_k`` slices and the output is in x's dtype
(:func:`sums_in_kernel`): two device ops a call. Otherwise it writes fp32
partials that the wrapper sums, scales and casts. On a CPU tensor it runs
:func:`w4a8_fused_plain`, the same arithmetic in plain PyTorch; a CUDA tensor
the kernels cannot take raises. Both match ``w4a8_matmul_ref`` up to the
fp32 order of summation over groups: the group sums themselves are exact.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.quant import (QuantizedTensor, quantize_activations_int8,
                                    w4a8_group_sums)
from repro_torch.kernels import build
from repro_torch.kernels.common import check_operands, kernel_dtype
from repro_torch.kernels.gemm import MAX_CLUSTER, gemm_geometry, sm_count

W4A8_GEMM = build.CudaKernel(
    "w4a8_gemm", "w4a8_gemm.cu", "w4a8_gemm",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 14 + [ctypes.c_void_p],
    flops=lambda a: 2.0 * a[7] * a[8] * a[9],
    device=("w4a8_gemm_kernel",))
W4A8_QUANTIZE = build.CudaKernel(
    "w4a8_quantize", "w4a8_gemm.cu", "w4a8_quantize",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    device=("quantize_rows_kernel",))


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


def sums_in_kernel(split_k: int, dtype: torch.dtype,
                   out_dtype: torch.dtype) -> bool:
    """Whether the kernel writes the (M, N) output itself: the output in
    x's dtype and the ``split_k`` slices inside one cluster — the rule of
    ``gemm.sums_in_kernel``, fp32 included, since every dtype runs on the
    int8 tensor cores. A shape rule, fixed before the launch."""
    return out_dtype == dtype and split_k <= MAX_CLUSTER


def w4a8_fused_plain(x: torch.Tensor, qt: QuantizedTensor, *,
                     split_k: int = 1, out_dtype=None) -> torch.Tensor:
    """The plain PyTorch version of the wrapper's function (x: (M, K))."""
    _check(x, qt, split_k)
    xq, xs = quantize_activations_int8(x)
    terms = w4a8_group_sums(xq, qt)                     # (M, G, N)
    M, G, N = terms.shape
    parts = terms.reshape(M, split_k, G // split_k, N).sum(dim=2)
    return _finish(parts.transpose(0, 1), xs, out_dtype or x.dtype)


def w4a8_quantize(x: torch.Tensor, group: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The quantize kernel on CUDA operands: x_q (M, K) int8 and the row
    scales (M, 1) fp32, bit for bit :func:`quantize_activations_int8`, and
    Σx_q per (token, group) (M, K / group) int32."""
    M, K = x.shape
    check_operands(x.device, x=x)
    code = kernel_dtype(x.dtype, "W4A8")
    if group not in (32, 64, 128) or K % group \
            or K * x.element_size() > 64 * 1024:
        raise ValueError(f"the W4A8 quantize kernel takes group 32, 64 or "
                         f"128 dividing K and rows of at most 64 KB, got "
                         f"group {group}, K={K}, {x.dtype}")
    dev = x.device
    xq = torch.empty((M, K), dtype=torch.int8, device=dev)
    xs = torch.empty((M, 1), dtype=torch.float32, device=dev)
    tok = torch.empty((M, K // group), dtype=torch.int32, device=dev)
    W4A8_QUANTIZE.launch(build.ptr(x), build.ptr(xq), build.ptr(xs),
                         build.ptr(tok), M, K, group, code,
                         build.stream_ptr(dev))
    return xq, xs, tok


def w4a8_fused(x: torch.Tensor, qt: QuantizedTensor, *, split_k: int = 1,
               out_dtype=None) -> torch.Tensor:
    """C = (s_x · x_q) · Dequant(W) with integer sums; x: (M, K) float."""
    out_dtype = out_dtype or x.dtype
    _check(x, qt, split_k)
    if x.device.type == "cpu":
        return w4a8_fused_plain(x, qt, split_k=split_k, out_dtype=out_dtype)
    return _launch(x, qt, split_k, out_dtype)


def _launch(x: torch.Tensor, qt: QuantizedTensor, split_k: int, out_dtype,
            *, overlap: bool = True) -> torch.Tensor:
    """The two kernels on CUDA operands; ``overlap`` starts the GEMM while
    the quantize kernel runs (off only where chip_smoke.py times the two
    launches one after the other)."""
    M, K = x.shape
    N, g = qt.N, qt.group_size
    check_operands(x.device, x=x, packed=qt.packed, scales=qt.scales,
                   zeros=qt.zeros)
    code = kernel_dtype(x.dtype, "W4A8")
    if qt.packed.dtype != torch.int8 or qt.packed.shape != (K // 2, N) \
            or qt.scales.dtype != torch.float32 \
            or qt.scales.shape != (K // g, N) \
            or (qt.zeros is not None and qt.zeros.dtype != torch.float32):
        raise ValueError("the W4A8 kernel takes (K/2, N) int8 packed bytes "
                         "and (K/group, N) fp32 scales and zeros")
    direct = sums_in_kernel(split_k, x.dtype, out_dtype)
    geo = gemm_geometry("w4a8", M, N, K, split_k, x.dtype, direct=direct,
                        group=g, has_zeros=qt.zeros is not None,
                        sms=sm_count(x.device))
    xq, xs, tok = w4a8_quantize(x, g)
    if direct:
        out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    else:
        out = torch.empty((split_k, M, N), dtype=torch.float32,
                          device=x.device)
    W4A8_GEMM.launch(build.ptr(xq), build.ptr(tok), build.ptr(xs),
                     build.ptr(qt.packed), build.ptr(qt.scales),
                     build.ptr(qt.zeros), build.ptr(out), M, N, K, g,
                     split_k, code, int(direct), int(overlap),
                     *geo.launch_args(), build.stream_ptr(x.device))
    return out if direct else _finish(out, xs, out_dtype)
