"""Dense GEMM ``C = x · w``: the FP16×FP16 baseline of the paper.

Port of ``repro/kernels/gemm.py``. On a CUDA tensor :func:`gemm` launches
the hand-written Hopper kernel ``csrc/dense_gemm.cu`` (see the note at the
top of that file); on a CPU tensor it runs :func:`gemm_plain`. The same
kernel, in its partials mode, is phase 2 of the decoupled W4A16 pipeline
(:func:`launch_dense` with ``direct=False``; see ``w4a16_decoupled.py``).
Products and sums are fp32, as the Pallas kernel's float contraction.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.common import (check_operands, check_split,
                                        kernel_dtype)

DENSE_GEMM = build.CudaKernel(
    "dense_gemm", "dense_gemm.cu", "dense_gemm",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def gemm_plain(x: torch.Tensor, w: torch.Tensor, *,
               out_dtype=None) -> torch.Tensor:
    """The plain PyTorch version of :func:`gemm`."""
    return ref.splitk_matmul_plain(x, w, 1, out_dtype or x.dtype)


def _check_shapes(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         f"chain")


def launch_dense(x: torch.Tensor, w: torch.Tensor, split_k: int, *,
                 direct: bool) -> torch.Tensor:
    """The kernel on CUDA operands: ``direct`` gives the (M, N) output in
    x's dtype (split_k 1); otherwise the (split_k, M, N) fp32 partials."""
    _check_shapes(x, w)
    M, K = x.shape
    N = w.shape[1]
    check_operands(x.device, x=x, w=w)
    code = kernel_dtype(x.dtype, "dense GEMM")
    if w.dtype != x.dtype:
        raise ValueError(f"the dense GEMM kernel takes w in x's dtype "
                         f"({x.dtype}), got {w.dtype}")
    check_split(K, split_k)
    if direct and split_k != 1:
        raise ValueError("the direct output needs split_k == 1")
    if N % 16 or K % 8 or M < 1:
        raise ValueError(f"the dense GEMM kernel needs N % 16 == 0, "
                         f"K % 8 == 0 and M >= 1, got M={M}, N={N}, K={K}")
    if direct:
        out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    else:
        out = torch.empty((split_k, M, N), dtype=torch.float32,
                          device=x.device)
    DENSE_GEMM.launch(build.ptr(x), build.ptr(w), build.ptr(out), M, N, K,
                      split_k, code, int(direct), build.stream_ptr(x.device))
    return out


def gemm(x: torch.Tensor, w: torch.Tensor, *,
         out_dtype=None) -> torch.Tensor:
    """``x @ w`` with fp32 accumulation; x: (M, K), w: (K, N)."""
    out_dtype = out_dtype or x.dtype
    _check_shapes(x, w)
    if x.device.type == "cpu":
        return gemm_plain(x, w, out_dtype=out_dtype)
    if out_dtype == x.dtype:
        return launch_dense(x, w, 1, direct=True)
    return launch_dense(x, w, 1, direct=False)[0].to(out_dtype)
