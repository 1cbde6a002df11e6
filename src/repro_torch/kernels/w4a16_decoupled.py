"""The paper-faithful decoupled W4A16 pipeline (paper Alg. 1), global-memory
round trip included.

Port of ``repro/kernels/w4a16_decoupled.py``:

  phase 1 — :func:`dequant_w4`: INT4 → a (K, N) workspace in x's dtype in
            device memory (``csrc/w4a16_decoupled.cu``);
  phase 2 — :func:`splitk_gemm`: S fp32 partial products over the
            workspace, (S, M, N) even at S = 1 (``csrc/dense_gemm.cu`` in
            its partials mode: the tile loop of ``gemm_tile.cuh`` may cut
            each plan slice into a cluster of blocks that sum through
            distributed shared memory, but it writes one fp32 partial per
            plan slice, since the sum over slices is phase 3's);
  phase 3 — :func:`reduce_partials`: the sum over S in fp32, then the cast
            (``csrc/w4a16_decoupled.cu``).

:func:`w4a16_decoupled` makes the three launches, always: the workspace and
the partials travel through device memory on purpose, since that round
trip is what the paper measures against the fused kernel. Each phase has a
plain PyTorch version beside it; a wrapper runs it only for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import QuantizedTensor
from repro_torch.kernels import build, ref
from repro_torch.kernels.common import check_operands, kernel_dtype
from repro_torch.kernels.gemm import launch_dense

DEQUANT_W4 = build.CudaKernel(
    "dequant_w4", "w4a16_decoupled.cu", "dequant_w4",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
REDUCE_PARTIALS = build.CudaKernel(
    "reduce_partials", "w4a16_decoupled.cu", "reduce_partials",
    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


# ---------------------------------------------------------------------------
# phase 1: dequant
# ---------------------------------------------------------------------------

def dequant_w4_plain(qt: QuantizedTensor, *, out_dtype=None) -> torch.Tensor:
    return ref.dequant_ref(qt.packed, qt.scales, qt.zeros, qt.group_size,
                           out_dtype=out_dtype or qt.out_dtype)


def dequant_w4(qt: QuantizedTensor, *, out_dtype=None) -> torch.Tensor:
    """Phase 1: materialize Dequant(W) → (K, N) ``out_dtype`` (default the
    tensor's own) in device memory."""
    out_dtype = out_dtype or qt.out_dtype
    if qt.format.packing != "int4_pairs_k":
        raise ValueError(f"dequant_w4 needs int4_pairs_k packing, got "
                         f"format {qt.format.name!r}")
    if qt.packed.device.type == "cpu":
        return dequant_w4_plain(qt, out_dtype=out_dtype)
    K, N, g = qt.K, qt.N, qt.group_size
    check_operands(qt.packed.device, packed=qt.packed, scales=qt.scales,
                   zeros=qt.zeros)
    code = kernel_dtype(out_dtype, "dequant_w4")
    if qt.packed.dtype != torch.int8 or qt.scales.dtype != torch.float32 \
            or (qt.zeros is not None and qt.zeros.dtype != torch.float32):
        raise ValueError("dequant_w4 takes int8 packed bytes and fp32 "
                         "scales and zeros")
    if g % 2 or K % g or qt.scales.shape != (K // g, N) or N % 16:
        raise ValueError(f"dequant_w4 needs an even group dividing K and "
                         f"N % 16 == 0, got K={K}, N={N}, group {g}, "
                         f"scales {tuple(qt.scales.shape)}")
    out = torch.empty((K, N), dtype=out_dtype, device=qt.packed.device)
    DEQUANT_W4.launch(build.ptr(qt.packed), build.ptr(qt.scales),
                      build.ptr(qt.zeros), build.ptr(out), K, N, g, code,
                      build.stream_ptr(out.device))
    return out


# ---------------------------------------------------------------------------
# phase 2: Split-K GEMM over the workspace
# ---------------------------------------------------------------------------

def splitk_gemm_plain(x: torch.Tensor, w: torch.Tensor, *,
                      split_k: int = 4) -> torch.Tensor:
    return ref.splitk_partials_ref(x, w, split_k)


def splitk_gemm(x: torch.Tensor, w: torch.Tensor, *,
                split_k: int = 4) -> torch.Tensor:
    """Phase 2: S fp32 partial products over K slices → (S, M, N)."""
    if x.device.type == "cpu":
        return splitk_gemm_plain(x, w, split_k=split_k)
    return launch_dense(x, w, split_k, direct=False)


# ---------------------------------------------------------------------------
# phase 3: reduction
# ---------------------------------------------------------------------------

def reduce_partials_plain(partials: torch.Tensor, *,
                          out_dtype=torch.bfloat16) -> torch.Tensor:
    return ref.reduce_ref(partials, out_dtype=out_dtype)


def reduce_partials(partials: torch.Tensor, *,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """Phase 3: C = Σ_i C_i in fp32, cast to ``out_dtype``."""
    if partials.device.type == "cpu":
        return reduce_partials_plain(partials, out_dtype=out_dtype)
    if partials.dim() != 3 or partials.dtype != torch.float32:
        raise ValueError(f"reduce_partials takes (S, M, N) fp32, got "
                         f"{tuple(partials.shape)} {partials.dtype}")
    S, M, N = partials.shape
    check_operands(partials.device, partials=partials)
    code = kernel_dtype(out_dtype, "reduce_partials")
    if (M * N) % 4 or S < 1:
        raise ValueError(f"reduce_partials needs M·N % 4 == 0, got M={M}, "
                         f"N={N}")
    out = torch.empty((M, N), dtype=out_dtype, device=partials.device)
    REDUCE_PARTIALS.launch(build.ptr(partials), build.ptr(out), S, M, N,
                           code, build.stream_ptr(out.device))
    return out


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def w4a16_decoupled_plain(x: torch.Tensor, qt: QuantizedTensor, *,
                          split_k: int = 4, out_dtype=None) -> torch.Tensor:
    w = dequant_w4_plain(qt, out_dtype=x.dtype)
    return reduce_partials_plain(splitk_gemm_plain(x, w, split_k=split_k),
                                 out_dtype=out_dtype or x.dtype)


def w4a16_decoupled(x: torch.Tensor, qt: QuantizedTensor, *,
                    split_k: int = 4, out_dtype=None) -> torch.Tensor:
    """C = x · Dequant(W) through the three phases (workspace in x's
    dtype); on CUDA tensors, three kernel launches."""
    if x.dim() != 2 or x.shape[1] != qt.K:
        raise ValueError(f"x {tuple(x.shape)} vs weight {qt.shape}")
    w = dequant_w4(qt, out_dtype=x.dtype)
    return reduce_partials(splitk_gemm(x, w, split_k=split_k),
                           out_dtype=out_dtype or x.dtype)
