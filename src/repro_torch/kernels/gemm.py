"""Dense GEMM ``C = x · w``: the FP16×FP16 baseline of the paper, and the
launch geometry of the float-contraction GEMM tile loop.

Port of ``repro/kernels/gemm.py``. On a CUDA tensor :func:`gemm` launches
the hand-written Hopper kernel ``csrc/dense_gemm.cu`` (see the note at the
top of that file); on a CPU tensor it runs :func:`gemm_plain`. The same
kernel, in its partials mode, is phase 2 of the decoupled W4A16 pipeline
(:func:`launch_dense` with ``direct=False``; see ``w4a16_decoupled.py``).
Products and sums are fp32, as the Pallas kernel's float contraction.

:func:`gemm_geometry` is the block layout of ``csrc/gemm_tile.cuh``, which
the dense, fused W4A16 and W8A16 kernels share: the wrappers compute it
here, in pure Python, and the C launcher recomputes it and refuses a launch
whose sizes differ.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.common import (MAX_SMEM, align128, check_operands,
                                        check_split, kernel_dtype)

DENSE_GEMM = build.CudaKernel(
    "dense_gemm", "dense_gemm.cu", "dense_gemm",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 12 + [ctypes.c_void_p])

# the tile loop's constants (csrc/gemm_tile.cuh); "w4a8" is the integer
# contraction of csrc/w4a8_gemm.cu
GEMM_KINDS = ("int4", "int8", "dense", "w4a8")
GEMM_BN = 64            # output columns a block: four m16 column tiles
GEMM_WARPS = 4
GEMM_STAGES = 4         # depth of the cp.async ring
MAX_CLUSTER = 8         # blocks of a thread-block cluster (portable limit)
_RED_LD = GEMM_BN + 4   # row stride (floats) of the warps' sums
_INT8_LD = GEMM_BN + 16  # row stride (bytes) of an int8 stage
W4A8_BK = 128           # K rows of a W4A8 unit
W4A8_STAGES = 2         # units in flight a warp
W4A8_GROUPS = (32, 64, 128)
_XQ_LD = W4A8_BK + 16   # row stride (bytes) of a unit's int8 x tile


@dataclass(frozen=True)
class GemmGeometry:
    """One launch of the tile loop: ``bm`` token rows and 64 columns a
    block, ``bk`` K rows a ring stage, ``stages`` stages; ``ks`` blocks
    along K per output tile (the plan's split_k times ``sub``), ``cluster``
    of them summing through distributed shared memory; ``grid`` (column
    tiles, M tiles x the batch's GEMMs, ks); ``scale_rows`` int4
    group-scale rows a stage;
    ``smem`` bytes of dynamic shared memory. fp32 activations take the
    CUDA-core variant: fixed 16- or 32-row blocks, one block per plan
    slice, no ring (stages 1, smem 0)."""
    bm: int
    bk: int
    stages: int
    ks: int
    sub: int
    cluster: int
    grid: Tuple[int, int, int]
    scale_rows: int
    stage_bytes: int
    smem: int

    def launch_args(self) -> Tuple[int, ...]:
        """The geometry as the C launchers take it (and check it)."""
        return (self.bm, self.bk, self.stages, self.ks, self.cluster,
                self.smem)


def sums_in_kernel(split_k: int, dtype: torch.dtype,
                   out_dtype: torch.dtype) -> bool:
    """Whether the kernel writes the (M, N) output itself (direct mode):
    the output in x's dtype, and the ``split_k`` slices summed inside one
    thread-block cluster, which holds at most MAX_CLUSTER of them on the
    tensor-core loop (the fp32 variant sums none). Otherwise the kernel
    writes (split_k, M, N) fp32 partials that the wrapper sums and casts.
    A shape rule, fixed before the launch."""
    if out_dtype != dtype:
        return False
    return split_k == 1 or (dtype != torch.float32
                            and split_k <= MAX_CLUSTER)


@functools.lru_cache(maxsize=1024)          # on every launch's host path
def gemm_geometry(kind: str, M: int, N: int, K: int, split_k: int,
                  dtype: torch.dtype, *, direct: bool, group: int = 0,
                  has_zeros: bool = False, sms: int = 132,
                  batch: int = 1) -> GemmGeometry:
    """The block layout of ``csrc/gemm_tile.cuh`` (its make_geometry, field
    for field) for weight stage ``kind`` ("int4", "int8", "dense", or the
    W4A8 kernel's "w4a8") on a card with ``sms`` SMs; raises ValueError for
    a launch the kernels do not take. Tile rows follow M (8, 16 or 32
    tokens); ``sub`` doubles while the card has fewer than two blocks per
    SM, K slices stay multiples of 32 and a cluster stays within
    MAX_CLUSTER blocks. ``batch`` GEMMs of one shape (an expert stack) run
    in the one launch, stacked along the grid's y axis, and count their
    tiles together (the float rings only)."""
    if kind not in GEMM_KINDS:
        raise ValueError(f"unknown GEMM weight stage {kind!r}")
    code = kernel_dtype(dtype, "GEMM")
    if M < 1 or N < 16 or N % 16:
        raise ValueError(f"the GEMM kernels need M >= 1 and N % 16 == 0, "
                         f"got M={M}, N={N}")
    check_split(K, split_k)
    if batch < 1 or (kind == "w4a8" and batch != 1):
        raise ValueError(f"batch={batch}: the float rings take a batch of "
                         f">= 1 GEMMs, the W4A8 kernel one")
    if kind == "w4a8":
        return _w4a8_geometry(M, N, K, split_k, direct, group, has_zeros,
                              sms)
    if kind == "int4" and (group < 2 or group % 2 or K % group):
        raise ValueError(f"group_size {group} must be even and divide K={K}")
    gx = -(-N // GEMM_BN)
    if code == 2:                                   # the fp32 variant
        if direct and split_k != 1:
            raise ValueError("the fp32 GEMM variant writes its output "
                             "directly only at split_k == 1")
        bm = 16 if M <= 16 else 32
        return GemmGeometry(bm, 32, 1, split_k, 1, 1,
                            (gx, _grid_y(M, bm, batch), split_k), 0, 0, 0)
    if direct and split_k > MAX_CLUSTER:
        raise ValueError(f"a cluster sums at most {MAX_CLUSTER} K slices, "
                         f"got split_k={split_k}")
    elem = torch.finfo(dtype).bits // 8
    bm = 8 if M <= 8 else 16 if M <= 16 else 32
    bk = 64 if kind == "dense" else 128
    tiles = gx * -(-M // bm) * batch
    cap = MAX_CLUSTER // split_k if direct else MAX_CLUSTER
    sub = 1
    while (sub * 2 <= cap and K % (split_k * sub * 2) == 0
           and (K // (split_k * sub * 2)) % 32 == 0
           and tiles * split_k * sub < 2 * sms):
        sub *= 2
    ks = split_k * sub
    sr = min(bk // 2, (bk - 2) // group + 2) if kind == "int4" else 0
    if kind == "int4":
        wbytes = align128(bk // 2 * GEMM_BN) \
            + align128(sr * GEMM_BN * 4) * (2 if has_zeros else 1)
    elif kind == "int8":
        wbytes = align128(bk * _INT8_LD)
    else:
        wbytes = align128(bk * (GEMM_BN + 8) * elem)
    stage = wbytes + align128(bm * (bk + 8) * elem)
    smem = max(GEMM_STAGES * stage, GEMM_WARPS * bm * _RED_LD * 4)
    if smem > MAX_SMEM:
        raise ValueError(f"the GEMM tile needs {smem} B of shared memory "
                         f"(> {MAX_SMEM})")
    return GemmGeometry(bm, bk, GEMM_STAGES, ks, sub,
                        ks if direct else sub, (gx, _grid_y(M, bm, batch), ks),
                        sr, stage, smem)


def _grid_y(M: int, bm: int, batch: int) -> int:
    gy = -(-M // bm) * batch
    if gy > 65535:
        raise ValueError(f"{batch} GEMMs of {M} rows need {gy} blocks along "
                         f"the grid's y axis (> 65535)")
    return gy


def _w4a8_geometry(M, N, K, split_k, direct, group, has_zeros,
                   sms) -> GemmGeometry:
    """The W4A8 kernel's layout (make_geometry's W4A8 branch): every dtype
    on the int8 tensor cores; each block's K rows whole scale groups; a
    stage is one warp's unit (packed weights, group scales and zero-points,
    the int8 x tile, Σx_q per group), ``stages`` of them a warp, then the
    block's row scales."""
    if group not in W4A8_GROUPS or (K // split_k) % group:
        raise ValueError(f"the W4A8 kernel takes group 32, 64 or 128 "
                         f"dividing K / split_k, got group {group}, K={K}, "
                         f"split_k={split_k}")
    if direct and split_k > MAX_CLUSTER:
        raise ValueError(f"a cluster sums at most {MAX_CLUSTER} K slices, "
                         f"got split_k={split_k}")
    bm = 8 if M <= 8 else 16 if M <= 16 else 32
    gx = -(-N // GEMM_BN)
    tiles = gx * -(-M // bm)
    cap = MAX_CLUSTER // split_k if direct else MAX_CLUSTER
    sub = 1
    while (sub * 2 <= cap and K % (split_k * sub * 2) == 0
           and (K // (split_k * sub * 2)) % group == 0
           and tiles * split_k * sub < 2 * sms):
        sub *= 2
    ks = split_k * sub
    sr = W4A8_BK // group
    stage = (align128(W4A8_BK // 2 * GEMM_BN)
             + align128(sr * GEMM_BN * 4) * (2 if has_zeros else 1)
             + align128(bm * _XQ_LD) + align128(bm * sr * 4))
    ring = GEMM_WARPS * W4A8_STAGES * stage
    smem = max(ring, GEMM_WARPS * bm * _RED_LD * 4) + align128(2 * bm * 4)
    if smem > MAX_SMEM:
        raise ValueError(f"the W4A8 tile needs {smem} B of shared memory "
                         f"(> {MAX_SMEM})")
    return GemmGeometry(bm, W4A8_BK, W4A8_STAGES, ks, sub,
                        ks if direct else sub, (gx, -(-M // bm), ks), sr,
                        stage, smem)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device (what the launcher reads too)."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


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
    geo = gemm_geometry("dense", M, N, K, split_k, x.dtype, direct=direct,
                        sms=sm_count(x.device))
    if direct:
        out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    else:
        out = torch.empty((split_k, M, N), dtype=torch.float32,
                          device=x.device)
    DENSE_GEMM.launch(build.ptr(x), build.ptr(w), build.ptr(out), M, N, K,
                      split_k, code, int(direct), *geo.launch_args(),
                      build.stream_ptr(x.device))
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
