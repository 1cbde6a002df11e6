"""Split-K search for the fused W4A16 kernel on Hopper (port of
``repro/kernels/autotune.py``).

The JAX package ranks Pallas tiles (block_m, block_n, block_k, split_k) by
the TPU v5e roofline under a VMEM budget. The Hopper kernel picks its own
tiles, and they follow M: 8, 16 or 32 token rows a block, ``GEMM_BN``
columns, and as many K slices inside one thread-block cluster as fill the
card (``kernels/gemm.py:gemm_geometry``). So only split_k is a free choice
here. The candidates are the launches ``gemm_geometry`` accepts: split_k a
power of two that leaves K slices whole quant groups, each either summed
inside one cluster (at most ``MAX_CLUSTER`` slices, the kernel writes the
output: one launch) or written as fp32 partials that a second op sums.
Each is ranked by the H100 roofline (``core/costmodel.H100``) with the
memory rate and the tensor-core rate scaled by the share of the card its
blocks fill in their last wave (two blocks an SM, over 132 SMs), plus one
launch's floor per op. Nothing is timed, and the ranking is not a claim:
``chip_smoke.py`` prints the refined plan's time beside the default's.

:func:`autotune_w4a16` returns the JAX package's 4-tuple: the winning
launch's row tile, ``GEMM_BN``, the K rows each of its blocks walks, and
split_k.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.core.costmodel import H100
from repro_torch.kernels.gemm import GEMM_BN, gemm_geometry, sums_in_kernel

BLOCKS_PER_SM = 2          # the geometry sizes its K slices for two an SM
LAUNCH_S = 5e-6            # a launch's floor on the card: the timer floor
                           # chip_smoke.py's phase 5 measures on an H100
TIE = 0.02                 # a larger split must win by more than this share


def _score(M: int, N: int, K: int, group: int, split_k: int, geo,
           direct: bool, elem: int, has_zeros: bool) -> float:
    """Modelled seconds of one launch of ``geo`` (and, for partials, their
    sum): x read once per column tile, the packed weight and its scales
    once per row tile, the output (or S fp32 partials, written and read
    back) once, at the rates of the share of the card the blocks fill."""
    gx, gy, ks = geo.grid
    blocks = gx * gy * ks
    slots = BLOCKS_PER_SM * H100.num_sms
    waves = -(-blocks // slots)
    fill = blocks / (waves * slots)
    scales = (K // group) * N * 4 * (2 if has_zeros else 1)
    traffic = elem * M * K * gx + (K * N / 2 + scales) * gy + elem * M * N
    launches = 1
    if not direct:
        traffic += 2 * 4 * split_k * M * N
        launches = 2
    t = max(traffic / (H100.hbm_bw * fill),
            2.0 * M * N * K / (H100.flops * fill))
    return t + launches * LAUNCH_S


@functools.lru_cache(maxsize=4096)
def autotune_w4a16(M: int, N: int, K: int, group: int = 128, *,
                   dtype: torch.dtype = torch.bfloat16,
                   has_zeros: bool = False) -> Tuple[int, int, int, int]:
    """The best launch of the fused W4A16 kernel for x (M, K) against a
    (K, N) int4 weight at ``group``: ``(row tile, GEMM_BN, K rows a block,
    split_k)``. A larger split must beat the best smaller one by more than
    ``TIE`` of its time (a cluster's on-chip sum is not modelled). A shape
    that no launch takes gives split_k 1 and the row tile M sets."""
    best = None
    s = 1
    while K % s == 0 and (K // s) % group == 0 and (K // s) % 32 == 0:
        direct = sums_in_kernel(s, dtype, dtype)
        try:
            geo = gemm_geometry("int4", M, N, K, s, dtype, direct=direct,
                                group=group, has_zeros=has_zeros,
                                sms=H100.num_sms)
        except ValueError:
            geo = None
        if geo is not None:
            t = _score(M, N, K, group, s, geo, direct,
                       torch.finfo(dtype).bits // 8, has_zeros)
            if best is None or t < best[0] * (1 - TIE):
                best = (t, geo.bm, GEMM_BN, K // geo.ks, s)
        s *= 2
    if best is None:
        bm = 8 if M <= 8 else 16 if M <= 16 else 32
        return bm, GEMM_BN, K, 1
    return best[1:]
