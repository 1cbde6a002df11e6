"""Kernel entry points over the plan-based API (port of
``repro/kernels/ops.py``).

``w4a16_matmul(x, qt, strategy=...)`` builds a
:class:`~repro_torch.kernels.planning.MatmulProblem`, asks the planner for
a plan (forcing the strategy and split_k when given) and executes it. The
registered strategies: ``reference`` and ``w4a8_xla`` (the plain paths, for
CPU operands), ``fused``, ``decoupled``, ``w8a16_fused`` and ``w4a8_fused``
(the Hopper kernels, for CUDA operands); ``auto`` ranks every strategy that
supports the tensor's format and device. ``autotune=True`` runs the
planner's refine pass (``kernels/autotune.py``), as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.quant import QuantizedTensor
from repro_torch.kernels import planning
from repro_torch.kernels.gemm import gemm
from repro_torch.kernels.planning import choose_split_k
from repro_torch.kernels.w4a8_fused import w4a8_fused
from repro_torch.kernels.w4a16_decoupled import (dequant_w4, reduce_partials,
                                                 splitk_gemm, w4a16_decoupled)
from repro_torch.kernels.w4a16_fused import w4a16_fused
from repro_torch.kernels.w8a16_fused import w8a16_fused

__all__ = [
    "w4a16_matmul", "gemm", "w4a16_fused", "w4a16_decoupled",
    "w8a16_fused", "w4a8_fused",
    "dequant_w4", "splitk_gemm", "reduce_partials", "choose_split_k",
]


def w4a16_matmul(x: torch.Tensor, qt: QuantizedTensor, *,
                 strategy: str = "auto", split_k: Optional[int] = None,
                 autotune: bool = False, out_dtype=None) -> torch.Tensor:
    """C = x · Dequant(W); x may have leading dims. ``auto`` defers to the
    planner (``split_k`` overrides its degree); a named strategy is forced
    with ``split_k`` defaulting to 1, or, with ``autotune``, to the refine
    pass's."""
    problem = planning.MatmulProblem.from_operands(
        x, qt, out_dtype=out_dtype or x.dtype)
    if strategy == "auto":
        plan = planning.plan_matmul(problem, refine=autotune)
        if split_k is not None:
            plan = dataclasses.replace(plan, split_k=split_k)
    else:
        plan = planning.plan_matmul(problem, strategy=strategy,
                                    refine=autotune)
        if not autotune:
            plan = dataclasses.replace(
                plan, split_k=1 if split_k is None else split_k)
    return planning.execute(plan, x, qt)
