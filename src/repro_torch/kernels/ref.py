"""Plain PyTorch oracles for the W4A16 GEMM (port of ``repro/kernels/ref.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant import (QuantizedTensor, dequantize,
                                    w4a16_matmul_ref)


def dequant_ref(packed: torch.Tensor, scales: torch.Tensor,
                zeros: Optional[torch.Tensor], group_size: int,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """Unpack int4 + apply group scales → (K, N) ``out_dtype``: the
    W4A16-family :func:`dequantize` of these fields."""
    return dequantize(QuantizedTensor(packed, scales, zeros, group_size,
                                      out_dtype))


def w4a16_ref(x: torch.Tensor, qt: QuantizedTensor,
              out_dtype=None) -> torch.Tensor:
    """C = A · Dequant(W) (paper Eq. 2): the weight is materialized in
    ``qt.out_dtype`` and one ``torch.matmul`` in that dtype computes the
    product."""
    return w4a16_matmul_ref(x, qt, out_dtype=out_dtype, acc_dtype=None)
