"""Plain PyTorch oracles for the kernels (port of ``repro/kernels/ref.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant import (QuantizedTensor, dequantize,
                                    w4a16_matmul_ref)


def gemm_ref(x: torch.Tensor, w: torch.Tensor, out_dtype=None
             ) -> torch.Tensor:
    """Dense GEMM oracle: fp32 products and accumulation, cast to
    ``out_dtype`` (default x's dtype)."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32)) \
        .to(out_dtype or x.dtype)


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


def splitk_partials_ref(x: torch.Tensor, w: torch.Tensor,
                        split_k: int) -> torch.Tensor:
    """S fp32 partial GEMMs over K slices → (S, M, N) fp32 (paper Alg. 1
    phase 2)."""
    K = x.shape[1]
    if split_k < 1 or K % split_k:
        raise ValueError(f"split_k={split_k} must divide K={K}")
    ks = K // split_k
    xf, wf = x.to(torch.float32), w.to(torch.float32)
    return torch.stack([torch.matmul(xf[:, i * ks:(i + 1) * ks],
                                     wf[i * ks:(i + 1) * ks])
                        for i in range(split_k)])


def reduce_ref(partials: torch.Tensor, out_dtype=torch.bfloat16
               ) -> torch.Tensor:
    """Sum over S in fp32, slice 0 first, then the cast (paper Alg. 1
    phase 3)."""
    acc = partials[0].to(torch.float32)
    for p in partials[1:]:
        acc = acc + p
    return acc.to(out_dtype)


def splitk_matmul_plain(x: torch.Tensor, w: torch.Tensor, split_k: int,
                        out_dtype) -> torch.Tensor:
    """x · w with fp32 products and accumulation, K cut into ``split_k``
    slices whose fp32 partials are summed before the cast: the arithmetic
    of every float-contraction GEMM kernel (``w`` already rounded to the
    compute dtype)."""
    parts = splitk_partials_ref(x, w, split_k)
    out = parts[0] if split_k == 1 else torch.sum(parts, dim=0)
    return out.to(out_dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """Full-softmax GQA attention oracle in fp32. q: (B, Sq, Hq, D), k/v:
    (B, Skv, Hkv, D); the output in q's dtype."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).to(torch.float32) * D ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32))
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return o.reshape(B, Sq, Hq, D).to(q.dtype)
