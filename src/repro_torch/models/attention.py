"""GQA attention over a pos-tagged KV window (port of the decode half of
``repro/models/attention.py``).

Masking is positional: an entry at position ``kpos`` is visible to a query
at ``qpos`` iff ``kpos >= 0 & kpos <= qpos`` (and ``kpos > qpos - window``
for sliding-window attention); masked scores are ``-1e30``, not ``-inf``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, W, Hkv, D)
    v: torch.Tensor          # (B, W, Hkv, D)
    pos: torch.Tensor        # (B, W) int32 absolute position, -1 empty


def decode_attention(q: torch.Tensor, cache: KVCache, pos: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """One-token decode attention (q: (B, Hq, D); pos: (B,)): the C=1 case
    of :func:`prefix_chunk_attention`."""
    return prefix_chunk_attention(q[:, None], cache, pos[:, None],
                                  window=window)[:, 0]


def prefix_chunk_attention(q: torch.Tensor, cache: KVCache,
                           qpos: torch.Tensor, *,
                           window: int = 0) -> torch.Tensor:
    """A chunk of queries (q: (B, C, Hq, D); qpos: (B, C), -1 = padding)
    over a pos-tagged window that already holds the chunk's own K/V. q is
    scaled in fp32 and cast to the cache dtype; scores and the readout
    accumulate in fp32; p is cast to the V dtype before the readout.
    Padded queries produce garbage the caller ignores."""
    B, C, Hq, D = q.shape
    Hkv = cache.k.shape[2]
    G = Hq // Hkv
    qg = (q.reshape(B, C, Hkv, G, D).to(torch.float32)
          * (D ** -0.5)).to(cache.k.dtype)
    s = torch.einsum("bchgd,bwhd->bhgcw", qg.to(torch.float32),
                     cache.k.to(torch.float32))
    kpos = cache.pos[:, None, :]                          # (B, 1, W)
    qp = qpos[:, :, None]                                  # (B, C, 1)
    valid = (kpos >= 0) & (kpos <= qp)
    if window:
        valid = valid & (kpos > qp - window)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(cache.v.dtype)
    out = torch.einsum("bhgcw,bwhd->bchgd", p.to(torch.float32),
                       cache.v.to(torch.float32))
    return out.reshape(B, C, Hq, D).to(q.dtype)
