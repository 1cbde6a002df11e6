"""GQA attention: chunked online softmax (training), attention over a
pos-tagged KV window (decode, chunked prefill) and the per-slot ring cache
that the ring engine and the speculative draft model decode on. Port of
``repro/models/attention.py``.

A ring can be one rank's slice of a longer window (``ring_len`` entries,
this rank's ``[start, start + W)``; the ring engine on a mesh whose model
axis divides the window): inserts and prefills then write only the
entries that fall in the slice, and :func:`ring_partials` gives a slice's
online-softmax partials, which :func:`combine_partials` merges across the
slices.

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


def init_cache(batch: int, window: int, num_kv_heads: int, head_dim: int,
               dtype, *, device=None) -> KVCache:
    """An empty ring cache of ``window`` entries per batch row."""
    shape = (batch, window, num_kv_heads, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((batch, window), -1, dtype=torch.int32,
                       device=device))


def cache_insert(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: torch.Tensor, *, ring_len: int = 0,
                 start: int = 0) -> KVCache:
    """Insert one token's K/V per row at ring slot ``pos % W``, in place
    (k_new/v_new: (B, Hkv, D); pos: (B,) absolute). With ``ring_len`` the
    cache holds entries ``[start, start + W)`` of a ``ring_len`` window,
    and a row whose slot falls outside them writes nothing."""
    W = cache.k.shape[1]
    b = torch.arange(cache.k.shape[0], device=pos.device)
    if not ring_len:
        slot = (pos % W).long()
        cache.k[b, slot] = k_new.to(cache.k.dtype)
        cache.v[b, slot] = v_new.to(cache.v.dtype)
        cache.pos[b, slot] = pos.to(torch.int32)
        return cache
    local = (pos % ring_len).long() - start
    own = (local >= 0) & (local < W)
    slot = local.clamp(0, W - 1)
    keep = own[:, None, None]
    cache.k[b, slot] = torch.where(keep, k_new.to(cache.k.dtype),
                                   cache.k[b, slot])
    cache.v[b, slot] = torch.where(keep, v_new.to(cache.v.dtype),
                                   cache.v[b, slot])
    cache.pos[b, slot] = torch.where(own, pos.to(torch.int32),
                                     cache.pos[b, slot])
    return cache


def cache_reset_slots(cache: KVCache, slots) -> KVCache:
    """Evict batch row(s) in place: mark every ring entry empty (-1 tags;
    the stale K/V bytes are unreachable). Works on a per-layer (B, W) or a
    layer-stacked (L, B, W) cache: the batch dim is ``pos``'s second to
    last."""
    cache.pos[..., slots, :] = -1
    return cache


def cache_prefill(cache: KVCache, k_seq: torch.Tensor,
                  v_seq: torch.Tensor, *, ring_len: int = 0,
                  start: int = 0) -> KVCache:
    """Fill the ring with the last W tokens of a prefilled sequence at
    positions 0..S-1, in place (k_seq/v_seq: (B, S, Hkv, D)). With
    ``ring_len`` the cache holds entries ``[start, start + W)`` of a
    ``ring_len`` window: the last ``ring_len`` tokens whose slots fall
    there are written."""
    B, S = k_seq.shape[:2]
    W = cache.k.shape[1]
    full = ring_len or W
    T = min(S, full)
    # made on the device where no host mask is needed: a captured prefill
    # (runtime/steps.py) takes no host-to-device copy
    tail = torch.arange(S - T, S,
                        device=None if ring_len else k_seq.device)
    slot = tail % full - start
    if ring_len:
        mine = (slot >= 0) & (slot < W)
        tail, slot = tail[mine], slot[mine]
    src = tail.to(k_seq.device)
    slot = slot.to(k_seq.device)
    cache.k[:, slot] = k_seq[:, src].to(cache.k.dtype)
    cache.v[:, slot] = v_seq[:, src].to(cache.v.dtype)
    cache.pos[:, slot] = src.to(torch.int32).expand(B, len(src))
    return cache


def _chunk(S: int, target: int) -> int:
    """The largest divisor of S that is at most ``target``."""
    for c in range(min(target, S), 0, -1):
        if S % c == 0:
            return c
    return 1


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      q_chunk: int = 1024,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Blockwise online-softmax attention in plain PyTorch, differentiable
    by autograd: the JAX trainer's attention. q: (B, S, Hq, D); k, v: (B,
    S, Hkv, D). Query chunks become a batch dim and a loop walks the KV
    chunks. q is scaled in fp32 and cast to k's dtype before the dot;
    scores and the readout accumulate in fp32 (products of the input dtype,
    exact in fp32); p is cast to v's dtype before the readout; the running
    (m, l, acc) state is fp32; the output is ``acc / max(l, 1e-30)`` in
    q's dtype."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    f32 = torch.float32
    cq, ck = _chunk(Sq, q_chunk), _chunk(Skv, kv_chunk)
    nq, nk = Sq // cq, Skv // ck
    qc = (q.reshape(B, nq, cq, Hkv, G, D).to(f32) * (D ** -0.5)) \
        .to(k.dtype).to(f32)
    qpos = torch.arange(Sq, device=q.device).reshape(nq, cq)
    m = torch.full((B, nq, Hkv, G, cq), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, nq, Hkv, G, cq, D), dtype=f32, device=q.device)
    for j in range(nk):
        kj = k[:, j * ck:(j + 1) * ck].to(f32)           # (B, ck, Hkv, D)
        vj = v[:, j * ck:(j + 1) * ck]
        kpos = torch.arange(j * ck, (j + 1) * ck, device=q.device)
        s = torch.einsum("bqchgd,bkhd->bqhgck", qc, kj)
        mask = torch.ones((nq, cq, ck), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (kpos[None, None, :] <= qpos[:, :, None])
        if window:
            mask = mask & (kpos[None, None, :] > qpos[:, :, None] - window)
        s = torch.where(mask[None, :, None, None], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bqhgck,bkhd->bqhgcd", p.to(vj.dtype).to(f32),
                          vj.to(f32))
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 1, 4, 2, 3, 5).reshape(B, Sq, Hq, D).to(q.dtype)


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


def ring_partials(q: torch.Tensor, cache: KVCache, pos: torch.Tensor, *,
                  window: int = 0):
    """One-token attention partials over a ring (or one rank's slice of
    it): q (B, Hq, D), pos (B,). The masking, scaling and casts of
    :func:`decode_attention`, but unnormalized: the max ``m`` and the sum
    ``l`` of exp(s - m) (B, Hq) and the readout ``acc`` (B, Hq, D), fp32,
    with p cast to the V dtype before the readout. A slice with no
    visible entry carries m = -1e30, which :func:`combine_partials`
    cancels."""
    B, Hq, D = q.shape
    Hkv = cache.k.shape[2]
    G = Hq // Hkv
    qg = (q.reshape(B, Hkv, G, D).to(torch.float32)
          * (D ** -0.5)).to(cache.k.dtype)
    s = torch.einsum("bhgd,bwhd->bhgw", qg.to(torch.float32),
                     cache.k.to(torch.float32))
    kpos = cache.pos[:, None, None, :]
    qp = pos[:, None, None, None]
    valid = (kpos >= 0) & (kpos <= qp)
    if window:
        valid = valid & (kpos > qp - window)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgw,bwhd->bhgd",
                       p.to(cache.v.dtype).to(torch.float32),
                       cache.v.to(torch.float32))
    return acc.reshape(B, Hq, D), m.reshape(B, Hq), l.reshape(B, Hq)


def combine_partials(acc: torch.Tensor, m: torch.Tensor,
                     l: torch.Tensor) -> torch.Tensor:
    """Merge S slices' partials stacked on dim 0 (acc (S, ..., D); m and l
    (S, ...)) into the normalized output, fp32: the log-sum-exp rule of
    ``kernels/paged_attention.py``'s plain ``_combine`` (a slice whose m is
    -1e30 weighs exp(-1e30 - m_max) = 0)."""
    m_max = m.amax(dim=0)
    alpha = torch.exp(m - m_max)
    l_tot = (l * alpha).sum(dim=0)
    out = (acc * alpha[..., None]).sum(dim=0)
    return out / l_tot.clamp_min(1e-30)[..., None]
