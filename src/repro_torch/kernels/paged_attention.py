"""Paged attention in one pass over pooled KV: decode (q_len=1) and chunked
prefill (q_len=C).

Port of ``repro/kernels/paged_attention.py``. ``_pooled_partials`` is the
kernel's function: for every (slot, kv-head, Q tile, page partition) it
walks ``tables[slot, s·P + p]`` (a ``-1`` entry is the null block 0),
dequantizes ``kv8_channel`` pages, scores the pre-scaled queries against
them with the positional mask ``kpos >= 0 & kpos <= qpos & kpos < start``
(and ``kpos > qpos - window``; masked scores are ``-1e30``), and returns
unnormalized ``(acc, m, l)`` partials per partition. On a CUDA tensor it
launches ``csrc/paged_attention.cu``; on a CPU tensor it runs
:func:`pooled_partials_plain`, the same function in plain PyTorch. There is
no fallback between the two.

``_combine`` and the chunk's C×C intra-segment partial stay in PyTorch, as
they sit outside the ``pallas_call`` in JAX. The caller scatters a chunk's
K/V into the pool only after :func:`fused_chunk_attention` returns (read
before scatter), and decode inserts its token before attending, so
``start = pos + 1`` turns ``kpos < start`` into the decode mask.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.quant import KVFormat
from repro_torch.kernels import build, planning
from repro_torch.kernels.common import KERNEL_DTYPES, MAX_SMEM, align128

NEG_INF = -1e30
# head dims the kernel is built for (one instantiation each)
HEAD_DIMS = (32, 64, 80, 96, 128)
MAX_ROWS = 128          # Tq·G query rows of a block: 8 warps x 16
_WARPS = 8

PAGED_ATTENTION = build.CudaKernel(
    "paged_attention", "paged_attention.cu", "paged_attention_partials",
    [ctypes.c_void_p] * 12 + [ctypes.c_int] * 17 + [ctypes.c_void_p])


@dataclass(frozen=True)
class PagedGeometry:
    """How ``csrc/paged_attention.cu`` lays out one block: ``row_groups``
    16-row mma tiles of query rows, ``key_groups`` warps per row group
    taking different 16-key sub-tiles of a stage, ``kb`` keys a stage,
    ``stages`` in the cp.async ring, ``smem`` bytes of shared memory."""
    row_groups: int
    key_groups: int
    kb: int
    stages: int
    smem: int


def paged_smem_bytes(QG: int, D: int, elem: int, quantized: bool, kb: int,
                     stages: int, P: int, key_groups: int) -> int:
    """The kernel's shared-memory footprint (its ``layout``, byte for
    byte): the partition's table entries, the padded Q tile, ``stages``
    ring slots (K and V tiles in the compute dtype, or raw int8 K and V
    with their scales, and the position tags), the dequantized K and V
    tiles when quantized; the key groups' merge area reuses the ring."""
    ld = D + (4 if elem == 4 else 8)
    rows = -(-QG // 16) * 16
    tile = align128(elem * kb * ld)
    off = align128(4 * P)
    off = align128(off + elem * rows * ld)
    ring = off
    if quantized:
        stage = 2 * align128(kb * D) + 2 * align128(4 * kb)
    else:
        stage = 2 * tile
    stage += align128(4 * kb)
    off += stages * stage
    if quantized:
        off += 2 * tile
    if key_groups > 1:
        off = max(off, ring + align128(4 * key_groups * rows * (D + 2)))
    return off


def paged_geometry(QG: int, D: int, dtype: torch.dtype, quantized: bool,
                   P: int) -> PagedGeometry:
    """The block layout for ``QG`` query rows of dim ``D`` over partitions
    of ``P`` pages; raises ValueError for a shape the kernel does not take.
    The warps split into ceil(QG/16) row groups and, for few rows (decode),
    key groups; a stage holds 16 keys per sub-tile, at least four
    sub-tiles and one per key group. fp32 tiles are twice as wide, so fp32
    keeps two stages and at most four key groups."""
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"paged attention kernel: unsupported compute "
                         f"dtype {dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged attention kernel: head_dim {D} is not one "
                         f"it is built for {HEAD_DIMS}")
    if not 1 <= QG <= MAX_ROWS:
        raise ValueError(f"paged attention kernel: {QG} query rows per "
                         f"block (Tq·G) exceed {MAX_ROWS}")
    elem = torch.finfo(dtype).bits // 8
    rows = -(-QG // 16)
    kw = 1
    while kw * 2 * rows <= _WARPS and kw * 2 <= (4 if elem == 4 else 8):
        kw *= 2
    kb = 16 * max(4, kw)
    stages = 2 if elem == 4 else 3
    smem = paged_smem_bytes(QG, D, elem, quantized, kb, stages, P, kw)
    if smem > MAX_SMEM:
        raise ValueError(f"paged attention kernel: {QG} query rows of dim "
                         f"{D} over {P}-page partitions need {smem} B of "
                         f"shared memory (> {MAX_SMEM})")
    return PagedGeometry(rows, kw, kb, stages, smem)


def _check_pool(pool, fmt: KVFormat) -> None:
    if fmt.quantized and (pool.k_scale is None or pool.v_scale is None):
        raise ValueError(
            f"KV format {fmt.name!r} stores per-(token, head) scales, but "
            f"the pool carries none — was it built with init_pool(..., "
            f"kv_format={fmt.name!r})?")


def _dequant_pages(payload, scale, fmt: KVFormat, dtype):
    if not fmt.quantized:
        return payload.to(dtype)
    return (payload.to(torch.float32)
            * scale.to(torch.float32)[..., None]).to(dtype)


def pooled_partials_plain(qk, positions, start, pool, tables, *, Tq: int,
                          G: int, S: int, window: int, fmt: KVFormat):
    """Plain PyTorch version of the kernel's function.

    qk: (B, Hkv, QT, QG, D) pre-scaled queries in the compute dtype, rows
    ordered (tq, g); positions (B, C); start (B,); tables (B, T), T = S·P.
    Returns acc (B, Hkv, QT, S, QG, D), m and l (B, Hkv, QT, S, QG), fp32.
    """
    B, Hkv, QT, QG, D = qk.shape
    T = tables.shape[1]
    P = T // S
    ps = pool.page_pos.shape[-1]
    dtype = qk.dtype
    pages = tables.clamp_min(0).long().reshape(B, S, P)      # null block 0
    k = _dequant_pages(pool.k_pool[pages],
                       None if pool.k_scale is None else pool.k_scale[pages],
                       fmt, dtype)                          # (B,S,P,ps,Hkv,D)
    v = _dequant_pages(pool.v_pool[pages],
                       None if pool.v_scale is None else pool.v_scale[pages],
                       fmt, dtype)
    k = k.reshape(B, S, P * ps, Hkv, D).permute(0, 3, 1, 2, 4)
    v = v.reshape(B, S, P * ps, Hkv, D).permute(0, 3, 1, 2, 4)
    kpos = pool.page_pos[pages].reshape(B, S, P * ps)
    s = torch.einsum("bhtrd,bhskd->bhtsrk", qk.to(torch.float32),
                     k.to(torch.float32))                 # (B,Hkv,QT,S,QG,Kn)
    qpos = positions.reshape(B, QT, Tq, 1).expand(B, QT, Tq, G) \
        .reshape(B, QT, QG)[:, None, :, None, :, None]
    kp = kpos[:, None, None, :, None, :]
    st = start.reshape(B, 1, 1, 1, 1, 1)
    valid = (kp >= 0) & (kp <= qpos) & (kp < st)
    if window:
        valid = valid & (kp > qpos - window)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhtsrk,bhskd->bhtsrd",
                       p.to(dtype).to(torch.float32), v.to(torch.float32))
    return acc, m, l


def _launch_partials(qk, positions, start, pool, tables, *, Tq: int, G: int,
                     S: int, window: int, fmt: KVFormat):
    """Launch ``csrc/paged_attention.cu`` on CUDA operands."""
    B, Hkv, QT, QG, D = qk.shape
    C = positions.shape[1]
    T = tables.shape[1]
    ps = pool.page_pos.shape[-1]
    dev = qk.device
    geo = paged_geometry(QG, D, qk.dtype, fmt.quantized, T // S)
    want_pool = torch.int8 if fmt.quantized else qk.dtype
    if pool.k_pool.dtype != want_pool or pool.v_pool.dtype != want_pool:
        raise ValueError(f"pool dtype {pool.k_pool.dtype} does not match "
                         f"{fmt.name} at compute dtype {qk.dtype}")
    operands = [qk, positions, start, pool.k_pool, pool.v_pool,
                pool.page_pos, tables]
    if fmt.quantized:
        operands += [pool.k_scale, pool.v_scale]
    for t in operands:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("paged attention kernel: every operand must be "
                             f"contiguous on {dev}")
    for t in (qk, pool.k_pool, pool.v_pool):       # 16-byte cp.async
        if t.data_ptr() % 16:
            raise ValueError("paged attention kernel: q and the K/V pools "
                             "must be 16-byte aligned")
    for t in (positions, start, pool.page_pos, tables):
        if t.dtype != torch.int32:
            raise ValueError("positions, start, page_pos and tables must "
                             "be int32")
    acc = torch.empty((B, Hkv, QT, S, QG, D), dtype=torch.float32, device=dev)
    m = torch.empty((B, Hkv, QT, S, QG), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    PAGED_ATTENTION.launch(
        build.ptr(qk), build.ptr(positions), build.ptr(start),
        build.ptr(pool.k_pool), build.ptr(pool.v_pool),
        build.ptr(pool.k_scale if fmt.quantized else None),
        build.ptr(pool.v_scale if fmt.quantized else None),
        build.ptr(pool.page_pos), build.ptr(tables),
        build.ptr(acc), build.ptr(m), build.ptr(l),
        B, Hkv, C, Tq, G, D, ps, T, S, T // S, int(window),
        int(fmt.quantized), KERNEL_DTYPES[qk.dtype], geo.kb, geo.stages,
        geo.key_groups, geo.smem, build.stream_ptr(dev))
    return acc, m, l


def _pooled_partials(qg, positions, start, pool, tables, *, window: int,
                     fmt: KVFormat, kv_partitions: Optional[int]):
    """One pass over the pooled pages; per-query unnormalized partials.

    qg: (B, C, Hkv, G, D) pre-scaled queries in the compute dtype;
    positions (B, C) int32 (-1 = padded row); start (B,) — pool entries at
    ``kpos >= start`` are masked. Returns (acc (B,Hkv,C,S,G,D),
    m (B,Hkv,C,S,G), l (B,Hkv,C,S,G)).
    """
    _check_pool(pool, fmt)
    B, C, Hkv, G, D = qg.shape
    T = tables.shape[1]
    Tq = planning.choose_q_block(C, G)
    QT = C // Tq
    QG = Tq * G
    if kv_partitions is None:
        kv_partitions = planning.choose_kv_partitions(
            B, Hkv, T, q_tiles=QT,
            cores=planning.num_cores(qg.device.type))
    S = max(1, min(int(kv_partitions), T))
    if T % S:
        raise ValueError(
            f"kv_partitions={S} must divide the table length T={T} "
            f"(choose_kv_partitions only returns divisors)")
    qk = qg.permute(0, 2, 1, 3, 4).reshape(B, Hkv, QT, QG, D).contiguous()
    positions = positions.to(torch.int32).contiguous()
    start = start.to(torch.int32).contiguous()
    tables = tables.to(torch.int32).contiguous()
    fn = pooled_partials_plain if qg.device.type == "cpu" \
        else _launch_partials
    acc, m, l = fn(qk, positions, start, pool, tables, Tq=Tq, G=G, S=S,
                   window=window, fmt=fmt)

    def per_query(x):
        # (B, Hkv, QT, S, QG, ·) → (B, Hkv, C, S, G, ·)
        y = x.reshape(B, Hkv, QT, S, Tq, G, *x.shape[5:])
        y = torch.movedim(y, 4, 3)
        return y.reshape(B, Hkv, C, S, G, *x.shape[5:])

    return per_query(acc), per_query(m), per_query(l)


def _combine(acc, m, l):
    """Merge partition partials over axis 3 and normalize. Fully masked
    partitions carry m = -1e30 and cancel via exp(-1e30 - m_max) = 0;
    fully masked rows (padded queries) come out finite garbage that
    callers discard."""
    m_max = m.amax(dim=3)
    alpha = torch.exp(m - m_max[:, :, :, None])
    l_tot = (l * alpha).sum(dim=3)
    out = (acc * alpha[..., None]).sum(dim=3)
    return out / l_tot.clamp_min(1e-30)[..., None]


def fused_paged_attention(q, pool, tables, pos, *, window: int = 0,
                          fmt: KVFormat, out_dtype,
                          kv_partitions: Optional[int] = None):
    """One-pass paged decode attention (q: (B, Hq, D); pos: (B,)); same
    masking, dtype policy and output as ``gather_window`` +
    ``decode_attention``. q is scaled by D^-0.5 in fp32, then cast to the
    compute dtype."""
    B, Hq, D = q.shape
    Hkv = pool.k_pool.shape[2]
    G = Hq // Hkv
    qg = (q.reshape(B, 1, Hkv, G, D).to(torch.float32)
          * (D ** -0.5)).to(out_dtype)
    pos = pos.to(torch.int32)
    acc, m, l = _pooled_partials(qg, pos[:, None], pos + 1, pool, tables,
                                 window=window, fmt=fmt,
                                 kv_partitions=kv_partitions)
    out = _combine(acc, m, l)                          # (B, Hkv, 1, G, D)
    return out[:, :, 0].reshape(B, Hq, D).to(q.dtype)


def fused_chunk_attention(q, kseg, vseg, pool, tables, positions, *,
                          window: int = 0, fmt: KVFormat, out_dtype,
                          kv_partitions: Optional[int] = None):
    """One-pass paged attention for a (B, C) chunk: the pooled window in the
    kernel (entries at positions >= the chunk start masked), plus the
    chunk's own K/V (after the same quantize round-trip as its stored copy)
    as one extra partition merged in the combine. Rows with
    ``positions < 0`` are garbage that callers discard."""
    B, C, Hq, D = q.shape
    Hkv = kseg.shape[2]
    G = Hq // Hkv
    qg = (q.reshape(B, C, Hkv, G, D).to(torch.float32)
          * (D ** -0.5)).to(out_dtype)
    positions = positions.to(torch.int32)
    acc, m, l = _pooled_partials(qg, positions, positions[:, 0], pool,
                                 tables, window=window, fmt=fmt,
                                 kv_partitions=kv_partitions)

    ks = kseg.to(out_dtype)
    vs = vseg.to(out_dtype)
    s = torch.einsum("bchgd,bwhd->bhcgw", qg.to(torch.float32),
                     ks.to(torch.float32))               # (B,Hkv,C,G,C)
    kpos = positions[:, None, None, None, :]
    qpos = positions[:, None, :, None, None]
    valid = (kpos >= 0) & (kpos <= qpos)
    if window:
        valid = valid & (kpos > qpos - window)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m_seg = s.amax(dim=-1)
    pexp = torch.exp(s - m_seg[..., None])
    l_seg = pexp.sum(dim=-1)
    acc_seg = torch.einsum("bhcgw,bwhd->bhcgd",
                           pexp.to(vs.dtype).to(torch.float32),
                           vs.to(torch.float32))

    acc = torch.cat([acc, acc_seg[:, :, :, None]], dim=3)
    m = torch.cat([m, m_seg[:, :, :, None]], dim=3)
    l = torch.cat([l, l_seg[:, :, :, None]], dim=3)
    out = _combine(acc, m, l)                          # (B, Hkv, C, G, D)
    out = out.permute(0, 2, 1, 3, 4).reshape(B, C, Hq, D)
    return out.to(q.dtype)
