"""Flash attention: causal / sliding-window / non-causal GQA attention over
(B, S, H, D) tensors, the sequence-mode attention of training.

Port of ``repro/kernels/flash_attention.py``. On a CUDA tensor
:func:`flash_attention_forward` launches the hand-written Hopper kernel
``csrc/flash_attention.cu`` (see the note at the top of that file); on a
CPU tensor it runs :func:`flash_attention_plain`. Both return the output
and the per-row log-sum-exp ``lse`` (B, Hq, Sq) fp32.

:func:`flash_attention` is the differentiable entry point, the
:class:`FlashAttention` autograd Function: its forward is the wrapper
above; its backward (:func:`flash_attention_backward`) is PyTorch tensor
code, the same on CPU and card, that recomputes P from ``lse`` tile by
tile. The JAX package has no backward kernel (``jax.grad`` through its
Pallas kernel raises in ``_pallas_call_jvp_rule``), so its trainer
differentiates ``chunked_attention``; the backward here computes that same
real-valued gradient.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import MAX_SMEM, align128

NEG_INF = -1e30
# head dims the kernel is built for (one instantiation each)
HEAD_DIMS = (32, 64, 80, 96, 128)
BLOCK_Q, BLOCK_K = 128, 64      # query rows a block (8 warps), keys a tile
# largest score-shaped fp32 tensor the backward (and the plain forward)
# holds at once: ~138 MB per tensor at danube width (2 x 8192, window 4096),
# two of them live, so about 0.3 GB of transient memory per tile
TILE_ELEMS = 48 << 20
# dtype codes of the C launcher
_DTYPES = {torch.bfloat16: 0, torch.float32: 2}

FLASH_ATTENTION = build.CudaKernel(
    "flash_attention", "flash_attention.cu", "flash_attention_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 8
    + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])


@dataclass(frozen=True)
class FlashGeometry:
    """How ``csrc/flash_attention.cu`` lays out one block: ``stages`` K/V
    tiles in the cp.async ring, ``smem`` bytes of shared memory, and
    ``blocks`` in the grid (one per (b, query head, BLOCK_Q-row tile))."""
    stages: int
    smem: int
    blocks: int


def flash_geometry(B: int, Sq: int, Hq: int, D: int,
                   dtype: torch.dtype) -> FlashGeometry:
    """The kernel's launch for these shapes; raises ValueError for a head
    dim or dtype it is not built for. The shared memory is the kernel's
    ``layout`` byte for byte: the Q tile, then ``stages`` (K, V) tiles of
    rows padded by 16 bytes (8 elements; fp32 by 4). Three stages where
    two blocks still fit on an SM (bf16, D <= 96), else two."""
    if dtype not in _DTYPES:
        raise ValueError(f"the flash-attention kernel takes bf16 or fp32 q, "
                         f"k, v; got {dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the flash-attention kernel needs head_dim a "
                         f"multiple of 16 and at most {max(HEAD_DIMS)} that "
                         f"it is built for {HEAD_DIMS}, got {D}")
    elem = torch.finfo(dtype).bits // 8
    ld = D + (4 if elem == 4 else 8)
    stages = 3 if elem == 2 and D <= 96 else 2
    smem = align128(elem * BLOCK_Q * ld) \
        + stages * 2 * align128(elem * BLOCK_K * ld)
    blocks = -(-Sq // BLOCK_Q) * B * Hq
    if smem > MAX_SMEM or blocks >= 2 ** 31:
        raise ValueError(f"the flash-attention kernel cannot take D={D} "
                         f"over {blocks} blocks ({smem} B of shared memory)")
    return FlashGeometry(stages, smem, blocks)


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(B, Sq, Hq, D), (B, Skv, Hkv, D) twice, Hq a multiple of Hkv."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash attention takes q (B, Sq, Hq, D) and k, v "
                         f"(B, Skv, Hkv, D); got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"Hq={q.shape[2]} is not a multiple of "
                         f"Hkv={k.shape[2]}")


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32, or fp64 for fp64 inputs (the gradient checks)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _mask(i0: int, i1: int, j0: int, j1: int, *, causal: bool, window: int,
          device) -> torch.Tensor:
    """(i1-i0, j1-j0) bool: key j visible to query i (keys are < Skv)."""
    qpos = torch.arange(i0, i1, device=device)[:, None]
    kpos = torch.arange(j0, j1, device=device)[None, :]
    ok = torch.ones((i1 - i0, j1 - j0), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window:
        ok = ok & (kpos > qpos - window)
    return ok


def _kv_range(i0: int, i1: int, Skv: int, *, causal: bool,
              window: int):
    """The keys any query row in [i0, i1) can see."""
    j0 = max(0, i0 - window + 1) if window else 0
    j1 = min(Skv, i1) if causal else Skv
    return j0, max(j0, j1)


def _row_tile(rows_times_heads: int, Sq: int, Skv: int, *, causal: bool,
              window: int, full_kv: bool) -> int:
    """Query rows per tile (a power of two, at most 1024) whose score
    tensor stays within ``TILE_ELEMS``."""
    n = 1024
    while n > 1:
        span = min(Skv, n + window - 1) if causal and window \
            and not full_kv else Skv
        if rows_times_heads * n * span <= TILE_ELEMS:
            break
        n //= 2
    return max(1, min(n, Sq))


def _heads_first(x: torch.Tensor, Hkv: int, cdt) -> torch.Tensor:
    """(B, n, Hq, D) → (B, Hkv, G·n, D) in ``cdt``: the G query heads of
    each KV head stacked along the rows."""
    B, n, Hq, D = x.shape
    G = Hq // Hkv
    return x.to(cdt).reshape(B, n, Hkv, G, D).permute(0, 2, 3, 1, 4) \
        .reshape(B, Hkv, G * n, D)


def _heads_last(x: torch.Tensor, Hq: int) -> torch.Tensor:
    """Inverse of :func:`_heads_first`: (B, Hkv, G·n, D) → (B, n, Hq, D)."""
    B, Hkv, Gn, D = x.shape
    G = Hq // Hkv
    n = Gn // G
    return x.reshape(B, Hkv, G, n, D).permute(0, 3, 1, 2, 4) \
        .reshape(B, n, Hq, D)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0):
    """The plain PyTorch version of the kernel: one full softmax per query
    row in the kernel's rounding order (fp32 scores ``(q·kᵀ)·D^-0.5``,
    masked to -1e30; ``p`` rounded to v's dtype before an fp32 PV sum;
    ``acc / max(l, 1e-30)`` cast to q's dtype). Query rows are taken in
    tiles so the score tensor stays bounded. Returns ``(o, lse)``."""
    _check_shapes(q, k, v)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    cdt = _compute_dtype(q.dtype)
    scale = D ** -0.5
    kf = k.to(cdt).permute(0, 2, 1, 3)                    # (B, Hkv, Skv, D)
    vf = v.to(cdt).permute(0, 2, 1, 3)
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=cdt, device=q.device)
    n = _row_tile(B * Hq, Sq, Skv, causal=causal, window=window,
                  full_kv=True)
    for i0 in range(0, Sq, n):
        i1 = min(Sq, i0 + n)
        s = torch.matmul(_heads_first(q[:, i0:i1], Hkv, cdt),
                         kf.transpose(-1, -2)) * scale   # (B, Hkv, G·n, Skv)
        ok = _mask(i0, i1, 0, Skv, causal=causal, window=window,
                   device=q.device).repeat(G, 1)
        s = s.masked_fill(~ok, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        pv = torch.matmul(p.to(v.dtype).to(cdt), vf)
        o[:, i0:i1] = _heads_last(pv / l.clamp_min(1e-30), Hq).to(q.dtype)
        lse[:, :, i0:i1] = (m + torch.log(l)).reshape(B, Hq, i1 - i0)
    return o, lse


def _launch(q, k, v, *, causal: bool, window: int):
    """The kernel on CUDA operands; raises on anything it cannot take."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the flash-attention kernel takes bf16 or fp32 q, "
                         f"k, v of one dtype; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    geo = flash_geometry(B, Sq, Hq, D, q.dtype)
    align = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(3) != 1 or any(s % align for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous last dim and "
                             f"16-byte aligned rows, got strides "
                             f"{t.stride()}")
    o = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    if Sq == 0:
        return o, lse
    FLASH_ATTENTION.launch(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(o),
        build.ptr(lse), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        B, Sq, Skv, Hq, Hkv, D, int(causal), int(window),
        ctypes.c_float(D ** -0.5), _DTYPES[q.dtype], geo.stages, geo.smem,
        build.stream_ptr(q.device))
    return o, lse


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0):
    """``(o, lse)``: the kernel on a CUDA tensor, the plain version on a
    CPU tensor. q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D)."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    return _launch(q, k, v, causal=causal, window=window)


def flash_attention_backward(q, k, v, o, lse, do, *, causal: bool,
                             window: int):
    """``(dq, dk, dv)`` of the attention output against ``do``, from the
    forward's ``o`` and ``lse``. Per query tile (at most 1024 rows, all
    heads) and only the key range it can see: ``P = exp(S·scale - lse)``
    (masked entries 0), ``Di = Σ dO∘O``, ``dP = dO·Vᵀ``, ``dS = P∘(dP -
    Di)``, ``dQ = dS·K·scale``, ``dK = dSᵀ·Q·scale``, ``dV = Pᵀ·dO``, dK
    and dV summed over each KV head's G query heads. Every product takes
    fp32 inputs (fp64 for fp64 inputs) with TF32 off."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    cdt = _compute_dtype(q.dtype)
    scale = D ** -0.5
    kf = k.to(cdt).permute(0, 2, 1, 3)                    # (B, Hkv, Skv, D)
    vf = v.to(cdt).permute(0, 2, 1, 3)
    di = (do.to(cdt) * o.to(cdt)).sum(dim=-1)             # (B, Sq, Hq)
    dq = torch.empty((B, Sq, Hq, D), dtype=cdt, device=q.device)
    dk = torch.zeros((B, Hkv, Skv, D), dtype=cdt, device=q.device)
    dv = torch.zeros_like(dk)
    n = _row_tile(B * Hq, Sq, Skv, causal=causal, window=window,
                  full_kv=False)
    for i0 in range(0, Sq, n):
        i1 = min(Sq, i0 + n)
        j0, j1 = _kv_range(i0, i1, Skv, causal=causal, window=window)
        qt = _heads_first(q[:, i0:i1], Hkv, cdt)          # (B, Hkv, G·n, D)
        dot = _heads_first(do[:, i0:i1], Hkv, cdt)
        kt, vt = kf[:, :, j0:j1], vf[:, :, j0:j1]
        lse_t = lse[:, :, i0:i1].to(cdt).reshape(B, Hkv, -1, 1)
        di_t = di[:, i0:i1].permute(0, 2, 1).reshape(B, Hkv, -1, 1)
        ok = _mask(i0, i1, j0, j1, causal=causal, window=window,
                   device=q.device).repeat(G, 1)
        p = torch.matmul(qt, kt.transpose(-1, -2)).mul_(scale).sub_(lse_t)
        p = p.exp_().masked_fill_(~ok, 0.0)               # (B, Hkv, G·n, m)
        ds = torch.matmul(dot, vt.transpose(-1, -2)).sub_(di_t).mul_(p)
        dq[:, i0:i1] = _heads_last(torch.matmul(ds, kt).mul_(scale), Hq)
        dk[:, :, j0:j1] += torch.matmul(ds.transpose(-1, -2), qt) \
            .mul_(scale)
        dv[:, :, j0:j1] += torch.matmul(p.transpose(-1, -2), dot)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the kernel (or, on the CPU, its
    plain version) forward, :func:`flash_attention_backward` backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        o, lse = flash_attention_forward(q, k, v, causal=causal,
                                         window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, o, lse, do, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention output (B, Sq, Hq, D) in q's dtype, differentiable in q,
    k and v."""
    return FlashAttention.apply(q, k, v, causal, int(window))
