"""H100 roofline: the planner's cost and the "bound" of every kernel timing.

A kernel's bound is the least time the card could take for the same work:
the larger of (bytes the function must move, each input read once and each
output written once) / memory rate and (operations) / peak rate for their
type. Peaks are NVIDIA's published H100 SXM figures at the 700 W power
limit (see the ``hopper-kernels`` guide): 989 TFLOP/s dense bf16/fp16 and
1,979 TOP/s int8 on the tensor cores, and 3.35 TB/s of HBM3.

Modelled: the GEMM family (fused W4A16, the decoupled three-phase W4A16
pipeline, dense, W8A16, W4A8 — the terms of the JAX package's TPU models
with the H100's rates), paged attention and flash attention.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class H100Spec:
    flops: float = 989e12             # dense bf16/fp16 tensor-core FLOP/s
    int8_ops: float = 1979e12         # dense int8 tensor-core OP/s
    hbm_bw: float = 3.35e12           # HBM3 bytes/s
    num_sms: int = 132


H100 = H100Spec()


def roofline_s(bytes_moved: float, flops: float,
               spec: H100Spec = H100, *, int8: bool = False) -> float:
    """Least time for ``bytes_moved`` and ``flops`` on the card
    (``int8``: the operations run at the int8 tensor-core rate)."""
    rate = spec.int8_ops if int8 else spec.flops
    return max(bytes_moved / spec.hbm_bw, flops / rate)


def bound_by(bytes_moved: float, flops: float,
             spec: H100Spec = H100, *, int8: bool = False) -> str:
    """Which of the two terms sets :func:`roofline_s`."""
    rate = spec.int8_ops if int8 else spec.flops
    return "bytes" if bytes_moved / spec.hbm_bw >= flops / rate \
        else "operations"


# ---------------------------------------------------------------------------
# W4A16 GEMM
# ---------------------------------------------------------------------------

def w4a16_gemm_bytes(M: int, N: int, K: int, *, group: int = 128,
                     act_bytes: int = 2, out_bytes: int = 2,
                     has_zeros: bool = False) -> float:
    """x read once, packed int4 weights (K·N/2), fp32 group scales (and
    zeros) read once, the output written once."""
    scale_rows = K // max(group, 1)
    scales = scale_rows * N * 4 * (2 if has_zeros else 1)
    return M * K * act_bytes + K * N / 2 + scales + M * N * out_bytes


def w4a16_gemm_flops(M: int, N: int, K: int) -> float:
    return 2.0 * M * N * K


def w4a16_time_fused(M: int, N: int, K: int, *, group: int = 128,
                     act_bytes: int = 2, has_zeros: bool = False) -> float:
    """Fused kernel: INT4 weights cross HBM once, dequant stays on chip."""
    return roofline_s(
        w4a16_gemm_bytes(M, N, K, group=group, act_bytes=act_bytes,
                         out_bytes=act_bytes, has_zeros=has_zeros),
        w4a16_gemm_flops(M, N, K))


def w4a16_time_dequant_matmul(M: int, N: int, K: int, *,
                              act_bytes: int = 2) -> float:
    """Plain path: dequantize to a (K, N) float weight in HBM (int4 read +
    float write), then a dense GEMM that reads it back."""
    t_deq = (0.5 * K * N + act_bytes * K * N) / H100.hbm_bw
    t_mm = roofline_s(act_bytes * (M * K + K * N + M * N),
                      w4a16_gemm_flops(M, N, K))
    return t_deq + t_mm


# ---------------------------------------------------------------------------
# the rest of the GEMM family
# ---------------------------------------------------------------------------

def dense_gemm_bytes(M: int, N: int, K: int, *, act_bytes: int = 2,
                     w_bytes: int = 2, out_bytes: int = 2) -> float:
    """x, a dense (K, N) weight, the output: each crosses HBM once."""
    return M * K * act_bytes + K * N * w_bytes + M * N * out_bytes


def dense_time(M: int, N: int, K: int, *, act_bytes: int = 2) -> float:
    """The FP16×FP16 baseline (the paper's PyTorch comparison)."""
    return roofline_s(dense_gemm_bytes(M, N, K, act_bytes=act_bytes,
                                       w_bytes=act_bytes,
                                       out_bytes=act_bytes),
                      w4a16_gemm_flops(M, N, K))


def dequant_w4_bytes(K: int, N: int, *, group: int = 128,
                     act_bytes: int = 2, has_zeros: bool = False) -> float:
    """Decoupled phase 1: packed int4 + group scales in, the (K, N) float
    workspace out."""
    scales = (K // max(group, 1)) * N * 4 * (2 if has_zeros else 1)
    return K * N / 2 + scales + K * N * act_bytes


def reduce_bytes(M: int, N: int, split_k: int, *,
                 out_bytes: int = 2) -> float:
    """Decoupled phase 3: S fp32 partials in, the output out."""
    return 4 * split_k * M * N + M * N * out_bytes


def w4a16_decoupled_phases(M: int, N: int, K: int, *, split_k: int = 1,
                           group: int = 128, act_bytes: int = 2,
                           has_zeros: bool = False):
    """Roofline seconds of the three phases: dequant to the workspace; the
    Split-K GEMM over it (x, the workspace, S fp32 partials written); the
    reduction (partials read, output written). The workspace and the
    partials each cross HBM twice — the paper's round trip. Phase 3 is
    counted at every S because the pipeline always launches it."""
    t1 = dequant_w4_bytes(K, N, group=group, act_bytes=act_bytes,
                          has_zeros=has_zeros) / H100.hbm_bw
    t2 = roofline_s(dense_gemm_bytes(M, N, K, act_bytes=act_bytes,
                                     w_bytes=act_bytes, out_bytes=0)
                    + 4 * split_k * M * N, w4a16_gemm_flops(M, N, K))
    t3 = reduce_bytes(M, N, split_k, out_bytes=act_bytes) / H100.hbm_bw
    return t1, t2, t3


def w4a16_time_decoupled(M: int, N: int, K: int, *, split_k: int = 1,
                         group: int = 128, act_bytes: int = 2,
                         has_zeros: bool = False) -> float:
    return sum(w4a16_decoupled_phases(M, N, K, split_k=split_k, group=group,
                                      act_bytes=act_bytes,
                                      has_zeros=has_zeros))


def w8a16_gemm_bytes(M: int, N: int, K: int, *, act_bytes: int = 2,
                     out_bytes: int = 2, has_zeros: bool = False) -> float:
    """int8 weight rows (K·N bytes) and one fp32 scale row (and zeros)."""
    return M * K * act_bytes + K * N + 4 * N * (2 if has_zeros else 1) \
        + M * N * out_bytes


def w8a16_time_fused(M: int, N: int, K: int, *, act_bytes: int = 2,
                     has_zeros: bool = False) -> float:
    return roofline_s(w8a16_gemm_bytes(M, N, K, act_bytes=act_bytes,
                                       out_bytes=act_bytes,
                                       has_zeros=has_zeros),
                      w4a16_gemm_flops(M, N, K))


def w4a8_gemm_bytes(M: int, N: int, K: int, *, group: int = 128,
                    act_bytes: int = 1, out_bytes: int = 2,
                    has_zeros: bool = False) -> float:
    """Activations (int8 into the kernel; ``act_bytes`` of the float x for
    the whole function, which quantizes them), packed int4 weights, fp32
    group scales (and zeros), the output."""
    return w4a16_gemm_bytes(M, N, K, group=group, act_bytes=act_bytes,
                            out_bytes=out_bytes, has_zeros=has_zeros)


def w4a8_quantize_bytes(M: int, K: int, group: int = 128, *,
                        act_bytes: int = 2) -> float:
    """The W4A8 activation quantize: x in; x_q, the row scales and Σx_q per
    (token, group) out."""
    return M * K * act_bytes + M * K + 4 * M + 4 * M * (K // max(group, 1))


def w4a8_time_fused(M: int, N: int, K: int, *, group: int = 128,
                    has_zeros: bool = False) -> float:
    """int8 activations, int8×int8 tensor-core dots at the int8 rate."""
    return roofline_s(w4a8_gemm_bytes(M, N, K, group=group,
                                      has_zeros=has_zeros),
                      w4a16_gemm_flops(M, N, K), int8=True)


def w4a8_time_plain(M: int, N: int, K: int, *, group: int = 128) -> float:
    """The plain W4A8 path (``w4a8_xla``): as the kernel, plus the
    (M, K/group, N) fp32 group terms written and read back."""
    g = max(group, 1)
    return roofline_s(w4a8_gemm_bytes(M, N, K, group=g)
                      + 8.0 * M * N * (K // g),
                      w4a16_gemm_flops(M, N, K), int8=True)


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------

def kv_bytes_per_token(Hkv: int, D: int, *, quantized: bool,
                       act_bytes: int = 2) -> float:
    """Bytes to read one cached token's K+V across all kv-heads, payload
    plus the fp32 per-(token, head) scale pair of quantized formats and
    the int32 position tag."""
    payload = 1 if quantized else act_bytes
    scales = 2 * 4 * Hkv if quantized else 0
    return 2 * payload * Hkv * D + scales + 4


def paged_attn_bytes(path: str, B: int, Hq: int, Hkv: int, D: int,
                     ctx: int, *, quantized: bool, act_bytes: int = 2,
                     kv_partitions: int = 1, q_len: int = 1) -> float:
    """Bytes one attention step of ``q_len`` queries per row moves over a
    ``ctx``-token window: ``ring`` reads the dense per-slot ring once (it
    stores no quantized format); ``gather`` reads the pool, writes the
    dequantized window and reads it back; ``fused`` reads the pool once
    and writes O(S·q_len) fp32 partials. A multi-query step (q_len > 1)
    also stages the chunk's own K/V segment on the paged paths."""
    q_out = 2 * B * q_len * Hq * D * act_bytes
    window = B * ctx
    dense_tok = 2 * act_bytes * Hkv * D
    seg = 2 * B * q_len * dense_tok if q_len > 1 else 0
    if path == "ring":
        return window * dense_tok + q_out
    pool = window * kv_bytes_per_token(Hkv, D, quantized=quantized,
                                       act_bytes=act_bytes)
    if path == "gather":
        return pool + 2 * window * dense_tok + seg + q_out
    if path == "fused":
        partials = kv_partitions * B * q_len * Hq * (D + 2) * 4
        return pool + seg + q_out + partials
    raise ValueError(f"unknown attention path {path!r} "
                     "(expected ring | gather | fused)")


def paged_attn_flops(B: int, Hq: int, D: int, ctx: int, *,
                     q_len: int = 1) -> float:
    """QKᵀ + PV multiply-adds, as FLOPs."""
    return 4.0 * B * q_len * Hq * D * ctx


def attn_time(path: str, B: int, Hq: int, Hkv: int, D: int, ctx: int, *,
              quantized: bool, act_bytes: int = 2, kv_partitions: int = 1,
              q_len: int = 1) -> float:
    """Roofline time of one attention step on ``path``."""
    return roofline_s(
        paged_attn_bytes(path, B, Hq, Hkv, D, ctx, quantized=quantized,
                         act_bytes=act_bytes, kv_partitions=kv_partitions,
                         q_len=q_len),
        paged_attn_flops(B, Hq, D, ctx, q_len=q_len))


# ---------------------------------------------------------------------------
# flash attention (the training forward)
# ---------------------------------------------------------------------------

def attn_pairs(Sq: int, Skv: int, *, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of the mask (both positions from 0):
    causal keeps k <= q, a window keeps k > q - window."""
    q = np.arange(Sq)
    hi = np.minimum(Skv, q + 1) if causal else np.full(Sq, Skv)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(Sq)
    return int(np.maximum(hi - lo, 0).sum())


def flash_attn_flops(B: int, Hq: int, D: int, pairs: int) -> float:
    """QKᵀ and PV: 4·D FLOP per unmasked pair and query head."""
    return 4.0 * B * Hq * D * pairs


def flash_attn_bytes(B: int, Sq: int, Skv: int, Hq: int, Hkv: int, D: int,
                     *, act_bytes: int = 2) -> float:
    """q, k and v read once, o written once, plus the fp32 log-sum-exp."""
    return act_bytes * D * (2 * B * Sq * Hq + 2 * B * Skv * Hkv) \
        + 4 * B * Hq * Sq
