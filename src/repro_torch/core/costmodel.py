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

Beside the card's roofline, the JAX package's models of two other chips,
copied term for term under its names (plain arithmetic; the port's
planner and bounds never read them): the paper's Ascend 910 model of its
Alg. 1 (``AscendSpec``: calibrated, not measured — its Split-K speedups
of 1.00–1.78 against the paper's 1.01–1.74 and its W4A16 cap of 1.47×
against the paper's 1.48×), and the TPU v5e rooflines of the JAX
package's kernels. A later benchmark can set them beside the card's
figures; no number of either is the card's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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


# ---------------------------------------------------------------------------
# the JAX package's models of other chips: the paper's Ascend 910 (Alg. 1)
# and the TPU v5e (its kernels' rooflines)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AscendSpec:
    cube_flops: float = 256e12        # FP16 MACs/s aggregate (910)
    bw_gm: float = 1.1e12             # HBM bytes/s
    bw_l2: float = 2.2e12             # on-chip L2 path (vector↔cube)
    num_cores: int = 32               # AI cores (1 cube + 2 vector each)
    bw_sat_cores: int = 10            # cores that saturate GM bandwidth:
                                      # why Split-K wins at K ≫ N, small M
    launch_s: float = 3e-6            # kernel launch + sync
    block_m: int = 128
    block_n: int = 256
    block_k: int = 256


@dataclasses.dataclass(frozen=True)
class TPUv5eSpec:
    flops: float = 197e12             # bf16 FLOP/s per chip
    hbm_bw: float = 819e9             # bytes/s per chip
    ici_bw: float = 50e9              # bytes/s per link
    vmem_bytes: int = 128 * 2 ** 20


ASCEND = AscendSpec()
TPU_V5E = TPUv5eSpec()


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _wave_efficiency(tiles: int, cores: int) -> float:
    """Cube-core use under wave quantization: the last wave may be part
    full (the effect behind the paper's Fig. 2)."""
    if tiles >= cores:
        waves = _ceil_div(tiles, cores)
        return tiles / (waves * cores)
    return tiles / cores


def gemm_time_ascend(M: int, N: int, K: int, *, split_k: int = 1,
                     weight_bytes_per_elt: float = 2.0,
                     weight_bw: Optional[float] = None,
                     spec: AscendSpec = ASCEND) -> float:
    """One tiled GEMM phase on the Ascend 910 (data-parallel at split_k
    1). ``weight_bytes_per_elt`` / ``weight_bw``: where B comes from (GM
    fp16: 2.0 at bw_gm; GM int4: 0.5 at bw_gm; the L2-resident dequant
    workspace: 2.0 at bw_l2)."""
    weight_bw = weight_bw or spec.bw_gm
    m, n = spec.block_m, spec.block_n
    tiles = _ceil_div(M, m) * _ceil_div(N, n) * split_k
    eff = _wave_efficiency(tiles, spec.num_cores)
    t_compute = (2 * M * N * K) / (spec.cube_flops * eff)
    # bandwidth grows with the active cores until saturation
    bw_frac = min(1.0, min(tiles, spec.num_cores) / spec.bw_sat_cores)
    # A re-read per N-tile wave; B re-read per M-tile (M small: once)
    a_traffic = 2 * M * K * max(1, _ceil_div(N, n * spec.num_cores))
    b_traffic = weight_bytes_per_elt * K * N * _ceil_div(M, m)
    c_traffic = (4 if split_k > 1 else 2) * M * N * split_k
    t_mem = (a_traffic / spec.bw_gm + b_traffic / weight_bw
             + c_traffic / spec.bw_gm) / bw_frac
    return max(t_compute, t_mem) + spec.launch_s


def w4a16_time_ascend(M: int, N: int, K: int, *, split_k: int = 1,
                      spec: AscendSpec = ASCEND) -> float:
    """The paper's three-phase W4A16 pipeline (Alg. 1): INT4 from GM to
    an FP16 workspace over the L2 path (the round trip the decoupled
    architecture pays), the Split-K GEMM from that workspace, the
    reduction of the S partials."""
    t1 = (0.5 * K * N) / spec.bw_gm + (2 * K * N) / spec.bw_l2 \
        + spec.launch_s
    t2 = gemm_time_ascend(M, N, K, split_k=split_k,
                          weight_bytes_per_elt=2.0, weight_bw=spec.bw_l2,
                          spec=spec)
    t3 = 0.0
    if split_k > 1:
        t3 = (4 * M * N * split_k + 2 * M * N) / spec.bw_gm + spec.launch_s
    return t1 + t2 + t3


def fp16_time_ascend(M: int, N: int, K: int,
                     spec: AscendSpec = ASCEND) -> float:
    """Native FP16×FP16 (the paper's PyTorch baseline): data-parallel,
    FP16 weights from GM."""
    return gemm_time_ascend(M, N, K, split_k=1,
                            weight_bytes_per_elt=2.0, weight_bw=spec.bw_gm,
                            spec=spec)


def best_split_k_ascend(M: int, N: int, K: int,
                        spec: AscendSpec = ASCEND) -> int:
    best, best_t = 1, float("inf")
    for s in (1, 2, 4, 8, 16):
        if K % s:
            continue
        t = w4a16_time_ascend(M, N, K, split_k=s, spec=spec)
        if t < best_t:
            best, best_t = s, t
    return best


def splitk_speedup_ascend(M: int, N: int, K: int,
                          spec: AscendSpec = ASCEND) -> float:
    """The paper's Fig. 2: best Split-K W4A16 against data-parallel."""
    t_dp = w4a16_time_ascend(M, N, K, split_k=1, spec=spec)
    t_sk = w4a16_time_ascend(
        M, N, K, split_k=best_split_k_ascend(M, N, K, spec), spec=spec)
    return t_dp / t_sk


def w4a16_speedup_ascend(M: int, N: int, K: int,
                         spec: AscendSpec = ASCEND) -> float:
    """The paper's Fig. 3: best-split W4A16 against native FP16."""
    s = best_split_k_ascend(M, N, K, spec)
    return fp16_time_ascend(M, N, K, spec) / \
        w4a16_time_ascend(M, N, K, split_k=s, spec=spec)


def w4a16_time_tpu_fused(M: int, N: int, K: int,
                         spec: TPUv5eSpec = TPU_V5E) -> float:
    """The fused kernel on the TPU: INT4 weights cross HBM once, the
    dequant stays in VMEM."""
    traffic = 2 * M * K + 0.5 * K * N + 2 * M * N
    return max((2 * M * N * K) / spec.flops, traffic / spec.hbm_bw)


def w4a16_time_tpu_decoupled(M: int, N: int, K: int, *, split_k: int = 1,
                             spec: TPUv5eSpec = TPU_V5E) -> float:
    """The paper's pipeline on the TPU: the workspace round-trips through
    HBM (no L2 shared between kernels)."""
    t1 = (0.5 * K * N + 2 * K * N) / spec.hbm_bw
    t2 = max((2 * M * N * K) / spec.flops,
             (2 * M * K + 2 * K * N + 4 * M * N * split_k) / spec.hbm_bw)
    t3 = (4 * M * N * split_k + 2 * M * N) / spec.hbm_bw if split_k > 1 \
        else 0
    return t1 + t2 + t3


def fp16_time_tpu(M: int, N: int, K: int,
                  spec: TPUv5eSpec = TPU_V5E) -> float:
    traffic = 2 * M * K + 2 * K * N + 2 * M * N
    return max((2 * M * N * K) / spec.flops, traffic / spec.hbm_bw)


def w8a16_time_tpu_fused(M: int, N: int, K: int,
                         spec: TPUv5eSpec = TPU_V5E) -> float:
    """Fused per-channel INT8 on the TPU: int8 weights (K·N bytes) and
    one fp32 scale row cross HBM once."""
    traffic = 2 * M * K + 1.0 * K * N + 4 * N + 2 * M * N
    return max((2 * M * N * K) / spec.flops, traffic / spec.hbm_bw)


def w4a8_time_tpu_fused(M: int, N: int, K: int, *, group: int = 128,
                        spec: TPUv5eSpec = TPU_V5E) -> float:
    """Fused W4A8 on the TPU: int8 activations, packed int4 weights and
    fp32 group scales; int8 dots at twice the bf16 rate."""
    traffic = M * K + 0.5 * K * N + 4.0 * K * N / max(group, 1) + 2 * M * N
    return max((2 * M * N * K) / (2 * spec.flops), traffic / spec.hbm_bw)


def _tpu_attn_bytes(path: str, B: int, Hq: int, Hkv: int, D: int,
                    ctx: int, *, quantized: bool, act_bytes: int,
                    kv_partitions: int, q_len: int) -> float:
    """The JAX package's bytes of one attention step (its
    ``paged_attn_bytes``: no position tags, partials written and read)."""
    q_out = 2 * B * q_len * Hq * D * act_bytes
    window = B * ctx
    dense_tok = 2 * act_bytes * Hkv * D
    seg = 2 * B * q_len * dense_tok if q_len > 1 else 0
    if path == "ring":
        return window * dense_tok + q_out
    payload = 1 if quantized else act_bytes
    per_tok = 2 * payload * Hkv * D + (2 * 4 * Hkv if quantized else 0)
    pool = window * per_tok
    if path == "gather":
        return pool + 2 * window * dense_tok + seg + q_out
    if path == "fused":
        partials = kv_partitions * B * q_len * Hq * (D + 2) * 4 * 2
        return pool + seg + q_out + partials
    raise ValueError(f"unknown attention path {path!r} "
                     "(expected ring | gather | fused)")


def attn_decode_time_tpu(path: str, B: int, Hq: int, Hkv: int, D: int,
                         ctx: int, *, quantized: bool, act_bytes: int = 2,
                         kv_partitions: int = 1, q_len: int = 1,
                         spec: TPUv5eSpec = TPU_V5E) -> float:
    """The TPU's roofline time of one attention step of ``q_len``
    queries a row on ``path``."""
    flops = 4 * B * q_len * Hq * D * ctx
    return max(flops / spec.flops, _tpu_attn_bytes(
        path, B, Hq, Hkv, D, ctx, quantized=quantized, act_bytes=act_bytes,
        kv_partitions=kv_partitions, q_len=q_len) / spec.hbm_bw)
