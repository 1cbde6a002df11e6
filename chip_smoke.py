#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero without one (and when run outside the
repository, where ``src/repro_torch`` is missing). Phases, one line each
(or one line per case):

1. device  — card name and power limit (nvidia-smi).
2. build   — both CUDA kernels compiled from ``src/repro_torch/csrc`` with
             one nvcc per source, started together.
3. kernels — each kernel against its plain PyTorch version on the card at
             the serving path's shapes, bf16, with the tolerance stated;
             the GEMM also in fp32 (the reduced configurations' dtype).
4. serve   — the port's main path through its launcher
             (``repro_torch.launch.serve``): h2o-danube-1.8b at full width
             (24 layers, d_model 2560, 32/8 heads of 80, d_ff 6912, vocab
             32000, bf16), random weights from seed 0 quantized to
             w4a16_g128, 8 requests of 512 prompt + 32 generated tokens,
             8 slots, 8-token pages, 32-token prefill chunks, kv_fp16. Both
             kernels' launch counters must rise during that run. The same
             requests then run on the plain paths (``--strategy reference
             --attn-path gather``) to compare prefill logits and tokens.
5. timing  — CUDA-event medians of each kernel, its plain version and one
             PyTorch library call for the same function, with the L2 cache
             flushed before every launch (the serving step reads every
             layer's weights and KV cold) and the host queued ahead of the
             card (device time only), beside the H100 roofline bound of
             ``repro_torch.core.costmodel``.
6. trace   — the main path once more, stepped through the engine's
             stepper API: a prefill window and a decode window under
             ``torch.profiler`` (device busy time per step, the kernels and
             host ops that cost the most), and untraced steps of each kind
             timed to a sync, so the idle share is read against host time
             the profiler did not slow.

The line before the last two is the kernels' JSON record; the line before
the last is the card's name and power limit; the last line is the
contract's JSON object.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

ARCH = "h2o-danube-1.8b"
GEN = 32
SERVE_ARGV = ["--arch", ARCH, "--batch", "8", "--requests", "8",
              "--prompt-len", "512", "--gen", str(GEN), "--kv-format",
              "kv_fp16", "--seed", "0"]
# (K, N) of one danube layer's quantized GEMMs in step order: wq, wk, wv,
# wo, w_gate, w_up, w_down
LAYER_GEMMS = [(2560, 2560), (2560, 640), (2560, 640), (2560, 2560),
               (2560, 6912), (2560, 6912), (6912, 2560)]
DANUBE_GEMMS = sorted(set(LAYER_GEMMS))
HKV, G, D, PAGE, PAGES = 8, 4, 80, 8, 68      # 68 pages = 544-token window
GEMM_TOL = "|d| <= 2^-7*|plain| + 1e-3"
GEMM_F32_TOL = "|d| <= 1e-5*|plain| + 1e-4"
ATTN_TOL = "|d| <= 2^-7*|plain| + 2e-3; m within 1e-4*(1+|m|), l within " \
    "1e-3*l where the partition has a live key, the same partitions masked"
LOGIT_TOL = 0.25


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs at the main path's shapes
# ---------------------------------------------------------------------------

def gemm_case(torch, K, N, M, gen, dev):
    from repro_torch.core.quant import quantize
    w = torch.randn(K, N, generator=gen, device=dev) * K ** -0.5
    qt = quantize(w.to(torch.bfloat16), out_dtype=torch.bfloat16)
    x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
    return x, qt


def planned_split(x, qt):
    from repro_torch.kernels import planning
    return planning.plan_matmul(planning.MatmulProblem.from_operands(x, qt),
                                use_cache=False).split_k


def attn_case(torch, gen, dev, *, fmt_name, kind, null_slot=False):
    """The serving pool at full danube width (545 blocks of 8 tokens, one
    layer) filled with random K/V; per-slot tables of 68 pages; position
    tags for every token a slot holds. Decode: B=8 slots at ragged
    positions around 700 (the 544-token window has wrapped), queries at
    the last position, ``start = pos + 1``. Chunk: B=1, C=32 queries at
    positions 481..512 over a pool holding 0..480."""
    from repro_torch.core.quant import get_kv_format
    from repro_torch.kernels import planning
    from repro_torch.runtime import kvcache as kvc
    B, C = (8, 1) if kind == "decode" else (1, 32)
    ctx_pos = 700 if kind == "decode" else 480
    cache_len = PAGES * PAGE
    fmt = get_kv_format(fmt_name)
    pool = kvc.init_pool(1 + 8 * PAGES, PAGE, HKV, D, torch.bfloat16,
                         fmt_name, device=dev)
    if fmt.quantized:
        for t in (pool.k_pool, pool.v_pool):
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                  device=dev))
        for t in (pool.k_scale, pool.v_scale):
            t.copy_(torch.rand(t.shape, generator=gen, device=dev) / 64)
    else:
        for t in (pool.k_pool, pool.v_pool):
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    tables = (1 + torch.arange(B * PAGES, device=dev, dtype=torch.int32)
              ).reshape(B, PAGES)
    flat_pos = pool.page_pos.view(-1)
    last = []
    for b in range(B):
        hi = ctx_pos - 3 * b
        lo = max(0, hi - cache_len + 1)
        if null_slot and b == B - 1:       # 10 live pages, the rest -1
            hi, lo = 10 * PAGE - 1, 0
            tables[b, 10:] = -1
        p = torch.arange(lo, hi + 1, device=dev)
        off = p % cache_len
        bid = tables[b, off // PAGE].long()
        flat_pos[bid * PAGE + off % PAGE] = p.to(torch.int32)
        last.append(hi)
    last = torch.tensor(last, device=dev, dtype=torch.int32)
    if kind == "decode":
        positions, start = last[:, None].contiguous(), last + 1
    else:
        positions = (last[:, None] + 1 + torch.arange(
            C, device=dev, dtype=torch.int32)).contiguous()
        start = positions[:, 0].contiguous()
    q = torch.randn(B, C, HKV * G, D, generator=gen, device=dev)
    qg = (q.reshape(B, C, HKV, G, D) * D ** -0.5).to(torch.bfloat16)
    Tq = planning.choose_q_block(C, G)
    qk = qg.permute(0, 2, 1, 3, 4).reshape(B, HKV, C // Tq, Tq * G, D) \
        .contiguous()
    planned = planning.choose_kv_partitions(
        B, HKV, PAGES, q_tiles=C // Tq, cores=planning.num_cores("cuda"))
    return dict(qk=qk, q=q.to(torch.bfloat16), positions=positions,
                start=start, pool=pool, tables=tables, fmt=fmt, Tq=Tq,
                planned=planned, B=B, C=C)


def combine(torch, acc, m, l):
    """Merge raw (B, Hkv, QT, S, QG, ·) partials over S and normalize."""
    alpha = torch.exp(m - m.amax(dim=3, keepdim=True))
    l_tot = (l * alpha).sum(dim=3)
    out = (acc * alpha[..., None]).sum(dim=3)
    return out / l_tot.clamp_min(1e-30)[..., None]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_gemm(torch, dev, gen):
    """W4A16 kernel vs its plain version. Both round the dequantized tile
    to bf16 and accumulate exact bf16 products in fp32; they differ only
    in fp32 summation order, after which the bf16 output can round either
    way: tolerance one bf16 ulp, |d| <= 2^-7·|plain| + 1e-3."""
    from repro_torch.kernels.w4a16_fused import (w4a16_fused,
                                                 w4a16_fused_plain)
    worst = 0.0
    for K, N in DANUBE_GEMMS:
        for M in (8, 32):
            x, qt = gemm_case(torch, K, N, M, gen, dev)
            for s in sorted({planned_split(x, qt), 1}):
                got = w4a16_fused(x, qt, split_k=s).float()
                want = w4a16_fused_plain(x, qt, split_k=s).float()
                err = (got - want).abs()
                bad = bool((err > want.abs() * 2 ** -7 + 1e-3).any())
                worst = max(worst, float(err.max()))
                log("kernels", f"w4a16_gemm M={M} K={K} N={N} split_k={s} "
                    f"max|d|={float(err.max()):.3e} "
                    f"{'FAIL' if bad else 'ok'} ({GEMM_TOL})")
                if bad:
                    raise AssertionError(f"w4a16_gemm disagrees at M={M} "
                                         f"K={K} N={N} split_k={s}")
    return worst


def check_gemm_fp32(torch, dev, gen):
    """The kernel's fp32 variant (CUDA-core FMA) vs its plain version at
    one danube shape: the same fp32 products summed in another order, so
    fp32 rounding only."""
    from repro_torch.core.quant import quantize
    from repro_torch.kernels.w4a16_fused import (w4a16_fused,
                                                 w4a16_fused_plain)
    K, N = 2560, 640
    w = torch.randn(K, N, generator=gen, device=dev) * K ** -0.5
    qt = quantize(w)
    for M in (8, 32):
        x = torch.randn(M, K, generator=gen, device=dev)
        for s in sorted({planned_split(x, qt), 1}):
            got = w4a16_fused(x, qt, split_k=s)
            want = w4a16_fused_plain(x, qt, split_k=s)
            err = (got - want).abs()
            bad = got.dtype != torch.float32 or bool(
                (err > want.abs() * 1e-5 + 1e-4).any())
            log("kernels", f"w4a16_gemm fp32 M={M} K={K} N={N} split_k={s} "
                f"max|d|={float(err.max()):.3e} "
                f"{'FAIL' if bad else 'ok'} ({GEMM_F32_TOL})")
            if bad:
                raise AssertionError(f"w4a16_gemm fp32 disagrees at M={M} "
                                     f"split_k={s}")


def check_attention(torch, dev, gen):
    """Paged-attention kernel vs its plain version: decode (B=8) and chunk
    (B=1, C=32), both KV formats, the model's 4096 window and a 100-token
    window that masks, kv_partitions 1 and the planner's pick, a slot with
    -1 table entries. Both round dequantized K/V and the softmax weights to
    bf16 and accumulate in fp32; exp and summation order differ, so a
    weight may round to the neighbouring bf16 value (2^-8 of it). The
    combined outputs are softmax averages over hundreds of keys, about
    0.05 in size, not unit scale: they are held to |d| <= 2^-7·|plain| +
    2e-3 (the worst error measured on the H100 is 1.44e-3; dropping or
    mis-masking one 8-token page moves them by about 1e-2). The raw
    partials are checked too: the same partitions fully masked (m at
    -1e30) on both sides; elsewhere the running max m — an fp32 dot of the
    same bf16 values in another order — within 1e-4·(1 + |m|), and the
    softmax sum l within 1e-3 of itself (one dropped key of a live page
    moves it by more)."""
    from repro_torch.kernels import paged_attention as pa
    worst = 0.0
    for fmt_name in ("kv_fp16", "kv8_channel"):
        for kind in ("decode", "chunk"):
            c = attn_case(torch, gen, dev, fmt_name=fmt_name, kind=kind,
                          null_slot=kind == "decode")
            for window in (4096, 100):
                for parts in sorted({1, c["planned"]}):
                    kw = dict(Tq=c["Tq"], G=G, S=parts, window=window,
                              fmt=c["fmt"])
                    args = (c["qk"], c["positions"], c["start"], c["pool"],
                            c["tables"])
                    got = pa._launch_partials(*args, **kw)
                    want = pa.pooled_partials_plain(*args, **kw)
                    out_p = combine(torch, *want)
                    d = (combine(torch, *got) - out_p).abs()
                    err = float(d.max())
                    worst = max(worst, err)
                    (_, m_k, l_k), (_, m_p, l_p) = got, want
                    live = m_p > -1e29
                    dm = ((m_k - m_p).abs() / (1 + m_p.abs()))[live]
                    dl = ((l_k - l_p).abs() / l_p)[live]
                    dm_max = float(dm.max()) if dm.numel() else 0.0
                    dl_max = float(dl.max()) if dl.numel() else 0.0
                    bad = bool((d > out_p.abs() * 2 ** -7 + 2e-3).any()
                               or (live != (m_k > -1e29)).any()
                               or dm_max > 1e-4 or dl_max > 1e-3)
                    log("kernels", f"paged_attention {kind} B={c['B']} "
                        f"C={c['C']} {fmt_name} window={window} "
                        f"kv_partitions={parts} max|d|={err:.3e} "
                        f"(max|out| {float(out_p.abs().max()):.3f}) "
                        f"max|dm|/(1+|m|)={dm_max:.2e} "
                        f"max|dl|/l={dl_max:.2e} live partitions "
                        f"{int(live.sum())}/{live.numel()} "
                        f"{'FAIL' if bad else 'ok'} ({ATTN_TOL})")
                    if bad:
                        raise AssertionError(
                            f"paged_attention disagrees: {kind} {fmt_name} "
                            f"window={window} kv_partitions={parts}")
    return worst


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------

def serve(torch, extra, card):
    from repro_torch.launch import serve as launcher
    argv = SERVE_ARGV + extra
    log("serve", "python -m repro_torch.launch.serve " + " ".join(argv))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = launcher.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = max(len(report.step_records), 1)
    log("serve", f"{report.decode_tokens} decode tokens in "
        f"{report.decode_s:.3f} s = {report.tokens_per_s:.1f} tok/s, "
        f"{report.decode_s / steps * 1e3:.2f} ms/step over {steps} decode "
        f"steps; prefill {report.prefill_s:.3f} s; run {wall:.1f} s; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB [{card}]")
    return report


def check_serve(torch, card):
    from repro_torch.kernels.paged_attention import PAGED_ATTENTION
    from repro_torch.kernels.w4a16_fused import W4A16_GEMM
    W4A16_GEMM.launches = 0
    PAGED_ATTENTION.launches = 0
    fused = serve(torch, [], card)
    launches = {"w4a16_gemm": W4A16_GEMM.launches,
                "paged_attention": PAGED_ATTENTION.launches}
    log("serve", f"launches during the run: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    torch.cuda.empty_cache()
    plain = serve(torch, ["--strategy", "reference", "--attn-path",
                          "gather"], card)
    d = max(float((fused.prefill_logits[r] - plain.prefill_logits[r])
                  .abs().max()) for r in fused.results)
    scale = max(float(plain.prefill_logits[r].abs().max())
                for r in plain.results)
    toks = [(a == b) for r in fused.results
            for a, b in zip(fused.results[r], plain.results[r])]
    firsts = sum(fused.results[r][0] == plain.results[r][0]
                 for r in fused.results)
    # where the first tokens differ, how far the kernel path's pick sits
    # below the plain path's best logit (random weights give flat logits)
    gaps = [float(plain.prefill_logits[r].max()
                  - plain.prefill_logits[r][fused.results[r][0]])
            for r in fused.results
            if fused.results[r][0] != plain.results[r][0]]
    ok = d <= LOGIT_TOL
    log("serve", f"prefill logits kernels vs plain: max|d|={d:.3e} "
        f"(max|logit| {scale:.2f}; tolerance {LOGIT_TOL}: bf16 rounding "
        f"of every activation, reordered sums, 24 layers) "
        f"{'ok' if ok else 'FAIL'}; greedy tokens equal "
        f"{sum(toks)}/{len(toks)} ({sum(toks) / len(toks):.1%}), first "
        f"tokens {firsts}/{len(fused.results)}, plain-path logit gap of "
        f"each differing first token {[f'{g:.3e}' for g in gaps]}")
    if not ok:
        raise AssertionError("prefill logits disagree between the kernel "
                             "path and the plain path")
    for rid, out in fused.results.items():
        if len(out) != GEN:
            raise AssertionError(f"request {rid} produced {len(out)} tokens")
    return fused, plain, launches


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------

class Timer:
    """Median CUDA-event time of ``fn`` with the L2 flushed before each
    launch (a 256 MB buffer is zeroed, five times the 50 MB L2). A wrapper
    issues several device ops (kernel, Split-K sum, cast); if the host
    issued them while the card waited, its launch gaps would land between
    the events. So the card first sleeps ~0.1 s (2e8 cycles) while the host
    queues every timed launch, and the events time the card's work only."""

    def __init__(self, torch, dev, iters=25, warmup=3):
        self.torch, self.iters, self.warmup = torch, iters, warmup
        self.flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(self.warmup):
            self.flush.zero_()
            fn()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(self.iters)]
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        for s, e in ev:
            self.flush.zero_()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        ts = sorted(s.elapsed_time(e) for s, e in ev)
        return ts[len(ts) // 2]


def time_gemms(torch, dev, gen, timer, card):
    from repro_torch.core import costmodel
    from repro_torch.kernels import ref
    from repro_torch.kernels.w4a16_fused import (w4a16_fused,
                                                 w4a16_fused_plain)
    rows = {}
    for M in (8, 32):
        for K, N in DANUBE_GEMMS:
            x, qt = gemm_case(torch, K, N, M, gen, dev)
            s = planned_split(x, qt)
            nbytes = costmodel.w4a16_gemm_bytes(M, N, K)
            flops = costmodel.w4a16_gemm_flops(M, N, K)
            r = dict(nbytes=nbytes, flops=flops,
                     ms=timer(lambda: w4a16_fused(x, qt, split_k=s)),
                     plain_ms=timer(lambda: w4a16_fused_plain(x, qt,
                                                              split_k=s)),
                     library_ms=timer(lambda: ref.w4a16_ref(x, qt)),
                     bound_ms=costmodel.roofline_s(nbytes, flops) * 1e3,
                     bound_by=costmodel.bound_by(nbytes, flops), split_k=s)
            rows[(M, K, N)] = r
            log("timing", f"w4a16_gemm M={M} K={K} N={N} split_k={s}: "
                f"kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}; {r['bound_ms'] / r['ms']:.1%} of "
                f"roofline), plain {r['plain_ms']:.4f} ms, dequant+matmul "
                f"{r['library_ms']:.4f} ms [{card}]")
    return rows


def attn_bytes_flops(torch, c):
    """What the partials function must move for this data: the mapped
    pages' K/V payload (+ scales) and tags, the tables, the queries, the
    fp32 partials; operations: QKᵀ and PV over every key of the mapped
    pages, per query row."""
    from repro_torch.core import costmodel
    tables, fmt, qk = c["tables"], c["fmt"], c["qk"]
    mapped = int((tables >= 0).sum())               # (slot, page) pairs
    per_tok = costmodel.kv_bytes_per_token(HKV, D, quantized=fmt.quantized)
    kv = mapped * PAGE * per_tok
    B, _, QT, QG, _ = qk.shape
    q_in = qk.numel() * qk.element_size() + tables.numel() * 4 \
        + c["positions"].numel() * 4
    parts = c["planned"]
    out = B * HKV * QT * parts * QG * (D + 2) * 4
    flops = 4.0 * mapped * PAGE * QT * QG * D * HKV
    return kv + q_in + out, flops


def time_attention(torch, dev, gen, timer, card):
    import torch.nn.functional as F
    from repro_torch.core import costmodel
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.runtime import kvcache as kvc
    rows = {}
    for kind in ("decode", "chunk"):
        c = attn_case(torch, gen, dev, fmt_name="kv_fp16", kind=kind)
        kw = dict(Tq=c["Tq"], G=G, S=c["planned"], window=4096, fmt=c["fmt"])
        args = (c["qk"], c["positions"], c["start"], c["pool"], c["tables"])
        B, C = c["B"], c["C"]
        q = c["q"].permute(0, 2, 1, 3)                   # (B, Hq, C, D)

        def library():
            win = kvc.gather_window(c["pool"], c["tables"], fmt=c["fmt"],
                                    out_dtype=torch.bfloat16)
            kp, qp = win.pos[:, None, None, :], \
                c["positions"][:, None, :, None]
            mask = (kp >= 0) & (kp <= qp) & (kp < c["start"][:, None, None,
                                                              None]) \
                & (kp > qp - 4096)
            return F.scaled_dot_product_attention(
                q, win.k.permute(0, 2, 1, 3), win.v.permute(0, 2, 1, 3),
                attn_mask=mask, enable_gqa=True)

        nbytes, flops = attn_bytes_flops(torch, c)
        r = dict(ms=timer(lambda: pa._launch_partials(*args, **kw)),
                 plain_ms=timer(lambda: pa.pooled_partials_plain(*args,
                                                                 **kw)),
                 library_ms=timer(library),
                 bound_ms=costmodel.roofline_s(nbytes, flops) * 1e3,
                 bound_by=costmodel.bound_by(nbytes, flops),
                 kv_partitions=c["planned"])
        rows[kind] = r
        log("timing", f"paged_attention {kind} B={B} C={C} kv_fp16 "
            f"kv_partitions={c['planned']}: kernel {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}; "
            f"{r['bound_ms'] / r['ms']:.1%} of roofline), plain "
            f"{r['plain_ms']:.4f} ms, gather+sdpa {r['library_ms']:.4f} ms "
            f"[{card}]")
    return rows


def trace(torch, card):
    """Phase 6: where a step's time goes. The phase-4 traffic once more,
    stepped through the engine's stepper API. Engine steps 0-3 (pure
    prefill: one 32-token chunk for each of 8 slots) run under
    ``torch.profiler``; steps 4-11 (prefill) run untraced, timed to a
    sync; then, after the first decode, 10 untraced decode steps are timed
    and the remaining decode steps are traced. The profiler slows the
    host but not the device, so the idle share is the traced device busy
    time per step against the untraced wall time per step."""
    import contextlib
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve as launcher
    engine, reqs = launcher.build(launcher.build_args(SERVE_ARGV))
    engine.start()
    for r in reqs:
        engine.submit(r)

    def run(n, traced=False):
        """Up to ``n`` engine steps, timed to a sync: (steps, ms/step,
        profiler or None)."""
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) if traced \
            else None
        torch.cuda.synchronize()
        done = 0
        t0 = time.perf_counter()
        with prof or contextlib.nullcontext():
            while done < n and engine.has_work():
                engine.step()
                done += 1
            torch.cuda.synchronize()
        return done, (time.perf_counter() - t0) * 1e3 / max(done, 1), prof

    def report(name, steps, traced_ms, untraced_ms, prof):
        events = prof.key_averages()
        dev = sorted((e for e in events if e.device_type != DeviceType.CPU),
                     key=lambda e: e.self_device_time_total, reverse=True)
        host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                      key=lambda e: e.self_cpu_time_total, reverse=True)
        busy = sum(e.self_device_time_total for e in dev) / 1e3 / steps
        launches = sum(e.count for e in dev) / steps
        log("trace", f"{name}: device busy {busy:.3f} ms/step over {steps} "
            f"traced steps ({launches:.0f} device ops/step); wall "
            f"{untraced_ms:.3f} ms/step untraced ({traced_ms:.3f} traced) "
            f"-> device idle {1 - busy / untraced_ms:.1%} [{card}]")
        for e in dev[:6]:
            log("trace", f"  {name} device "
                f"{e.self_device_time_total / 1e3 / steps:8.3f} ms/step  "
                f"x{e.count / steps:<6.0f} {e.key[:80]}")
        for e in host[:6]:
            log("trace", f"  {name} host   "
                f"{e.self_cpu_time_total / 1e3 / steps:8.3f} ms/step  "
                f"x{e.count / steps:<6.0f} {e.key[:80]}")

    pf_steps, pf_traced, pf_prof = run(4, traced=True)
    _, pf_ms, _ = run(8)
    while engine.report.decode_tokens == 0:
        engine.step()
    _, dec_ms, _ = run(10)
    dec_steps, dec_traced, dec_prof = run(1 << 30, traced=True)
    if dec_steps == 0 or engine.has_work():
        raise AssertionError("the traced decode window did not drain the "
                             "engine")
    report("prefill", pf_steps, pf_traced, pf_ms, pf_prof)
    report("decode", dec_steps, dec_traced, dec_ms, dec_prof)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this test "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.core import costmodel
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import PAGED_ATTENTION
    from repro_torch.kernels.w4a16_fused import W4A16_GEMM

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 matmuls in fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log("device", f"{card} ({torch.cuda.device_count()} visible; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda})")

    t0 = time.perf_counter()
    logs = build.build_all([W4A16_GEMM, PAGED_ATTENTION])
    log("build", f"w4a16_gemm.cu + paged_attention.cu in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")
    for name, text in zip(("w4a16_gemm", "paged_attention"), logs):
        regs = sorted({line.split(":", 1)[1].strip()
                       for line in text.splitlines() if "registers" in line})
        log("build", f"{name}: {'; '.join(regs) or 'cached build'}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    gemm_err = check_gemm(torch, dev, gen)
    check_gemm_fp32(torch, dev, gen)
    attn_err = check_attention(torch, dev, gen)
    torch.cuda.synchronize()

    fused, plain, launches = check_serve(torch, card)

    timer = Timer(torch, dev)
    gemm_rows = time_gemms(torch, dev, gen, timer, card)
    attn_rows = time_attention(torch, dev, gen, timer, card)
    del timer
    torch.cuda.empty_cache()
    trace(torch, card)

    # one entry per kernel: the GEMM entry sums one decode step's seven
    # per-layer GEMMs at M=8 (the set a step repeats in each of 24 layers);
    # the attention entry is one decode call at B=8 over the served window
    def layer_sum(key):
        return sum(gemm_rows[(8, K, N)][key] for K, N in LAYER_GEMMS)

    a = attn_rows["decode"]
    record = {"kernels": [
        {"name": "w4a16_gemm", "route": "cuda",
         "source": "src/repro_torch/csrc/w4a16_gemm.cu",
         "replaces": "src/repro/kernels/w4a16_fused.py:37",
         "launches": launches["w4a16_gemm"], "max_abs_err": gemm_err,
         "ms": layer_sum("ms"), "plain_ms": layer_sum("plain_ms"),
         "bound_ms": layer_sum("bound_ms"),
         "bound_by": costmodel.bound_by(layer_sum("nbytes"),
                                        layer_sum("flops")),
         "library_ms": layer_sum("library_ms")},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:148",
         "launches": launches["paged_attention"], "max_abs_err": attn_err,
         "ms": a["ms"], "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
         "bound_by": a["bound_by"], "library_ms": a["library_ms"]},
    ]}
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
