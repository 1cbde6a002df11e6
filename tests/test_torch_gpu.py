"""Card-only tests of the port's CUDA kernels and engine: each kernel
against its plain PyTorch version, and the engine's kernel path against
its plain path. They skip without a CUDA card. This file imports no JAX
and needs nothing of the JAX package, so on the GPU machine it runs as

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.)
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import quant as tq
from repro_torch.core.tree import tree_flatten_with_keys
from repro_torch.data import SyntheticTokenStream
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import planning
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import w4a8_fused as tw4a8
from repro_torch.kernels import w4a16_decoupled as tdec
from repro_torch.kernels import w4a16_fused as wf
from repro_torch.kernels import w8a16_fused as tw8a16
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import steps as tsteps
from repro_torch.runtime import kvcache as kvc
from repro_torch.runtime.engine import Request, ServingEngine

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs on the GPU machine)")
    return torch.device("cuda")


def test_quantizers_on_the_card_match_the_cpu(cuda_device):
    """Weight, KV and activation quantization give the CPU's bytes (the
    JAX package's, pinned by the CPU tests) on the card too: divisions by
    constants stay IEEE divisions there."""
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.standard_normal((512, 256)).astype(np.float32))
    for fmt in ("w4a16_g128", "w8a16_channel", "w4a8_g128"):
        for symmetric in (True, False):
            a = tq.quantize(w, fmt, symmetric=symmetric)
            b = tq.quantize(w.to(cuda_device), fmt, symmetric=symmetric)
            for x, y in ((a.packed, b.packed), (a.scales, b.scales),
                         (a.zeros, b.zeros)):
                assert (x is None and y is None) or torch.equal(x, y.cpu())
    x = torch.from_numpy(rng.standard_normal((64, 2560)).astype(np.float32))
    for xx in (x, x.bfloat16()):
        for got, want in zip(tq.quantize_activations_int8(xx.to(cuda_device)),
                             tq.quantize_activations_int8(xx)):
            assert torch.equal(got.cpu(), want)
        kv = xx.reshape(64, 32, 80)
        for got, want in zip(tq.kv_quantize(kv.to(cuda_device),
                                            tq.KV8_CHANNEL),
                             tq.kv_quantize(kv, tq.KV8_CHANNEL)):
            assert torch.equal(got.cpu(), want)


def test_w4a16_kernel_matches_plain(cuda_device):
    """bf16, ragged M and a ragged N tile, Split-K 1/2/4, with and without
    zero-points. Tolerance one bf16 ulp after a reordered fp32 sum:
    rtol 2^-7, atol 1e-3."""
    rng = np.random.default_rng(0)
    for M, split_k, symmetric, N in ((1, 1, True, 640), (8, 4, True, 640),
                                     (32, 2, False, 144),
                                     (40, 1, False, 144)):
        K = 1024
        w = torch.from_numpy((rng.standard_normal((K, N)) * K ** -0.5)
                             .astype(np.float32)).to(cuda_device)
        qt = tq.quantize(w.to(torch.bfloat16), symmetric=symmetric)
        x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)) \
            .to(cuda_device, torch.bfloat16)
        got = wf.w4a16_fused(x, qt, split_k=split_k).float()
        want = wf.w4a16_fused_plain(x, qt, split_k=split_k).float()
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=2 ** -7, atol=1e-3)
    with pytest.raises(ValueError, match="multiples of 32"):
        wf.w4a16_fused(x, qt, split_k=64)


def test_w4a16_kernel_matches_plain_fp32(cuda_device):
    """fp32 activations (the reduced configurations' dtype) take the
    kernel's CUDA-core FMA variant: the same products summed in another
    order, so fp32 rounding only (rtol 1e-5, atol 1e-4)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(1)
    for M, split_k, symmetric, N in ((1, 1, True, 640), (8, 4, False, 144),
                                     (40, 2, True, 144)):
        K = 1024
        w = torch.from_numpy((rng.standard_normal((K, N)) * K ** -0.5)
                             .astype(np.float32)).to(cuda_device)
        qt = tq.quantize(w, symmetric=symmetric)
        x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)) \
            .to(cuda_device)
        got = wf.w4a16_fused(x, qt, split_k=split_k)
        want = wf.w4a16_fused_plain(x, qt, split_k=split_k)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def _tol(dtype):
    """bf16: one bf16 ulp after a reordered fp32 sum; fp32: fp32 summation
    order only."""
    return dict(rtol=2 ** -7, atol=1e-3) if dtype == torch.bfloat16 \
        else dict(rtol=1e-5, atol=1e-4)


def _operands(rng, dev, M, K, N, dtype):
    w = torch.from_numpy((rng.standard_normal((K, N)) * K ** -0.5)
                         .astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)) \
        .to(dev, dtype)
    return x, w


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dense_gemm_kernel_matches_plain(cuda_device, dtype):
    """Both modes: the direct output and (S, M, N) fp32 partials at S = 1,
    2, 4; ragged M and a ragged N tile."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(2)
    for M, N in ((1, 640), (8, 144), (40, 640)):
        x, w = _operands(rng, cuda_device, M, 1024, N, dtype)
        w = w.to(dtype)
        got = tgemm.gemm(x, w).float()
        torch.testing.assert_close(got, tgemm.gemm_plain(x, w).float(),
                                   **_tol(dtype))
        for S in (1, 2, 4):
            torch.testing.assert_close(
                tdec.splitk_gemm(x, w, split_k=S),
                tdec.splitk_gemm_plain(x, w, split_k=S),
                rtol=1e-5, atol=1e-4)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decoupled_kernels_match_plain(cuda_device, dtype):
    """Phase 1 and phase 3 repeat their plain versions' fp32 operations in
    the same order, so they agree exactly (phase 1 also with groups of 4 K
    rows, two in a thread's 8, and phase 3 at 16 slices); the
    pipeline within the GEMM's tolerance."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(3)
    for M, N, split_k, symmetric, group in ((8, 640, 4, True, 128),
                                            (32, 144, 2, False, 128),
                                            (3, 640, 1, False, 4),
                                            (5, 144, 16, True, 32)):
        x, w = _operands(rng, cuda_device, M, 1024, N, dtype)
        qt = tq.quantize(w, symmetric=symmetric, group_size=group)
        ws = tdec.dequant_w4(qt, out_dtype=dtype)
        assert torch.equal(ws, tdec.dequant_w4_plain(qt, out_dtype=dtype))
        parts = tdec.splitk_gemm_plain(x, ws, split_k=split_k)
        assert torch.equal(tdec.reduce_partials(parts, out_dtype=dtype),
                           tdec.reduce_partials_plain(parts,
                                                      out_dtype=dtype))
        torch.testing.assert_close(
            tdec.w4a16_decoupled(x, qt, split_k=split_k).float(),
            tdec.w4a16_decoupled_plain(x, qt, split_k=split_k).float(),
            **_tol(dtype))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w8a16_kernel_matches_plain(cuda_device, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(4)
    for M, N, split_k, symmetric in ((1, 640, 1, True), (8, 144, 2, False),
                                     (40, 640, 1, False)):
        x, w = _operands(rng, cuda_device, M, 1024, N, dtype)
        qt = tq.quantize(w, "w8a16_channel", symmetric=symmetric)
        torch.testing.assert_close(
            tw8a16.w8a16_fused(x, qt, split_k=split_k).float(),
            tw8a16.w8a16_fused_plain(x, qt, split_k=split_k).float(),
            **_tol(dtype))
    torch.cuda.synchronize()


def _w4a8_edge_rows(x):
    """Rows 0-2 of x (M >= 3) set to the quantizer's edges: an all-zero row
    (s = 1e-8), a row holding +amax and -amax, and a row whose amax is
    127/16 (s = 1/16 exactly) and whose other values are exact .5 ties of
    x / s, which round half to even."""
    K = x.shape[1]
    x[0] = 0
    x[1, 0], x[1, 1] = x[1].abs().max(), -x[1].abs().max()
    ties = (2 * (torch.arange(K, device=x.device) % 254 - 127) + 1) / 32.0
    x[2] = ties.to(x.dtype)
    x[2, 0] = 127 / 16
    return x


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w4a8_kernel_matches_plain(cuda_device, dtype):
    """Exact int32 group sums on both sides: only the fp32 sum over groups
    is reordered. M = 1 to 256, N = 144 (a ragged column tile), groups 32,
    64 and 128, zero-points, split_k 1, 4 (one cluster) and 16 (partials),
    the quantizer's edge rows; the quantize kernel's x_q and row scales
    bit-equal to quantize_activations_int8 on the CPU, its Σx_q per group
    the sums of those x_q."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    for M, N, split_k, symmetric, group in ((1, 640, 1, True, 128),
                                            (8, 144, 4, False, 128),
                                            (40, 640, 2, True, 64),
                                            (32, 144, 1, False, 32),
                                            (256, 144, 4, True, 64),
                                            (8, 144, 16, False, 32),
                                            (40, 144, 16, True, 32)):
        K = 1024 if split_k < 16 else 512
        x, w = _operands(rng, cuda_device, M, K, N, dtype)
        if M >= 3:
            x = _w4a8_edge_rows(x)
        qt = tq.quantize(w, "w4a8_g128", group_size=group,
                         symmetric=symmetric)
        got = tw4a8.w4a8_fused(x, qt, split_k=split_k)
        want = tw4a8.w4a8_fused_plain(x, qt, split_k=split_k)
        assert got.dtype == dtype and got.shape == (M, N)
        torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
        xq, xs, tok = tw4a8.w4a8_quantize(x, group)
        wq, ws = tq.quantize_activations_int8(x.cpu())
        assert torch.equal(xq.cpu(), wq) and torch.equal(xs.cpu(), ws)
        assert torch.equal(tok.cpu(), wq.reshape(M, K // group, group)
                           .sum(dim=2, dtype=torch.int32))
    torch.cuda.synchronize()


def test_w4a8_kernel_is_two_device_ops(cuda_device):
    """Two device ops a call within a cluster's slices (the quantize kernel
    and the GEMM, which sums, scales and casts)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(7)
    x, w = _operands(rng, cuda_device, 8, 1024, 640, torch.bfloat16)
    qt = tq.quantize(w, "w4a8_g128")
    tw4a8.w4a8_fused(x, qt, split_k=4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tw4a8.w4a8_fused(x, qt, split_k=4)
        torch.cuda.synchronize()
    ops = sum(e.count for e in prof.key_averages()
              if e.device_type != DeviceType.CPU)
    assert ops == 2


@pytest.mark.parametrize("fmt_name", ["kv_fp16", "kv8_channel"])
def test_paged_attention_kernel_matches_plain(cuda_device, fmt_name):
    """Decode and a 4-query chunk over a pool filled through the port's
    paged_insert, with a -1 table tail, window 8, two partitions, bf16.
    Tolerance 1e-2 on unit-scale partials: softmax weights round to bf16
    before the readout and may land on the neighbouring bf16 value."""
    B, Hkv, G, D, ps, T_pages = 2, 2, 2, 32, 4, 4
    fmt = tq.get_kv_format(fmt_name)
    pool = kvc.init_pool(1 + B * T_pages, ps, Hkv, D, torch.bfloat16,
                         fmt_name, device=cuda_device)
    tables = (1 + torch.arange(B * T_pages, dtype=torch.int32)).reshape(
        B, T_pages).to(cuda_device)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    for p in range(14):
        k = torch.randn(B, Hkv, D, generator=gen, device=cuda_device)
        v = torch.randn(B, Hkv, D, generator=gen, device=cuda_device)
        kvc.paged_insert(pool, tables, k.to(torch.bfloat16),
                         v.to(torch.bfloat16),
                         torch.full((B,), p, device=cuda_device),
                         cache_len=ps * T_pages, fmt=fmt)
    tables[1, 3:] = -1
    for C in (1, 4):
        q = torch.randn(B, C, Hkv, G, D, generator=gen, device=cuda_device)
        qk = (q * D ** -0.5).to(torch.bfloat16).permute(0, 2, 1, 3, 4) \
            .reshape(B, Hkv, 1, C * G, D).contiguous()
        positions = (14 + torch.arange(C, dtype=torch.int32,
                                       device=cuda_device)).expand(B, C) \
            .contiguous()
        start = positions[:, 0].contiguous()
        kw = dict(Tq=C, G=G, S=2, window=8, fmt=fmt)
        got = tpa._launch_partials(qk, positions, start, pool, tables, **kw)
        want = tpa.pooled_partials_plain(qk, positions, start, pool, tables,
                                          **kw)
        torch.cuda.synchronize()
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_, w_, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 0.05),
                                       (torch.float32, 1e-3)])
def test_engine_kernel_path_matches_plain_path(cuda_device, dtype, tol):
    """REDUCED danube served through both kernels gives the plain paths'
    prefill logits on the same card, and both kernels ran: in bf16 within
    bf16 rounding accumulated over two layers (rtol/atol 0.05); in fp32,
    the configuration's own dtype, within fp32 summation order and exp
    rounding over two layers (1e-3)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_reduced("h2o-danube-1.8b"),
                              dtype=dtype)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    params = T.quantize_params(T.init_params(gen, cfg, device=cuda_device),
                               cfg, min_size=0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             size=(2, 12)).astype(np.int32)

    def run(strategy, path):
        eng = ServingEngine(dataclasses.replace(cfg,
                                                w4a16_strategy=strategy),
                            params, max_batch=2, max_prompt_len=12,
                            max_new_tokens=4, page_size=8, prefill_chunk=8,
                            attn_path=path, device=cuda_device)
        return eng.run([Request(rid=i, prompt=toks[i], max_new_tokens=4)
                        for i in range(2)])

    before = (wf.W4A16_GEMM.launches, tpa.PAGED_ATTENTION.launches)
    fused = run("auto", "auto")
    assert wf.W4A16_GEMM.launches > before[0]
    assert tpa.PAGED_ATTENTION.launches > before[1]
    plain = run("reference", "gather")
    for rid in (0, 1):
        assert len(fused.results[rid]) == 4
        torch.testing.assert_close(fused.prefill_logits[rid],
                                   plain.prefill_logits[rid],
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_compiled_engine_matches_eager_on_the_card(cuda_device, dtype):
    """REDUCED danube (fp32 as configured, and bf16) served compiled
    (CUDA graphs, the default on the card) and eagerly on the same
    weights: the same tokens, prefill logits bit-equal (the same kernels
    on the same inputs with the same launches), each kernel launched as
    many times (the replays counted), the pool's tensors kept from the
    first step to the last, and graphs captured."""
    cfg = dataclasses.replace(configs.get_reduced("h2o-danube-1.8b"),
                              dtype=dtype)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    params = T.quantize_params(T.init_params(gen, cfg, device=cuda_device),
                               cfg, min_size=0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             size=(3, 12)).astype(np.int32)
    kernels = (wf.W4A16_GEMM, tpa.PAGED_ATTENTION)

    def run(compiled):
        eng = ServingEngine(cfg, params, max_batch=2, max_prompt_len=12,
                            max_new_tokens=6, page_size=4, prefill_chunk=5,
                            device=cuda_device, compiled=compiled)
        before = [k.launches for k in kernels]
        eng.start()
        for i in range(3):
            eng.submit(Request(rid=i, prompt=toks[i], max_new_tokens=6,
                               arrival_step=i))
        ptr = eng._state["cache"]["kv"].k_pool.data_ptr()
        while eng.has_work():
            eng.step()
        torch.cuda.synchronize()
        assert eng._state["cache"]["kv"].k_pool.data_ptr() == ptr
        return eng, eng.report, [k.launches - b
                                 for k, b in zip(kernels, before)]

    eng, compiled, got = run(None)
    assert eng.compiled and eng.graph_pool.graphs > 0
    _, eager, want = run(False)
    assert compiled.results == eager.results
    assert got == want and all(n > 0 for n in got)
    for rid in compiled.results:
        assert torch.equal(compiled.prefill_logits[rid],
                           eager.prefill_logits[rid])


@pytest.mark.parametrize("fmt,strategy,plain,kernels", [
    ("w4a16_g128", "decoupled", "reference",
     (tdec.DEQUANT_W4, tgemm.DENSE_GEMM, tdec.REDUCE_PARTIALS)),
    ("w8a16_channel", "auto", "reference", (tw8a16.W8A16_GEMM,)),
    ("w4a8_g128", "auto", "w4a8_xla", (tw4a8.W4A8_GEMM,))])
def test_engine_gemm_family_matches_plain_path(cuda_device, fmt, strategy,
                                               plain, kernels):
    """REDUCED danube in fp32, its own dtype, served with each new format
    (and the decoupled pipeline) through the kernels gives the plain
    path's prefill logits on the same card (fp32 summation order and exp
    rounding over two layers: 1e-3), and the path's kernels ran."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_reduced("h2o-danube-1.8b"),
                              quant_format=fmt)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    params = T.quantize_params(T.init_params(gen, cfg, device=cuda_device),
                               cfg, min_size=0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             size=(2, 12)).astype(np.int32)

    def run(strat):
        eng = ServingEngine(dataclasses.replace(cfg, w4a16_strategy=strat),
                            params, max_batch=2, max_prompt_len=12,
                            max_new_tokens=4, page_size=8, prefill_chunk=8,
                            device=cuda_device)
        return eng.run([Request(rid=i, prompt=toks[i], max_new_tokens=4)
                        for i in range(2)])

    before = [k.launches for k in kernels]
    got = run(strategy)
    assert all(k.launches > b for k, b in zip(kernels, before))
    want = run(plain)
    for rid in (0, 1):
        torch.testing.assert_close(got.prefill_logits[rid],
                                   want.prefill_logits[rid],
                                   rtol=1e-3, atol=1e-3)


def _flash_inputs(dev, B, S, Hq, Hkv, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dev, dtype)
            for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,dtype,tol", [
    (2, 320, 32, 8, 80, 128, torch.bfloat16, 2e-2),   # danube heads, SWA
    (1, 200, 8, 2, 64, 0, torch.float32, 1e-5),       # ragged, fp32
])
def test_flash_kernel_matches_plain(cuda_device, B, S, Hq, Hkv, D, window,
                                    dtype, tol):
    """The kernel's output within the JAX flash test's tolerance of its
    plain version (2e-2 in bf16, 1e-5 in fp32), in bf16 also within 2^-7 of
    each element plus 2^-5 of its row's RMS over D (p rounded to bf16 at
    two different maxima; a long row's |o| is far below 2e-2), and its
    log-sum-exp within 1e-4; one launch per call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _flash_inputs(cuda_device, B, S, Hq, Hkv, D, dtype)
    before = tfa.FLASH_ATTENTION.launches
    o, lse = tfa.flash_attention_forward(q, k, v, causal=True,
                                         window=window)
    assert tfa.FLASH_ATTENTION.launches == before + 1
    o_p, lse_p = tfa.flash_attention_plain(q, k, v, causal=True,
                                           window=window)
    torch.cuda.synchronize()
    assert o.dtype == dtype
    torch.testing.assert_close(o.float(), o_p.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        w = o_p.float()
        rms = w.square().mean(dim=-1, keepdim=True).sqrt()
        assert bool(((o.float() - w).abs()
                     <= 2 ** -7 * w.abs() + 2 ** -5 * rms).all())
    torch.testing.assert_close(lse, lse_p, rtol=1e-4, atol=1e-4)


def test_flash_function_grads_match_autograd_of_plain(cuda_device):
    """fp32, danube heads, S=256, window 64: the Function's dq, dk, dv
    (kernel forward, PyTorch backward) within 1e-5 of autograd through the
    plain version."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (t.requires_grad_() for t in _flash_inputs(
        cuda_device, 1, 256, 32, 8, 80, torch.float32, seed=1))
    do = torch.randn(q.shape, device=cuda_device)
    got = torch.autograd.grad(tfa.flash_attention(q, k, v, window=64),
                              (q, k, v), do)
    want = torch.autograd.grad(
        tfa.flash_attention_plain(q, k, v, window=64)[0], (q, k, v), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_train_step_kernel_path_matches_plain_path(cuda_device):
    """danube at full width and 2 layers, bf16, B=2 x 512 tokens, two
    steps through the flash kernel and through the plain chunked
    attention: losses within 2e-4, grad norms within 2e-3 (relative);
    after step 2, per leaf, max|d| / max|plain| within 5e-2 for m and 1e-1
    for v (bf16 gradients of two attention orders). The parameters are not
    held: within warmup their updates sit below a bf16 step."""
    cfg = dataclasses.replace(configs.get_config("h2o-danube-1.8b"),
                              num_layers=2)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    params0 = T.init_params(gen, cfg, device=cuda_device)
    opt_cfg = AdamWConfig(lr=1e-3)
    stream = SyntheticTokenStream(vocab_size=cfg.vocab_size, seq_len=512,
                                  batch_size=2, device=cuda_device)
    out = {}
    for impl in ("flash", "chunked"):
        step = tsteps.make_train_step(
            dataclasses.replace(cfg, attn_impl=impl), opt_cfg)
        params, state, metrics = params0, adamw_init(params0, opt_cfg), []
        for i in range(2):
            params, state, m = step(params, state,
                                    {"batch": stream.batch_at(i), "step": i})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[impl] = metrics, {"m": state["m"], "v": state["v"]}
    (mk, tk), (mp, tp) = out["flash"], out["chunked"]
    for (lk, gk), (lp, gp) in zip(mk, mp):
        assert abs(lk - lp) <= 2e-4 * abs(lp)
        assert abs(gk - gp) <= 2e-3 * abs(gp)
    for name, tol in (("m", 5e-2), ("v", 1e-1)):
        want = dict(tree_flatten_with_keys(tp[name]))
        for key, g in tree_flatten_with_keys(tk[name]):
            w = want[key].float()
            d = float((g.float() - w).abs().max())
            assert d <= tol * float(w.abs().max()), (name, key, d)


def _paged_pool_case(dev, *, kind, fmt_name, dtype, seed, heads=(2, 4, 80),
                     ps=8, T_=68, ctx=None):
    """danube's head dim over 68-page tables of 8-token pages, 2 KV heads
    of G = 4: decode B=2 at ragged positions past the 544-token window
    (slot 1 holds 10 pages, its table tail -1), or a 32-token chunk B=1
    after 480 cached tokens, or a verify step of B=2 rows of 5 queries
    (row 1 with 2 live ones, the rest -1) over pools holding three stale
    rejected-draft tags at and above each row's start; slot 0's table
    entry 5 is -1 inside its live pages. ``heads`` (KV heads, group, head
    dim), ``ps``, ``T_`` (a slot's pages) and ``ctx`` (the last cached
    position, 700 / 480 by default) set other shapes."""
    Hkv, G_, D_ = heads
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    B, C = {"decode": (2, 1), "chunk": (1, 32), "verify": (2, 5)}[kind]
    fmt = tq.get_kv_format(fmt_name)
    pool = kvc.init_pool(1 + B * T_, ps, Hkv, D_, dtype, fmt_name,
                         device=dev)
    if fmt.quantized:
        for t in (pool.k_pool, pool.v_pool):
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                  device=dev))
        for t in (pool.k_scale, pool.v_scale):
            t.copy_(torch.rand(t.shape, generator=gen, device=dev) / 64)
    else:
        for t in (pool.k_pool, pool.v_pool):
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    tables = (1 + torch.arange(B * T_, device=dev, dtype=torch.int32)
              ).reshape(B, T_)
    flat = pool.page_pos.view(-1)
    last = []
    for b in range(B):
        hi = (ctx or (480 if kind == "chunk" else 700)) - 3 * b
        lo = max(0, hi - T_ * ps + 1)
        if kind == "decode" and b == 1:
            hi, lo = 10 * ps - 1, 0
            tables[b, 10:] = -1
        stale = 3 if kind == "verify" else 0
        p = torch.arange(lo, hi + 1 + stale, device=dev)
        off = p % (T_ * ps)
        bid = tables[b, off // ps].long()
        flat[bid * ps + off % ps] = p.to(torch.int32)
        last.append(hi)
    tables[0, 5] = -1
    last = torch.tensor(last, device=dev, dtype=torch.int32)
    if kind == "decode":
        positions, start = last[:, None].contiguous(), last + 1
    else:
        positions = (last[:, None] + 1 + torch.arange(
            C, device=dev, dtype=torch.int32)).contiguous()
        if kind == "verify":
            positions[1, 2:] = -1
        start = positions[:, 0].contiguous()
    q = torch.randn(B, C, Hkv, G_, D_, generator=gen, device=dev)
    Tq = planning.choose_q_block(C, G_)
    qk = (q * D_ ** -0.5).to(dtype).permute(0, 2, 1, 3, 4) \
        .reshape(B, Hkv, C // Tq, Tq * G_, D_).contiguous()
    return qk, positions, start, pool, tables, fmt, Tq, G_


def _combine_partials(acc, m, l):
    alpha = torch.exp(m - m.amax(dim=3, keepdim=True))
    return (acc * alpha[..., None]).sum(dim=3) \
        / (l * alpha).sum(dim=3).clamp_min(1e-30)[..., None]


@pytest.mark.parametrize("kind", ["decode", "chunk"])
@pytest.mark.parametrize("fmt_name", ["kv_fp16", "kv8_channel"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_paged_attention_kernel_edges(cuda_device, kind, fmt_name, dtype):
    """The kernel's own edges at danube's head dim: partitions of 68 and
    17 pages (544 and 136 keys, neither a multiple of the kernel's key
    stage), a -1 entry inside a live partition, a null slot (decode), a
    100-token window that masks whole partitions, both KV formats, bf16
    and fp16. Held as phase 3 of chip_smoke.py holds them: the combined
    output within 2^-7·|plain| + 2e-3, the same partitions fully masked,
    elsewhere m within 1e-4·(1 + |m|) and l within 1e-3·l."""
    qk, positions, start, pool, tables, fmt, Tq, G_ = _paged_pool_case(
        cuda_device, kind=kind, fmt_name=fmt_name, dtype=dtype, seed=7)
    for window in (4096, 100):
        for S in (1, 4):
            kw = dict(Tq=Tq, G=G_, S=S, window=window, fmt=fmt)
            args = (qk, positions, start, pool, tables)
            before = tpa.PAGED_ATTENTION.launches
            got = tpa._launch_partials(*args, **kw)
            assert tpa.PAGED_ATTENTION.launches == before + 1
            want = tpa.pooled_partials_plain(*args, **kw)
            torch.cuda.synchronize()
            out_p = _combine_partials(*want)
            d = (_combine_partials(*got) - out_p).abs()
            assert bool((d <= out_p.abs() * 2 ** -7 + 2e-3).all()), \
                (window, S, float(d.max()))
            (_, m_k, l_k), (_, m_p, l_p) = got, want
            live = m_p > -1e29
            assert torch.equal(live, m_k > -1e29)
            assert float(((m_k - m_p).abs() / (1 + m_p.abs()))[live]
                         .max()) <= 1e-4
            assert float(((l_k - l_p).abs() / l_p)[live].max()) <= 1e-3


@pytest.mark.parametrize("B,Sq,Skv,causal,window,fused", [
    (1, 256, 300, False, 0, False),     # Skv ends mid key tile
    (2, 40, 40, True, 4096, False),     # Sq below one query tile
    (1, 512, 512, True, 100, False),    # a window ending mid key tile
    (2, 256, 256, True, 4096, True),    # q, k, v as fused-projection views
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_edges(cuda_device, B, Sq, Skv, causal, window, fused,
                            dtype):
    """danube's heads (32/8 of 80) at the kernel's tile edges and on
    strided inputs, against the plain version: bf16 within min(2e-2·(1 +
    |o|), 2^-7·|o| + 2^-5 of the row's RMS), fp32 within 1e-5·(1 + |o|),
    the log-sum-exp within 1e-4·(1 + |lse|) (chip_smoke.py's
    flash_limit)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    Hq, Hkv, D_ = 32, 8, 80
    rng = np.random.default_rng(11)
    if fused:
        qkv = torch.from_numpy(rng.standard_normal(
            (B, Sq, (Hq + 2 * Hkv) * D_)).astype(np.float32)) \
            .to(cuda_device, dtype)
        q, k, v = qkv.split([Hq * D_, Hkv * D_, Hkv * D_], dim=-1)
        q, k, v = (q.unflatten(-1, (Hq, D_)), k.unflatten(-1, (Hkv, D_)),
                   v.unflatten(-1, (Hkv, D_)))
        assert not k.is_contiguous()
    else:
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(cuda_device, dtype)
            for s in ((B, Sq, Hq, D_), (B, Skv, Hkv, D_), (B, Skv, Hkv, D_)))
    o, lse = tfa.flash_attention_forward(q, k, v, causal=causal,
                                         window=window)
    o_p, lse_p = tfa.flash_attention_plain(q, k, v, causal=causal,
                                           window=window)
    torch.cuda.synchronize()
    w = o_p.float()
    if dtype == torch.float32:
        lim = 1e-5 * (1 + w.abs())
    else:
        rms = w.square().mean(dim=-1, keepdim=True).sqrt()
        lim = torch.minimum(2e-2 * (1 + w.abs()),
                            2 ** -7 * w.abs() + 2 ** -5 * rms)
    assert o.dtype == dtype
    assert bool(((o.float() - w).abs() <= lim).all())
    assert bool(((lse - lse_p).abs() <= 1e-4 * (1 + lse_p.abs())).all())


# ---------------------------------------------------------------------------
# the GEMM tile loop's edges (csrc/gemm_tile.cuh)
# ---------------------------------------------------------------------------

# (K, split_k, group size): a K slice shorter than one 128-row stage of the
# int rings (96); slices that are multiples of 32 but not of the stage
# (1056, and 1056 / 3 = 352 rows, a 3-block cluster); split_k 2, 4 and 8,
# each held by one cluster
_TILE_K = [(96, 1, 32), (1056, 1, 32), (1056, 3, 32), (1024, 2, 128),
           (1024, 4, 128), (2048, 8, 128)]


@pytest.mark.parametrize("M", [1, 8, 9, 32, 33, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("kind", ["int4", "int8", "dense"])
def test_gemm_tile_edges(cuda_device, kind, dtype, M):
    """The fused W4A16 (int4), W8A16 (int8) and dense kernels against their
    plain versions: ragged M around the 8/16/32-token tiles, N = 16, 48 and
    144 (column tails of the 64-column block) and 640, the K cases above,
    with and without zero-points. Outputs: rtol 2^-7, atol 1e-3 (one ulp
    after a reordered fp32 sum); the dense partials (decoupled phase 2) and
    the decoupled pipeline too: fp32 partials at rtol 1e-5, atol 1e-4."""
    rng = np.random.default_rng(100 + M)
    for N in (16, 48, 144, 640):
        for i, (K, split_k, group) in enumerate(_TILE_K):
            symmetric = bool(i % 2)
            x, w = _operands(rng, cuda_device, M, K, N, dtype)
            w = w.to(dtype)
            if kind == "int4":
                qt = tq.quantize(w, group_size=group, symmetric=symmetric)
                got = wf.w4a16_fused(x, qt, split_k=split_k)
                want = wf.w4a16_fused_plain(x, qt, split_k=split_k)
                torch.testing.assert_close(
                    tdec.w4a16_decoupled(x, qt, split_k=split_k).float(),
                    tdec.w4a16_decoupled_plain(x, qt, split_k=split_k)
                    .float(), rtol=2 ** -7, atol=1e-3)
            elif kind == "int8":
                qt = tq.quantize(w, "w8a16_channel", symmetric=symmetric)
                got = tw8a16.w8a16_fused(x, qt, split_k=split_k)
                want = tw8a16.w8a16_fused_plain(x, qt, split_k=split_k)
            else:
                got, want = tgemm.gemm(x, w), tgemm.gemm_plain(x, w)
                torch.testing.assert_close(
                    tdec.splitk_gemm(x, w, split_k=split_k),
                    tdec.splitk_gemm_plain(x, w, split_k=split_k),
                    rtol=1e-5, atol=1e-4)
            assert got.dtype == dtype and got.shape == (M, N)
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=2 ** -7, atol=1e-3)
    torch.cuda.synchronize()


def test_fused_gemms_sum_split_k_in_the_kernel(cuda_device, monkeypatch):
    """In direct mode with split_k a cluster holds (≤ 8), the W4A16 and
    W8A16 wrappers launch the kernel alone: no torch.sum, no cast. Beyond
    a cluster (split_k 16) the wrapper's partials route sums in fp32 and
    casts, and both routes agree with the plain version."""
    rng = np.random.default_rng(11)
    x, w = _operands(rng, cuda_device, 8, 2048, 640, torch.bfloat16)
    w = w.to(torch.bfloat16)
    q4 = tq.quantize(w)
    q8 = tq.quantize(w, "w8a16_channel")
    cases = [(wf.w4a16_fused, wf.w4a16_fused_plain, q4, s)
             for s in (1, 2, 4, 8, 16)]
    cases += [(tw8a16.w8a16_fused, tw8a16.w8a16_fused_plain, q8, s)
              for s in (1, 4, 16)]
    wants = [plain(x, qt, split_k=s) for _, plain, qt, s in cases]
    sums = []
    real_sum = torch.sum

    def counted_sum(*args, **kwargs):
        sums.append(1)
        return real_sum(*args, **kwargs)

    monkeypatch.setattr(torch, "sum", counted_sum)
    for (kernel, _, qt, s), want in zip(cases, wants):
        before = len(sums)
        got = kernel(x, qt, split_k=s)
        assert len(sums) - before == (1 if s > 8 else 0)
        assert got.dtype == torch.bfloat16 and got.shape == (8, 640)
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=1e-3)
    torch.cuda.synchronize()


@pytest.mark.parametrize("fmt_name", ["kv_fp16", "kv8_channel"])
def test_paged_attention_verify_regime_matches_plain(cuda_device, fmt_name):
    """The speculative verify step's shape at danube's head dim: B = 4
    rows of 5 queries (Tq = 5, 20 query rows a block), row b keeping
    1 + b live queries and -1 padding after them, the last row inactive
    (positions and table -1), and stale tags of rejected drafts at and
    above each row's start, which ``kpos < start`` must mask. Live
    queries only (padded ones are garbage both sides discard), held as
    ``test_paged_attention_kernel_edges`` holds its cases."""
    Hkv, G_, D_, ps, T_, B, C = 2, 4, 80, 8, 68, 4, 5
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(11)
    fmt = tq.get_kv_format(fmt_name)
    pool = kvc.init_pool(1 + B * T_, ps, Hkv, D_, torch.bfloat16, fmt_name,
                         device=cuda_device)
    if fmt.quantized:
        for t in (pool.k_pool, pool.v_pool):
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                  device=cuda_device))
        for t in (pool.k_scale, pool.v_scale):
            t.copy_(torch.rand(t.shape, generator=gen, device=cuda_device)
                    / 64)
    else:
        for t in (pool.k_pool, pool.v_pool):
            t.copy_(torch.randn(t.shape, generator=gen, device=cuda_device))
    tables = (1 + torch.arange(B * T_, device=cuda_device,
                               dtype=torch.int32)).reshape(B, T_)
    flat = pool.page_pos.view(-1)
    positions = torch.full((B, C), -1, dtype=torch.int32, device=cuda_device)
    for b in range(B):
        hi = 700 - 3 * b
        p = torch.arange(hi - T_ * ps + 1, hi + 4, device=cuda_device)
        off = p % (T_ * ps)
        flat[tables[b, off // ps].long() * ps + off % ps] = p.to(torch.int32)
        positions[b, :1 + b] = hi + 1 + torch.arange(
            1 + b, device=cuda_device, dtype=torch.int32)
    positions[B - 1] = -1
    tables[B - 1] = -1
    start = positions[:, 0].contiguous()
    q = torch.randn(B, C, Hkv, G_, D_, generator=gen, device=cuda_device)
    qk = (q * D_ ** -0.5).to(torch.bfloat16).permute(0, 2, 1, 3, 4) \
        .reshape(B, Hkv, 1, C * G_, D_).contiguous()
    rows = (positions >= 0)[:, None, None, None, :, None] \
        .expand(B, 1, 1, 1, C, G_).reshape(B, 1, 1, 1, C * G_)
    for S in (1, 4):
        kw = dict(Tq=C, G=G_, S=S, window=4096, fmt=fmt)
        args = (qk, positions, start, pool, tables)
        got = tpa._launch_partials(*args, **kw)
        want = tpa.pooled_partials_plain(*args, **kw)
        torch.cuda.synchronize()
        out_p = _combine_partials(*want)
        live_q = rows[:, :, :, 0].expand(B, Hkv, 1, C * G_)
        d = (_combine_partials(*got) - out_p).abs()[live_q]
        assert bool((d <= out_p.abs()[live_q] * 2 ** -7 + 2e-3).all()), \
            (S, float(d.max()))
        (_, m_k, l_k), (_, m_p, l_p) = got, want
        live = (m_p > -1e29) & rows
        assert torch.equal(live, (m_k > -1e29) & rows)
        assert float(((m_k - m_p).abs() / (1 + m_p.abs()))[live]
                     .max()) <= 1e-4
        assert float(((l_k - l_p).abs() / l_p)[live].max()) <= 1e-3


@pytest.mark.parametrize("proposer", ["ngram", "oracle"])
def test_speculative_engine_exact_acceptance_on_card(cuda_device, proposer):
    """REDUCED danube in bf16 served speculatively on the kernels (the
    verify step through the paged-attention kernel at q_len = 4, its
    GEMMs planned at M = 12): every emitted token after the first is the
    verify step's own argmax at its position, reached through accepted
    drafts (chip_smoke phase 8's invariant); the target's own weights as
    the draft accept at least 90 % of their proposals."""
    from repro_torch.runtime import speculative as spec
    cfg = dataclasses.replace(configs.get_reduced("h2o-danube-1.8b"),
                              dtype=torch.bfloat16)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    params = T.quantize_params(T.init_params(gen, cfg, device=cuda_device),
                               cfg, min_size=0)
    rng = np.random.default_rng(2)
    seg = rng.integers(0, cfg.vocab_size, size=(3, 4))
    prompts = [np.tile(s, 3).astype(np.int32) for s in seg]     # P = 12
    speculate = "ngram" if proposer == "ngram" else \
        spec.DraftModelProposer(cfg, params)
    eng = ServingEngine(cfg, params, max_batch=3, max_prompt_len=12,
                        max_new_tokens=8, page_size=8, prefill_chunk=8,
                        speculate=speculate, spec_k=3, device=cuda_device)
    assert eng.verify_attn_path == "fused"
    records = []
    make = eng._verify_step

    def verify_step(live_pages=None):
        fn = make(live_pages)

        def call(params_, state, inputs):
            out = fn(params_, state, inputs)
            rids = [s.req.rid if s is not None and s.phase == "active"
                    else None for s in eng._slots]
            records.append((rids, inputs["tokens"].cpu(),
                            inputs["positions"].cpu(), out["next"].cpu()))
            return out
        return call

    eng._verify_step = verify_step
    before = tpa.PAGED_ATTENTION.launches
    rep = eng.run([Request(rid=i, prompt=p, max_new_tokens=8)
                   for i, p in enumerate(prompts)])
    assert tpa.PAGED_ATTENTION.launches > before and records
    argmax = {}
    for rids, tok, pos, nxt in records:
        for i, rid in enumerate(rids):
            if rid is None:
                continue
            n, a = int((pos[i] >= 0).sum()) - 1, 0
            while a < n and int(tok[i, a + 1]) == int(nxt[i, a]):
                a += 1
            for c in range(a + 1):
                argmax[(rid, int(pos[i, c]) + 1 - 12)] = int(nxt[i, c])
    for rid, out in rep.results.items():
        assert len(out) == 8
        assert all(argmax[(rid, j)] == out[j] for j in range(1, 8))
    assert len(argmax) == 3 * 7
    assert eng.alloc.pages_in_use == 0
    if proposer == "oracle":
        assert rep.proposed_tokens > 0 and rep.acceptance_rate >= 0.9


def _expert_stack(rng, dev, E, K, N, fmt="w4a16_g128"):
    """(E, K, N) random weights quantized slice-wise into one stack."""
    from repro_torch.models import layers as tlayers
    w = torch.from_numpy((rng.standard_normal((E, K, N)) * K ** -0.5)
                         .astype(np.float32)).to(dev, torch.bfloat16)
    return tlayers.quantize_tree({"moe": {"w": {"kernel": w}}}, format=fmt,
                                 min_size=0)["moe"]["w"]["kernel"]


# (E, M, K, N): olmoe's expert GEMMs at their capacity 8, mixtral's at its
# decode and chunk capacities 2 and 10
EXPERT_CASES = [(64, 8, 2048, 1024), (64, 8, 1024, 2048),
                (8, 2, 4096, 14336), (8, 10, 14336, 4096)]


@pytest.mark.parametrize("E,M,K,N", EXPERT_CASES)
def test_expert_batched_w4a16_matches_plain(cuda_device, E, M, K, N):
    """One launch for the whole stack, at the planned split_k and at 2
    (partials (2, E, M, N) summed in slice order), with one expert's rows
    all zero; the plain version runs expert by expert. Tolerance one bf16
    ulp after a reordered fp32 sum (rtol 2^-7, atol 1e-3)."""
    from repro_torch.kernels import planning
    rng = np.random.default_rng(7)
    qt = _expert_stack(rng, cuda_device, E, K, N)
    x = torch.from_numpy(rng.standard_normal((E, M, K)).astype(np.float32)) \
        .to(cuda_device, torch.bfloat16)
    x[E // 2] = 0
    plan = planning.plan_matmul(planning.MatmulProblem.from_operands(
        x[0], qt.layer(0), batch=E), use_cache=False)
    for split_k, out_dtype in ((plan.split_k, None), (2, torch.float32)):
        n0 = (wf.W4A16_GEMM.launches, wf.W4A16_GEMM_EXPERTS.launches)
        got = wf.w4a16_fused(x, qt, split_k=split_k, out_dtype=out_dtype)
        assert (wf.W4A16_GEMM.launches - n0[0],
                wf.W4A16_GEMM_EXPERTS.launches - n0[1]) == (1, 1)
        want = wf.w4a16_fused_plain(x, qt, split_k=split_k,
                                    out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert got.shape == (E, M, N)
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=1e-3)
        assert torch.count_nonzero(got[E // 2]) == 0


def test_expert_batched_w8a16_matches_plain(cuda_device):
    rng = np.random.default_rng(8)
    for E, M, K, N in EXPERT_CASES[:2]:
        qt = _expert_stack(rng, cuda_device, E, K, N, "w8a16_channel")
        x = torch.from_numpy(rng.standard_normal((E, M, K))
                             .astype(np.float32)).to(cuda_device,
                                                     torch.bfloat16)
        n0 = tw8a16.W8A16_GEMM.launches
        got = tw8a16.w8a16_fused(x, qt)
        assert tw8a16.W8A16_GEMM.launches == n0 + 1
        torch.testing.assert_close(
            got.float(), tw8a16.w8a16_fused_plain(x, qt).float(),
            rtol=2 ** -7, atol=1e-3)
    torch.cuda.synchronize()


def test_expert_batched_kernel_refuses_what_it_cannot_take(cuda_device):
    """A stack whose N is not a multiple of 16, and x whose expert count
    differs from the stack's, raise before any launch: no plain path on
    the card."""
    rng = np.random.default_rng(9)
    qt = _expert_stack(rng, cuda_device, 4, 256, 72)
    x = torch.zeros((4, 8, 256), dtype=torch.bfloat16, device=cuda_device)
    n0 = wf.W4A16_GEMM.launches
    with pytest.raises(ValueError, match="N % 16"):
        wf.w4a16_fused(x, qt)
    with pytest.raises(ValueError, match="does not chain"):
        wf.w4a16_fused(x[:3], qt)
    assert wf.W4A16_GEMM.launches == n0


def test_moe_engine_kernel_path_matches_plain_path(cuda_device):
    """REDUCED olmoe in fp32 served through the expert-batched kernel: each
    decode step launches the W4A16 kernel 4 + 3 times a layer (the router
    and the head stay dense), and prefill logits match the plain path
    within fp32 summation order over two layers (1e-3)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_reduced("olmoe-1b-7b")
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    params = T.quantize_params(T.init_params(gen, cfg, device=cuda_device),
                               cfg, min_size=0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             size=(2, 12)).astype(np.int32)

    def run(strategy, path):
        eng = ServingEngine(dataclasses.replace(cfg,
                                                w4a16_strategy=strategy),
                            params, max_batch=2, max_prompt_len=12,
                            max_new_tokens=4, page_size=8, prefill_chunk=8,
                            attn_path=path, device=cuda_device)
        return eng.run([Request(rid=i, prompt=toks[i], max_new_tokens=4)
                        for i in range(2)])

    n0 = (wf.W4A16_GEMM.launches, wf.W4A16_GEMM_EXPERTS.launches)
    fused = run("auto", "auto")
    steps = fused.steps
    assert wf.W4A16_GEMM_EXPERTS.launches - n0[1] > 0
    assert (wf.W4A16_GEMM.launches - n0[0]) % (cfg.num_layers * 7) == 0
    plain = run("reference", "gather")
    assert steps == plain.steps
    for rid in (0, 1):
        torch.testing.assert_close(fused.prefill_logits[rid],
                                   plain.prefill_logits[rid],
                                   rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# the carry families (rwkv6-7b, hymba-1.5b)
# ---------------------------------------------------------------------------

# (K, N, group): rwkv6-7b's three W4A16 shapes, hymba-1.5b's six; its
# K = 1600 leaves quantize at group 64 (1600 is not a multiple of 128)
CARRY_GEMMS = [(4096, 4096, 128), (4096, 14336, 128), (14336, 4096, 128),
               (1600, 1600, 64), (1600, 320, 64), (1600, 3200, 64),
               (1600, 5504, 64), (3200, 1600, 128), (5504, 1600, 128)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,N,group", CARRY_GEMMS)
def test_w4a16_kernel_at_carry_shapes(cuda_device, K, N, group, dtype):
    """The served carry-family shapes, M = 1, 8 and 40, the planner's
    split_k and 1: at group 64 a 128-row ring stage holds parts of three
    groups and K = 1600 ends in a partial stage. Tolerance: one bf16 ulp
    after a reordered fp32 sum (2^-7·|plain| + 1e-3); fp32, summation order
    (1e-5·|plain| + 1e-4)."""
    rng = np.random.default_rng(K + N)
    w = torch.from_numpy((rng.standard_normal((K, N)) * K ** -0.5)
                         .astype(np.float32)).to(cuda_device)
    qt = tq.quantize(w.to(dtype), group_size=group, out_dtype=dtype)
    assert qt.group_size == group
    rtol, atol = (1e-5, 1e-4) if dtype == torch.float32 else (2 ** -7, 1e-3)
    for M in (1, 8, 40):
        x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)) \
            .to(cuda_device).to(dtype)
        plan = planning.plan_matmul(
            planning.MatmulProblem.from_operands(x, qt), use_cache=False)
        for s in sorted({plan.split_k, 1}):
            before = wf.W4A16_GEMM.launches
            got = wf.w4a16_fused(x, qt, split_k=s)
            assert wf.W4A16_GEMM.launches == before + 1
            want = wf.w4a16_fused_plain(x, qt, split_k=s)
            torch.cuda.synchronize()
            assert got.dtype == want.dtype == dtype
            d = (got.float() - want.float()).abs()
            assert bool((d <= want.float().abs() * rtol + atol).all()), \
                (M, s, float(d.max()))


@pytest.mark.parametrize("kind", ["decode", "chunk", "verify"])
@pytest.mark.parametrize("fmt_name", ["kv_fp16", "kv8_channel"])
def test_paged_attention_at_hymba_heads(cuda_device, kind, fmt_name):
    """hymba's attention half: 5 KV heads of G = 5 at D = 64 (5 query rows
    a decode block, two Q tiles of 80 rows for a 32-token chunk, 25 rows
    for a k = 4 verify window), 16-token pages, 64-page tables, context at
    1500 (the ring has wrapped), the 1024 window and a 100-token one, 1
    and 4 partitions, -1 table entries. Held as the danube edges are; a
    verify row's padded queries are garbage on both sides and not held."""
    qk, positions, start, pool, tables, fmt, Tq, G_ = _paged_pool_case(
        cuda_device, kind=kind, fmt_name=fmt_name, dtype=torch.bfloat16,
        seed=11, heads=(5, 5, 64), ps=16, T_=64, ctx=1500)
    B, C = positions.shape
    rows = (positions >= 0).reshape(B, C // Tq, Tq, 1) \
        .expand(B, C // Tq, Tq, G_).reshape(B, 1, C // Tq, Tq * G_)
    for window in (1024, 100):
        for S in (1, 4):
            kw = dict(Tq=Tq, G=G_, S=S, window=window, fmt=fmt)
            args = (qk, positions, start, pool, tables)
            before = tpa.PAGED_ATTENTION.launches
            got = tpa._launch_partials(*args, **kw)
            assert tpa.PAGED_ATTENTION.launches == before + 1
            want = tpa.pooled_partials_plain(*args, **kw)
            torch.cuda.synchronize()
            out_p = _combine_partials(*want)
            d = torch.where(rows[..., None],
                            (_combine_partials(*got) - out_p).abs(), 0.0)
            assert bool((d <= out_p.abs() * 2 ** -7 + 2e-3).all()), \
                (window, S, float(d.max()))
            (_, m_k, l_k), (_, m_p, l_p) = got, want
            r = rows[:, :, :, None]
            live = (m_p > -1e29) & r
            assert torch.equal(live, (m_k > -1e29) & r)
            assert float(((m_k - m_p).abs() / (1 + m_p.abs()))[live]
                         .max()) <= 1e-4
            assert float(((l_k - l_p).abs() / l_p)[live].max()) <= 1e-3


@pytest.mark.parametrize("arch", ["rwkv6-7b", "hymba-1.5b"])
def test_carry_engine_kernel_path_matches_plain_path(cuda_device, arch):
    """REDUCED rwkv6-7b and hymba-1.5b in fp32 through the kernels: every
    decode step launches the W4A16 kernel once for each quantized linear
    (8 a layer for rwkv, 10 for hymba) and paged attention once a layer
    (hymba only); prefill logits match the plain path within fp32
    summation order over two layers (1e-3), and so do greedy tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_reduced(arch)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    params = T.quantize_params(T.init_params(gen, cfg, device=cuda_device),
                               cfg, min_size=0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             size=(2, 12)).astype(np.int32)
    per_layer, attn = (8, 0) if cfg.family == "rwkv" else (10, 1)

    def run(strategy, path):
        eng = ServingEngine(dataclasses.replace(cfg,
                                                w4a16_strategy=strategy),
                            params, max_batch=2, max_prompt_len=12,
                            max_new_tokens=4, page_size=8, prefill_chunk=8,
                            attn_path=path, device=cuda_device)
        eng.start()
        for i in range(2):
            eng.submit(Request(rid=i, prompt=toks[i], max_new_tokens=4))
        while eng.report.decode_tokens == 0:
            eng.step()
        n0 = (wf.W4A16_GEMM.launches, tpa.PAGED_ATTENTION.launches)
        eng.step()
        n1 = (wf.W4A16_GEMM.launches - n0[0],
              tpa.PAGED_ATTENTION.launches - n0[1])
        return eng.drain(), n1

    fused, n = run("auto", "auto")
    assert n == (cfg.num_layers * per_layer, cfg.num_layers * attn)
    plain, n = run("reference", "gather")
    assert n == (0, 0)
    for rid in (0, 1):
        torch.testing.assert_close(fused.prefill_logits[rid],
                                   plain.prefill_logits[rid],
                                   rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# the encoder-decoder and vision-prefix families, the remaining dense configs
# ---------------------------------------------------------------------------

# (K, N, runs at admit) of every W4A16 leaf the new archs serve: whisper-
# small's (its encoder layers and cross K/V also at M = 1500 frames),
# internvl2-1b's, starcoder2-7b's (GELU) and granite-20b's (its K/V
# projections at K / N = 48), as tests/test_torch_dense_variants.py pins
# them; last, a vocab-wide N off the served path (internvl2-1b's lm_head
# stays dense)
ENCDEC_GEMMS = [(768, 768, True), (768, 3072, True), (3072, 768, True),
                (896, 896, False), (896, 128, False), (896, 4864, False),
                (4864, 896, False), (4608, 4608, False), (4608, 512, False),
                (4608, 18432, False), (18432, 4608, False),
                (6144, 6144, False), (6144, 128, False),
                (6144, 24576, False), (24576, 6144, False),
                (896, 151808, False)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,N,admit", ENCDEC_GEMMS)
def test_w4a16_kernel_at_encdec_and_dense_shapes(cuda_device, K, N, admit,
                                                 dtype):
    """The new served shapes at M = 1, 8 (decode), 32 (a chunk), 40 (the
    k = 4 verify step) and, for whisper's admit leaves, 1500; every
    group-aligned power-of-two split up to the planner's pick at M = 1
    (granite's (6144, 128): 1 to 16), the pick at M and the engine's plans
    at M = 8 and 40. Tolerance: one bf16 ulp after a reordered fp32 sum
    (2^-7·|plain| + 1e-3); fp32, summation order (1e-5·|plain| + 1e-4)."""
    rng = np.random.default_rng(K + N)
    w = torch.from_numpy((rng.standard_normal((K, N)) * K ** -0.5)
                         .astype(np.float32)).to(cuda_device)
    qt = tq.quantize(w.to(dtype), out_dtype=dtype)
    del w
    rtol, atol = (1e-5, 1e-4) if dtype == torch.float32 else (2 ** -7, 1e-3)
    cores = planning.num_cores("cuda")
    top = planning.choose_split_k(1, N, K, cores=cores)
    if (K, N) == (6144, 128):
        assert top == 16
    for M in (1, 8, 32, 40) + ((1500,) if admit else ()):
        x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)) \
            .to(cuda_device).to(dtype)
        splits = {1 << i for i in range(top.bit_length())} \
            | {planning.choose_split_k(m, N, K, cores=cores)
               for m in (M, 8, 40)}
        for s in sorted(splits):
            before = wf.W4A16_GEMM.launches
            got = wf.w4a16_fused(x, qt, split_k=s)
            assert wf.W4A16_GEMM.launches == before + 1
            want = wf.w4a16_fused_plain(x, qt, split_k=s)
            torch.cuda.synchronize()
            assert got.dtype == want.dtype == dtype
            d = (got.float() - want.float()).abs()
            assert bool((d <= want.float().abs() * rtol + atol).all()), \
                (M, s, float(d.max()))


@pytest.mark.parametrize("kind", ["decode", "chunk", "verify"])
@pytest.mark.parametrize("heads,T_", [((12, 1, 64), 10), ((2, 7, 64), 26),
                                      ((4, 9, 128), 9), ((1, 48, 128), 9)])
def test_paged_attention_at_encdec_and_dense_heads(cuda_device, kind, heads,
                                                   T_):
    """whisper's G = 1, internvl2's G = 7 (D = 64), starcoder2's G = 9 and
    granite's G = 48 (D = 128: 48 rows a decode block, 96 a 32-token
    chunk), 16-token pages, their served tables, full attention, one
    partition and the planner's pick; held as the danube edges are."""
    qk, positions, start, pool, tables, fmt, Tq, G_ = _paged_pool_case(
        cuda_device, kind=kind, fmt_name="kv_fp16", dtype=torch.bfloat16,
        seed=13, heads=heads, ps=16, T_=T_,
        ctx=16 * T_ - (40 if kind == "chunk" else 12))
    assert G_ == heads[1]
    B, C = positions.shape
    rows = (positions >= 0).reshape(B, C // Tq, Tq, 1) \
        .expand(B, C // Tq, Tq, G_).reshape(B, 1, C // Tq, Tq * G_)
    planned = planning.choose_kv_partitions(
        B, heads[0], T_, q_tiles=C // Tq, cores=planning.num_cores("cuda"))
    for S in sorted({1, planned}):
        kw = dict(Tq=Tq, G=G_, S=S, window=0, fmt=fmt)
        args = (qk, positions, start, pool, tables)
        before = tpa.PAGED_ATTENTION.launches
        got = tpa._launch_partials(*args, **kw)
        assert tpa.PAGED_ATTENTION.launches == before + 1
        want = tpa.pooled_partials_plain(*args, **kw)
        torch.cuda.synchronize()
        out_p = _combine_partials(*want)
        d = torch.where(rows[..., None],
                        (_combine_partials(*got) - out_p).abs(), 0.0)
        assert bool((d <= out_p.abs() * 2 ** -7 + 2e-3).all()), \
            (S, float(d.max()))


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
def test_flash_kernel_non_causal_at_whisper_encoder(cuda_device, dtype, tol):
    """whisper's encoder self-attention: 1500 frames, 12 heads of 64, no
    mask; held as ``test_flash_kernel_matches_plain`` holds the causal
    cases."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _flash_inputs(cuda_device, 1, 1500, 12, 12, 64, dtype, seed=3)
    o, lse = tfa.flash_attention_forward(q, k, v, causal=False, window=0)
    o_p, lse_p = tfa.flash_attention_plain(q, k, v, causal=False, window=0)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), o_p.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        w = o_p.float()
        rms = w.square().mean(dim=-1, keepdim=True).sqrt()
        assert bool(((o.float() - w).abs()
                     <= 2 ** -7 * w.abs() + 2 ** -5 * rms).all())
    torch.testing.assert_close(lse, lse_p, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-1b",
                                  "starcoder2-7b", "granite-20b"])
def test_encdec_and_vision_engine_kernel_path_matches_plain_path(
        cuda_device, arch):
    """REDUCED configs in fp32 through the kernels (whisper's encoder
    through the flash kernel): every decode step launches the W4A16 kernel
    once for each quantized linear (8 a layer for whisper, 6 for
    starcoder2's GELU MLP, 7 else) and paged attention once a layer;
    prefill logits match the plain path within fp32 summation order over
    two layers (1e-3), and so do greedy tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_reduced(arch)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    params = T.quantize_params(T.init_params(gen, cfg, device=cuda_device),
                               cfg, min_size=0)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    extra = [{} for _ in range(2)]
    for e in extra:
        if cfg.vision_prefix:
            e["prefix_embeds"] = rng.standard_normal(
                (cfg.vision_prefix, cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec":
            e["audio_embeds"] = rng.standard_normal(
                (cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    per_layer = {"encdec": 8}.get(cfg.family,
                                  7 if cfg.mlp_type == "swiglu" else 6)

    def run(strategy, path, attn_impl):
        eng = ServingEngine(dataclasses.replace(
            cfg, w4a16_strategy=strategy, attn_impl=attn_impl), params,
            max_batch=2, max_prompt_len=12, max_new_tokens=4, page_size=8,
            prefill_chunk=8, attn_path=path, device=cuda_device)
        eng.start()
        f0 = tfa.FLASH_ATTENTION.launches
        for i in range(2):
            eng.submit(Request(rid=i, prompt=toks[i], max_new_tokens=4,
                               **extra[i]))
        while eng.report.decode_tokens == 0:
            eng.step()
        flash = tfa.FLASH_ATTENTION.launches - f0
        n0 = (wf.W4A16_GEMM.launches, tpa.PAGED_ATTENTION.launches)
        eng.step()
        n1 = (wf.W4A16_GEMM.launches - n0[0],
              tpa.PAGED_ATTENTION.launches - n0[1])
        return eng.drain(), n1, flash

    fused, n, flash = run("auto", "auto", "flash")
    assert n == (cfg.num_layers * per_layer, cfg.num_layers)
    assert flash == (2 * cfg.encoder_layers if cfg.family == "encdec"
                     else 0)
    plain, n, flash = run("reference", "gather", "chunked")
    assert n == (0, 0) and flash == 0
    for rid in (0, 1):
        torch.testing.assert_close(fused.prefill_logits[rid],
                                   plain.prefill_logits[rid],
                                   rtol=1e-3, atol=1e-3)
    assert fused.results == plain.results


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b", "rwkv6-7b",
                                  "hymba-1.5b", "whisper-small",
                                  "internvl2-1b", "starcoder2-7b",
                                  "granite-20b"])
def test_family_train_step_kernel_path_matches_plain_path(cuda_device, arch):
    """One train step of each family (REDUCED, fp32, with remat; B = 4 x
    64 tokens and the launcher's own vision patches or audio frames)
    through the flash kernel and through the chunked attention from the
    same parameters: loss and grad norm within 1e-5 relative (fp32
    attention in two orders), the kernel launched twice per attention
    layer (forward and recompute; the encoder's included, none for rwkv)
    and not at all on the chunked path."""
    from repro_torch.launch import train as ttrain
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_reduced(arch), remat=True)
    stream = SyntheticTokenStream(vocab_size=cfg.vocab_size, seq_len=64,
                                  batch_size=4, device=cuda_device)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(1)
    batch = {**stream.batch_at(0),
             **ttrain.extra_inputs(cfg, 4, gen, cuda_device)}
    opt_cfg = AdamWConfig(lr=1e-3)
    out = {}
    for impl in ("flash", "chunked"):
        gen.manual_seed(0)
        params = T.init_params(gen, cfg, device=cuda_device)
        step = tsteps.make_train_step(
            dataclasses.replace(cfg, attn_impl=impl), opt_cfg)
        n0 = tfa.FLASH_ATTENTION.launches
        _, _, m = step(params, adamw_init(params, opt_cfg),
                       {"batch": batch, "step": 0})
        out[impl] = (float(m["loss"]), float(m["grad_norm"]),
                     tfa.FLASH_ATTENTION.launches - n0)
    attn_layers = 0 if cfg.attn_free else \
        cfg.num_layers + cfg.encoder_layers
    assert out["flash"][2] == 2 * attn_layers and out["chunked"][2] == 0
    for i in (0, 1):
        assert np.isfinite(out["flash"][i])
        assert abs(out["flash"][i] - out["chunked"][i]) \
            <= 1e-5 * abs(out["chunked"][i]), (out, i)
