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
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import w4a8_fused as tw4a8
from repro_torch.kernels import w4a16_decoupled as tdec
from repro_torch.kernels import w4a16_fused as wf
from repro_torch.kernels import w8a16_fused as tw8a16
from repro_torch.models import transformer as T
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
    the same order, so they agree exactly; the pipeline within the GEMM's
    tolerance."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(3)
    for M, N, split_k, symmetric in ((8, 640, 4, True), (32, 144, 2, False),
                                     (3, 640, 1, False)):
        x, w = _operands(rng, cuda_device, M, 1024, N, dtype)
        qt = tq.quantize(w, symmetric=symmetric)
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w4a8_kernel_matches_plain(cuda_device, dtype):
    """Exact int32 group sums on both sides: only the fp32 sum over groups
    is reordered. Group 64 takes the 32-row tile."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    for M, N, split_k, symmetric, group in ((1, 640, 1, True, 128),
                                            (8, 144, 4, False, 128),
                                            (40, 640, 2, True, 64),
                                            (32, 144, 1, False, 32)):
        x, w = _operands(rng, cuda_device, M, 1024, N, dtype)
        qt = tq.quantize(w, "w4a8_g128", group_size=group,
                         symmetric=symmetric)
        torch.testing.assert_close(
            tw4a8.w4a8_fused(x, qt, split_k=split_k).float(),
            tw4a8.w4a8_fused_plain(x, qt, split_k=split_k).float(),
            **_tol(dtype))
    torch.cuda.synchronize()


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
