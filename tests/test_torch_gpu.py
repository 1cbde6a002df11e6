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
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import w4a16_fused as wf
from repro_torch.models import transformer as T
from repro_torch.runtime import kvcache as kvc
from repro_torch.runtime.engine import Request, ServingEngine

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs on the GPU machine)")
    return torch.device("cuda")


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
