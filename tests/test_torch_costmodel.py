"""The port's copy of the JAX package's Ascend 910 and TPU v5e cost
models (``repro_torch/core/costmodel.py``) against the JAX package's own
(``repro/core/costmodel.py``): every term at the paper's GEMM grid
(``PAPER_GEMM_SHAPES`` x ``PAPER_BATCH_SIZES``), equal to 1e-12 relative
(the same float operations in the same order: any difference is a
transcription error). No JAX array is made: both modules are plain
arithmetic."""
import dataclasses
import itertools
import math

import pytest

from repro.core import costmodel as jcm

from repro_torch.configs import PAPER_BATCH_SIZES, PAPER_GEMM_SHAPES
from repro_torch.core import costmodel as cm

import torch_parity_helpers  # noqa: F401  (one torch thread)

GRID = [(M, N, K) for (N, K), M in itertools.product(PAPER_GEMM_SHAPES,
                                                     PAPER_BATCH_SIZES)]
REL = 1e-12

GEMM_TERMS = ["gemm_time_ascend", "w4a16_time_ascend", "fp16_time_ascend",
              "best_split_k_ascend", "splitk_speedup_ascend",
              "w4a16_speedup_ascend", "w4a16_time_tpu_fused",
              "w4a16_time_tpu_decoupled", "fp16_time_tpu",
              "w8a16_time_tpu_fused", "w4a8_time_tpu_fused"]


def _close(got, want):
    assert math.isclose(got, want, rel_tol=REL, abs_tol=0.0), (got, want)


def test_specs_and_names_are_jax():
    """The 18 names exist in the port, the specs field for field."""
    names = ["AscendSpec", "ASCEND", "TPUv5eSpec", "TPU_V5E", "_ceil_div",
             "_wave_efficiency", *GEMM_TERMS, "attn_decode_time_tpu"]
    assert len(names) == 18 and all(hasattr(cm, n) for n in names)
    assert dataclasses.asdict(cm.ASCEND) == dataclasses.asdict(jcm.ASCEND)
    assert dataclasses.asdict(cm.TPU_V5E) == dataclasses.asdict(jcm.TPU_V5E)
    for a, b in itertools.product((0, 1, 7, 32, 33, 1000), (1, 3, 32)):
        assert cm._ceil_div(a, b) == jcm._ceil_div(a, b)
        assert cm._wave_efficiency(a, b) == jcm._wave_efficiency(a, b)


@pytest.mark.parametrize("term", GEMM_TERMS)
def test_gemm_terms_match_jax_on_the_paper_grid(term):
    port, jax_ = getattr(cm, term), getattr(jcm, term)
    for M, N, K in GRID:
        _close(port(M, N, K), jax_(M, N, K))


@pytest.mark.parametrize("split_k", [1, 2, 4, 8, 16])
def test_split_terms_match_jax(split_k):
    for M, N, K in GRID:
        _close(cm.w4a16_time_ascend(M, N, K, split_k=split_k),
               jcm.w4a16_time_ascend(M, N, K, split_k=split_k))
        _close(cm.w4a16_time_tpu_decoupled(M, N, K, split_k=split_k),
               jcm.w4a16_time_tpu_decoupled(M, N, K, split_k=split_k))
        for wb, bw in ((0.5, None), (2.0, cm.ASCEND.bw_l2)):
            _close(cm.gemm_time_ascend(M, N, K, split_k=split_k,
                                       weight_bytes_per_elt=wb,
                                       weight_bw=bw),
                   jcm.gemm_time_ascend(M, N, K, split_k=split_k,
                                        weight_bytes_per_elt=wb,
                                        weight_bw=bw))


def test_the_papers_claims_as_jax_models_them():
    """The calibrated Ascend model's Split-K speedup range and W4A16 cap
    over the grid, as the JAX package's own test reads them."""
    sk = [cm.splitk_speedup_ascend(M, N, K) for M, N, K in GRID]
    w4 = [cm.w4a16_speedup_ascend(M, N, K) for M, N, K in GRID]
    assert sk == [jcm.splitk_speedup_ascend(M, N, K) for M, N, K in GRID]
    assert w4 == [jcm.w4a16_speedup_ascend(M, N, K) for M, N, K in GRID]
    assert min(sk) >= 1.0 and max(sk) < 1.8
    assert max(w4) < 1.5
    for M, N, K in GRID:
        assert cm.w4a8_time_tpu_fused(M, N, K, group=64) == \
            jcm.w4a8_time_tpu_fused(M, N, K, group=64)


@pytest.mark.parametrize("path,quantized", [
    ("ring", False), ("gather", False), ("gather", True), ("fused", False),
    ("fused", True)])
def test_attn_decode_time_tpu_matches_jax(path, quantized):
    """(The ring stores no quantized format.)"""
    for B, Hq, Hkv, D, ctx, parts, q_len in itertools.product(
            (1, 8), (32,), (8, 1), (80, 128), (544, 4096), (1, 4), (1, 5)):
        kw = dict(quantized=quantized, kv_partitions=parts, q_len=q_len)
        _close(cm.attn_decode_time_tpu(path, B, Hq, Hkv, D, ctx, **kw),
               jcm.attn_decode_time_tpu(path, B, Hq, Hkv, D, ctx, **kw))
    with pytest.raises(ValueError, match="unknown attention path"):
        cm.attn_decode_time_tpu("nope", 1, 1, 1, 8, 8, quantized=False)
