"""The rest of the paper's GEMM family against the JAX package's Pallas
kernels, run in interpret mode as their own tests run them: the dense
``gemm`` (PERF row 2), the decoupled W4A16 pipeline and each of its phases
(row 3), ``w8a16_fused`` (row 5) and ``w4a8_fused`` (row 6), over the JAX
template tests' edge shapes (``tests/test_template.py``). On CPU tensors
the port's wrappers run their plain versions, which is what is compared;
the CUDA kernels are held against those plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).

Tolerances, for fp32 inputs of unit scale: both sides take exact fp32
products of the same values and differ only in fp32 summation order (and,
with Split-K, in where the partials are summed): rtol 1e-5, atol 1e-5. The
W4A8 group sums are exact integers on both sides, so only the fp32 sum
over groups is reordered: the same tolerance. bf16 activations: the bf16
output can round either way after a reordered fp32 sum: one bf16 ulp,
rtol 2^-7 (atol 1e-3). Phase 1 (dequant) and phase 3 with one slice are
the same fp32 operations on both sides and are compared exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.kernels import gemm as jgemm
from repro.kernels import w4a16_decoupled as jdec
from repro.kernels.w4a8_fused import w4a8_fused as jax_w4a8_fused
from repro.kernels.w8a16_fused import w8a16_fused as jax_w8a16_fused

from repro_torch.core import quant as tq
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import w4a16_decoupled as tdec
from repro_torch.kernels import w4a8_fused as tw4a8
from repro_torch.kernels import w8a16_fused as tw8a16

# one torch thread a test process (see its docstring)
import torch_parity_helpers  # noqa: F401

# (M, K, N) of tests/test_template.py: ragged M, K == group, N == 128 lanes,
# all three at once
EDGE_SHAPES = [(5, 256, 384), (8, 128, 256), (16, 256, 128), (3, 128, 128)]
FP32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2 ** -7, atol=1e-3)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _quantized(K, N, fmt, *, symmetric=True, seed=0):
    w = _rand((K, N), seed, K ** -0.5)
    j = jq.quantize(jnp.asarray(w), fmt, symmetric=symmetric)
    t = tq.QuantizedTensor(
        torch.from_numpy(np.array(j.packed)),
        torch.from_numpy(np.array(j.scales)),
        None if j.zeros is None else torch.from_numpy(np.array(j.zeros)),
        j.group_size, torch.float32, tq.resolve_format(j.format.to_dict()))
    return j, t


# ---------------------------------------------------------------------------
# row 2: the dense GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,K,N", EDGE_SHAPES)
def test_gemm_matches_jax(M, K, N):
    x, w = _rand((M, K), 1), _rand((K, N), 2, K ** -0.5)
    want = np.asarray(jgemm.gemm(jnp.asarray(x), jnp.asarray(w),
                                 interpret=True))
    got = tgemm.gemm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, **FP32)
    np.testing.assert_allclose(
        got.numpy(), ref.gemm_ref(torch.from_numpy(x),
                                  torch.from_numpy(w)).numpy(), **FP32)


def test_gemm_bf16_matches_jax():
    x, w = _rand((5, 256), 3), _rand((256, 384), 4, 256 ** -0.5)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = np.asarray(jgemm.gemm(xb, wb, interpret=True).astype(jnp.float32))
    got = tgemm.gemm(torch.from_numpy(x).bfloat16(),
                     torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)


def test_dense_launch_checks():
    """What the CUDA launch refuses, checked before any launch."""
    x, w = torch.zeros(4, 256), torch.zeros(256, 64)
    with pytest.raises(ValueError, match="x's dtype"):
        tgemm.launch_dense(x, w.bfloat16(), 1, direct=True)
    with pytest.raises(ValueError, match="multiples of 32"):
        tgemm.launch_dense(x, w, 16, direct=False)
    with pytest.raises(ValueError, match="split_k == 1"):
        tgemm.launch_dense(x, w, 2, direct=True)
    with pytest.raises(ValueError, match="N % 16"):
        tgemm.launch_dense(x, torch.zeros(256, 40), 1, direct=True)
    with pytest.raises(ValueError, match="chain"):
        tgemm.gemm(x, torch.zeros(128, 64))


# ---------------------------------------------------------------------------
# row 3: the decoupled pipeline and its phases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,N,group,symmetric", [(256, 128, 128, True),
                                                 (512, 256, 64, False)])
def test_phase1_dequant_matches_jax(K, N, group, symmetric):
    j, t = _quantized(K, N, jq.W4A16_G128.with_group_size(group),
                      symmetric=symmetric)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jdec.dequant_w4(j, out_dtype=jdt, interpret=True)
                          .astype(jnp.float32))
        got = tdec.dequant_w4(t, out_dtype=tdt)
        assert got.dtype == tdt and got.shape == (K, N)
        np.testing.assert_array_equal(got.float().numpy(), want)
    with pytest.raises(ValueError, match="int4_pairs_k"):
        tdec.dequant_w4(tq.quantize(torch.zeros(128, 16), "w8a16_channel"))


@pytest.mark.parametrize("S", [1, 2, 4])
def test_phase2_splitk_partials_match_jax(S):
    x, w = _rand((5, 512), 5), _rand((512, 256), 6, 512 ** -0.5)
    want = np.asarray(jdec.splitk_gemm(jnp.asarray(x), jnp.asarray(w),
                                       split_k=S, interpret=True))
    got = tdec.splitk_gemm(torch.from_numpy(x), torch.from_numpy(w),
                           split_k=S)
    assert got.shape == want.shape == (S, 5, 256)
    np.testing.assert_allclose(got.numpy(), want, **FP32)


@pytest.mark.parametrize("S", [1, 3])
def test_phase3_reduce_matches_jax(S):
    parts = _rand((S, 6, 256), 7)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jdec.reduce_partials(
            jnp.asarray(parts), out_dtype=jdt, interpret=True)
            .astype(jnp.float32))
        got = tdec.reduce_partials(torch.from_numpy(parts), out_dtype=tdt)
        assert got.dtype == tdt and got.shape == (6, 256)
        if S == 1:
            np.testing.assert_array_equal(got.float().numpy(), want)
        else:
            np.testing.assert_allclose(got.float().numpy(), want,
                                       **(FP32 if tdt == torch.float32
                                          else BF16))


@pytest.mark.parametrize("M,K,N,split_k,symmetric", [
    (5, 256, 384, 2, True), (8, 512, 128, 4, False), (3, 128, 128, 1, True)])
def test_w4a16_decoupled_matches_jax(M, K, N, split_k, symmetric):
    j, t = _quantized(K, N, "w4a16_g128", symmetric=symmetric, seed=8)
    x = _rand((M, K), 9)
    want = np.asarray(jdec.w4a16_decoupled(jnp.asarray(x), j,
                                           split_k=split_k, interpret=True))
    got = tdec.w4a16_decoupled(torch.from_numpy(x), t, split_k=split_k)
    np.testing.assert_allclose(got.numpy(), want, **FP32)
    assert torch.equal(got, tdec.w4a16_decoupled_plain(
        torch.from_numpy(x), t, split_k=split_k))


def test_strategies_agree_through_ops():
    """ops.w4a16_matmul forces each W4A16 strategy (on CPU tensors the
    kernel strategies run their plain versions) over leading dims."""
    _, t = _quantized(256, 128, "w4a16_g128", seed=10)
    x = torch.from_numpy(_rand((2, 3, 256), 11))
    outs = {s: ops.w4a16_matmul(x, t, strategy=s, split_k=2 if s in (
        "fused", "decoupled") else None)
        for s in ("reference", "fused", "decoupled", "auto")}
    for s, y in outs.items():
        assert y.shape == (2, 3, 128), s
        np.testing.assert_allclose(y.numpy(), outs["reference"].numpy(),
                                   **FP32, err_msg=s)


# ---------------------------------------------------------------------------
# rows 5 and 6: the fused W8A16 and W4A8 kernels
# ---------------------------------------------------------------------------

def _split_cases(group_of_k):
    for M, K, N in EDGE_SHAPES:
        for split_k in (1, 2):
            if (K // split_k) % group_of_k(K) == 0:
                yield M, K, N, split_k


@pytest.mark.parametrize("M,K,N,split_k",
                         list(_split_cases(lambda K: 1)))
@pytest.mark.parametrize("symmetric", [True, False])
def test_w8a16_fused_matches_jax(M, K, N, split_k, symmetric):
    j, t = _quantized(K, N, "w8a16_channel", symmetric=symmetric, seed=12)
    x = _rand((M, K), 13)
    want = np.asarray(jax_w8a16_fused(jnp.asarray(x), j, split_k=split_k,
                                      interpret=True))
    got = tw8a16.w8a16_fused(torch.from_numpy(x), t, split_k=split_k)
    np.testing.assert_allclose(got.numpy(), want, **FP32)


def test_w8a16_fused_bf16_and_refusals():
    """bf16: the dequantized tile is rounded to bf16 before the product, as
    in the Pallas stage. A W4A16 tensor is refused (wrong packing)."""
    j, t = _quantized(256, 384, "w8a16_channel", seed=14)
    x = _rand((5, 256), 15)
    want = np.asarray(jax_w8a16_fused(jnp.asarray(x, jnp.bfloat16), j,
                                      interpret=True).astype(jnp.float32))
    got = tw8a16.w8a16_fused(torch.from_numpy(x).bfloat16(), t)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)
    _, t4 = _quantized(256, 384, "w4a16_g128")
    with pytest.raises(ValueError, match="int8_rows"):
        tw8a16.w8a16_fused(torch.from_numpy(x), t4)


@pytest.mark.parametrize("M,K,N,split_k",
                         list(_split_cases(lambda K: 128)))
@pytest.mark.parametrize("symmetric", [True, False])
def test_w4a8_fused_matches_jax(M, K, N, split_k, symmetric):
    j, t = _quantized(K, N, "w4a8_g128", symmetric=symmetric, seed=16)
    x = _rand((M, K), 17)
    want = np.asarray(jax_w4a8_fused(jnp.asarray(x), j, split_k=split_k,
                                     interpret=True))
    got = tw4a8.w4a8_fused(torch.from_numpy(x), t, split_k=split_k)
    np.testing.assert_allclose(got.numpy(), want, **FP32)
    np.testing.assert_allclose(
        got.numpy(), tq.w4a8_matmul_ref(torch.from_numpy(x), t).numpy(),
        **FP32)


@pytest.mark.parametrize("split_k", [4, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("symmetric", [True, False])
def test_w4a8_fused_splits_and_bf16_match_jax(split_k, dtype, symmetric):
    """Group 32 over K = 512: split_k 4 is summed inside one cluster on the
    card, 16 (beyond MAX_CLUSTER) takes the partials route; the output in
    x's dtype, fp32 or bf16 (one bf16 ulp after the reordered fp32 sum)."""
    K, N, M = 512, 128, 5
    w = _rand((K, N), 18, K ** -0.5)
    j = jq.quantize(jnp.asarray(w), "w4a8_g128", group_size=32,
                    symmetric=symmetric)
    t = tq.QuantizedTensor(
        torch.from_numpy(np.array(j.packed)),
        torch.from_numpy(np.array(j.scales)),
        None if j.zeros is None else torch.from_numpy(np.array(j.zeros)),
        j.group_size, torch.float32, tq.resolve_format(j.format.to_dict()))
    assert t.group_size == 32
    x = _rand((M, K), 19)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(jax_w4a8_fused(jx, j, split_k=split_k,
                                     interpret=True).astype(jnp.float32))
    got = tw4a8.w4a8_fused(torch.from_numpy(x).to(getattr(torch, dtype)), t,
                           split_k=split_k)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want,
                               **(FP32 if dtype == "float32" else BF16))


def test_w4a8_fused_refusals():
    _, t = _quantized(256, 128, "w4a8_g128")
    x = torch.zeros(2, 256)
    with pytest.raises(ValueError, match="group-aligned"):
        tw4a8.w4a8_fused(x, t, split_k=4)
    _, t8 = _quantized(256, 128, "w8a16_channel")
    with pytest.raises(ValueError, match="int4_pairs_k"):
        tw4a8.w4a8_fused(x, t8)
