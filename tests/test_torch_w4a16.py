"""The W4A16 GEMM: the JAX package's Pallas kernel (``w4a16_fused``, run in
interpret mode as its own tests run it) against the port's plain version,
which is what the port's wrapper runs on CPU tensors; the wrapper's
operand checks; and, on the card only, the CUDA kernel against the plain
version.

Tolerances: fp32 activations — both sides take exact products of the same
dequantized values and differ only in fp32 summation order (and, with
split_k = 2, in where the partials are summed): rtol 1e-5, atol 1e-5 on
unit-scale outputs. bf16 activations — the bf16 output can round either
way after a reordered fp32 sum: one bf16 ulp, rtol 2^-7.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.kernels.w4a16_fused import w4a16_fused as jax_w4a16_fused

from repro_torch.core import quant as tq
from repro_torch.kernels import w4a16_fused as wf

# one torch thread a test process (see its docstring)
import torch_parity_helpers  # noqa: F401


def _case(M, K, N, *, group=128, symmetric=True, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    j = jq.quantize(jnp.asarray(w), group_size=group, symmetric=symmetric)
    t = tq.QuantizedTensor(
        torch.from_numpy(np.array(j.packed)),
        torch.from_numpy(np.array(j.scales)),
        None if j.zeros is None else torch.from_numpy(np.array(j.zeros)),
        j.group_size, torch.float32)
    return x, j, t


@pytest.mark.parametrize("split_k", [1, 2])
@pytest.mark.parametrize("M,symmetric", [(5, True), (8, False)])
def test_plain_matches_jax_kernel_interpret(split_k, M, symmetric):
    x, j, t = _case(M, 256, 128, symmetric=symmetric)
    want = np.asarray(jax_w4a16_fused(jnp.asarray(x), j, split_k=split_k,
                                      interpret=True))
    got = wf.w4a16_fused(torch.from_numpy(x), t, split_k=split_k)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # on a CPU tensor the wrapper is exactly the plain version
    assert torch.equal(got, wf.w4a16_fused_plain(torch.from_numpy(x), t,
                                                 split_k=split_k))


def test_plain_bf16_rounds_the_dequantized_tile():
    """bf16 activations: the dequantized tile is rounded to bf16 before
    the product, as in the Pallas kernel (compute_dtype = x.dtype)."""
    x, j, t = _case(4, 256, 64, seed=1)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax_w4a16_fused(xb, j, interpret=True)
                      .astype(jnp.float32))
    got = wf.w4a16_fused(torch.from_numpy(x).to(torch.bfloat16), t)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-3)


def test_split_k_must_divide_k():
    x, _, t = _case(2, 256, 64)
    with pytest.raises(ValueError, match="must divide"):
        wf.w4a16_fused(torch.from_numpy(x), t, split_k=3)
    with pytest.raises(ValueError):
        wf.w4a16_fused(torch.from_numpy(x[:, :128]), t)


def test_kernel_operand_checks():
    """What the CUDA wrapper refuses, checked in Python before any launch
    (the checks run on any device)."""
    x, _, t = _case(2, 256, 64)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wf._check_kernel_operands(xb, t, 2)            # a shape it takes
    wf._check_kernel_operands(torch.from_numpy(x), t, 1)     # fp32 too
    with pytest.raises(ValueError, match="bf16/fp16/fp32"):
        wf._check_kernel_operands(torch.from_numpy(x).double(), t, 1)
    with pytest.raises(ValueError, match="multiples of 32"):
        wf._check_kernel_operands(xb, t, 16)
    x2, _, t2 = _case(2, 256, 40)
    with pytest.raises(ValueError, match="N % 16"):
        wf._check_kernel_operands(torch.from_numpy(x2).to(torch.bfloat16),
                                  t2, 1)
    with pytest.raises(ValueError, match="contiguous"):
        wf._check_kernel_operands(xb.t().contiguous().t(), t, 1)
