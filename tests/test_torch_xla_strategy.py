"""JAX's ``xla`` matmul strategy in the port's planner
(``repro_torch/kernels/planning.py``): registered as a plain strategy for
the float-activation formats, never ranked above ``reference``, forced by
name on either device, and loaded from a JAX-written plan cache; its
product against JAX's ``_run_xla`` on the same quantized weights.

Tolerances, as ``tests/test_torch_gemm_family.py`` states them: fp32
activations of unit scale take exact fp32 products of the same values on
both sides and differ only in summation order (rtol 1e-5, atol 1e-5);
bf16 activations can round the bf16 output either way after a reordered
fp32 sum (one bf16 ulp: rtol 2^-7, atol 1e-3)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.kernels import planning as jplanning

from repro_torch.core import quant as tq
from repro_torch.kernels import planning

import torch_parity_helpers  # noqa: F401  (one torch thread)

FP32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2 ** -7, atol=1e-3)
CASES = [(1, 256, 128, "w4a16_g128"), (5, 256, 384, "w4a16_g128"),
         (8, 128, 256, "w4a16_g64"), (16, 256, 128, "w8a16_channel"),
         (3, 128, 128, "w4a16_g128_asym")]


def _weights(K, N, fmt, out_dtype, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    name, _, group = fmt.replace("_asym", "").partition("_g")
    f = jq.get_format(fmt if name == "w8a16" else "w4a16_g128")
    j = jq.quantize(jnp.asarray(w), f, symmetric="_asym" not in fmt,
                    group_size=int(group) if group else None)
    j = jq.QuantizedTensor(j.packed, j.scales, j.zeros, j.group_size,
                           jnp.bfloat16 if out_dtype == torch.bfloat16
                           else jnp.float32, j.format)
    t = tq.QuantizedTensor(
        torch.from_numpy(np.array(j.packed)),
        torch.from_numpy(np.array(j.scales)),
        None if j.zeros is None else torch.from_numpy(np.array(j.zeros)),
        j.group_size, out_dtype, tq.resolve_format(j.format.to_dict()))
    return j, t


@pytest.mark.parametrize("M,K,N,fmt", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xla_matches_jax_run_xla(M, K, N, fmt, dtype):
    tdt = getattr(torch, dtype)
    j, t = _weights(K, N, fmt, tdt)
    x = np.random.default_rng(1).standard_normal((M, K)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jplan = jplanning.KernelPlan(strategy="xla", out_dtype=dtype)
    want = np.asarray(jplanning.get_strategy("xla").execute(jx, j, jplan),
                      np.float32)
    plan = planning.plan_matmul(
        planning.MatmulProblem.from_operands(torch.from_numpy(x).to(tdt), t),
        strategy="xla")
    assert plan.strategy == "xla" and plan.out_dtype == dtype
    got = planning.execute(plan, torch.from_numpy(x).to(tdt), t)
    assert got.dtype == tdt and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(got.float().numpy(), want,
                               **(FP32 if dtype == "float32" else BF16))


def test_xla_is_plain_and_ranks_below_reference():
    """On the CPU the planner keeps ``reference`` (the same cost, the
    earlier registration); a CUDA problem never ranks ``xla``, and forcing
    it by name plans it anywhere, as ``reference``."""
    strat = planning.get_strategy("xla")
    assert strat.batched and not strat.splittable
    for fmt in ("w4a16_g128", "w8a16_channel"):
        assert "xla" in planning.strategies_for_format(fmt)
    assert "xla" not in planning.strategies_for_format("w4a8_g128")
    for backend, want in (("cpu", "reference"), ("cuda", "fused")):
        prob = planning.MatmulProblem(M=8, N=2560, K=2560, backend=backend)
        assert planning.plan_matmul(prob, use_cache=False).strategy == want
        assert not strat.supports(prob) if backend == "cuda" \
            else strat.supports(prob)
        assert planning.plan_matmul(prob, strategy="xla").strategy == "xla"
    with pytest.raises(ValueError, match="does not support"):
        planning.plan_matmul(planning.MatmulProblem(
            M=1, N=16, K=128, format="w4a8_g128"), strategy="xla")


def test_jax_plan_cache_naming_xla_loads_and_runs(tmp_path):
    """A plan cache JAX's planner wrote on the CPU, where it picks ``xla``
    for every problem: the port loads each plan, and the loaded plan runs
    JAX's product."""
    path = str(tmp_path / "jax.json")
    jcache = jplanning.PlanCache()
    probs = [jplanning.MatmulProblem(M=M, N=N, K=K, backend="cpu",
                                     act_dtype="float32",
                                     out_dtype="float32", format=fmt)
             for M, K, N, fmt in CASES[:4]]
    for p in probs:
        jcache.put(p, jplanning.plan_matmul(p, use_cache=False))
    assert {p.strategy for p in jcache._plans.values()} == {"xla"}
    jcache.save(path)
    cache = planning.PlanCache()
    assert cache.load(path) == len(probs)
    for (M, K, N, fmt), p in zip(CASES[:4], probs):
        tprob = planning.MatmulProblem.from_dict(p.to_dict())
        plan = cache._plans[tprob]
        assert plan.strategy == "xla"
        j, t = _weights(K, N, fmt, torch.float32)
        x = np.random.default_rng(2).standard_normal((M, K)) \
            .astype(np.float32)
        want = np.asarray(jplanning.execute(
            jcache._plans[p], jnp.asarray(x), j))
        got = planning.execute(plan, torch.from_numpy(x), t)
        np.testing.assert_allclose(got.numpy(), want, **FP32)


def test_xla_runs_an_expert_stack_whole():
    """``batched``: an (E, M, K) stack against (E, K/2, N) weights in one
    call, equal to the per-expert products."""
    rng = np.random.default_rng(3)
    ones = [tq.quantize(torch.from_numpy(
        (rng.standard_normal((256, 128)) * 0.06).astype(np.float32)),
        tq.get_format("w4a16_g128"), out_dtype=torch.float32)
        for _ in range(2)]
    qt = tq.QuantizedTensor(torch.stack([q.packed for q in ones]),
                            torch.stack([q.scales for q in ones]), None,
                            128, torch.float32, ones[0].format)
    x = torch.from_numpy(rng.standard_normal((2, 4, 256)).astype(np.float32))
    plan = planning.KernelPlan(strategy="xla", out_dtype="float32")
    whole = planning.execute(plan, x, qt)
    assert tuple(whole.shape) == (2, 4, 128)
    for e, one in enumerate(ones):
        np.testing.assert_allclose(
            whole[e].numpy(), planning.execute(plan, x[e], one).numpy(),
            **FP32)
