"""The port's W8A16 and W4A8 formats against the JAX package: the format
registry, the stored bytes of ``int8_rows``/``channel`` quantization,
dynamic INT8 activations bit for bit, the W4A8 oracle, leaves carried
across by ``from_jax_params`` with their format, the planner's refusals
(mirroring ``tests/test_formats.py``) and its unchanged danube W4A16 plans,
and greedy-token parity of the engine on REDUCED danube for each new format
and for the decoupled pipeline. Inputs come from numpy with a fixed seed.

Tolerances: quantization and activation quantization are the same fp32
IEEE sequence on both sides, so they are compared exactly; the matmul
oracles sum fp32 terms in another order (rtol 1e-5, atol 1e-5 on
unit-scale outputs); engine runs are fp32 and must give identical tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import quant as jq
from repro.models import transformer as JT
from repro.runtime.engine import Request as JRequest
from repro.runtime.engine import ServingEngine as JServingEngine

from repro_torch import configs
from repro_torch.convert import from_jax_params
from repro_torch.core import quant as tq
from repro_torch.kernels import planning
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as T
from repro_torch.runtime.engine import Request, ServingEngine

from torch_parity_helpers import jax_to_numpy

ARCH = "h2o-danube-1.8b"


def _w(K=256, N=48, seed=0):
    return (np.random.default_rng(seed).standard_normal((K, N))
            * K ** -0.5).astype(np.float32)


def test_format_registry_matches_jax():
    for name in ("w4a16_g128", "w8a16_channel", "w4a8_g128"):
        assert tq.get_format(name).to_dict() == jq.get_format(name).to_dict()
        for K in (128, 256, 6912):
            assert tq.get_format(name).scale_rows(K) == \
                jq.get_format(name).scale_rows(K)
    assert tq.W4A8_G128.quantized_activations
    assert not tq.W8A16_CHANNEL.quantized_activations
    assert tq.W8A16_CHANNEL.pack_factor == 1
    # channel formats have no groups to re-size
    assert tq.W8A16_CHANNEL.with_group_size(64) is tq.W8A16_CHANNEL
    assert tq.W4A8_G128.with_group_size(64).name == "w4a8_g64"


@pytest.mark.parametrize("fmt,symmetric", [
    ("w8a16_channel", True), ("w8a16_channel", False),
    ("w4a8_g128", True), ("w4a8_g128", False)])
def test_quantize_bytes_match_jax(fmt, symmetric):
    """int8_rows/channel and w4a8 quantization store the JAX bytes; the
    dequantized weight and the unpacked rows agree exactly."""
    w = _w()
    t = tq.quantize(torch.from_numpy(w), fmt, symmetric=symmetric)
    j = jq.quantize(jnp.asarray(w), fmt, symmetric=symmetric)
    assert t.format.to_dict() == j.format.to_dict()
    assert (t.K, t.N, t.group_size) == (j.K, j.N, j.group_size)
    np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
    np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    if symmetric:
        assert t.zeros is None and j.zeros is None
    else:
        np.testing.assert_array_equal(t.zeros.numpy(), np.asarray(j.zeros))
    np.testing.assert_array_equal(tq.dequantize(t).numpy(),
                                  np.asarray(jq.dequantize(j)))
    np.testing.assert_array_equal(
        tq.unpack_weights(t.packed, t.format).numpy(),
        np.asarray(jq.unpack_weights(j.packed, j.format)))
    np.testing.assert_array_equal(tq.quantization_error_bound(t).numpy(),
                                  np.asarray(jq.quantization_error_bound(j)))
    if t.format.scale_granularity == "channel":
        for a, b in zip(tq.per_channel_scales(t), jq.per_channel_scales(j)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    else:
        with pytest.raises(ValueError, match="group-granular"):
            tq.per_channel_scales(t)


def test_quantize_activations_int8_bit_exact():
    """Per-token scales and int8 codes equal to the bit, ties at .5 round
    to even on both sides, an all-zero row takes the 1e-8 floor."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((6, 200)) * 3).astype(np.float32)
    x[2] = 0.0
    x[3, :4] = [127.0, 0.5, 1.5, -2.5]       # amax 127 → s = 1: exact ties
    x[3, 4:] = 0.0
    q, s = tq.quantize_activations_int8(torch.from_numpy(x))
    jqv, js = jq.quantize_activations_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.shape == (6, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q.numpy()[3, :4], [127, 0, 2, -2])
    assert s.numpy()[2, 0] == np.float32(1e-8)


@pytest.mark.parametrize("symmetric", [True, False])
def test_w4a8_matmul_ref_matches_jax(symmetric):
    w = _w(256, 64, seed=2)
    x = np.random.default_rng(3).standard_normal((2, 3, 256)) \
        .astype(np.float32)
    t = tq.quantize(torch.from_numpy(w), "w4a8_g128", symmetric=symmetric)
    j = jq.quantize(jnp.asarray(w), "w4a8_g128", symmetric=symmetric)
    got = tq.w4a8_matmul_ref(torch.from_numpy(x), t)
    assert got.shape == (2, 3, 64)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jq.w4a8_matmul_ref(jnp.asarray(x), j)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fmt,K", [("w8a16_channel", 256),
                                   ("w4a8_g128", 256), ("w4a8_g128", 96)])
def test_convert_carries_the_format(fmt, K):
    """Quantized in JAX (K=96 takes w4a8's adaptive group fallback to 32),
    carried across with the same K, N, format and bytes; dequantize
    agrees."""
    w = np.random.default_rng(4).standard_normal((K, 32)).astype(np.float32)
    j = jq.quantize(jnp.asarray(w), jq.get_format(fmt).with_group_size(
        128 if K % 128 == 0 else 32))
    leaf = jax_to_numpy({"kernel": j})["kernel"]
    t = from_jax_params({"kernel": leaf}, dtype=torch.float32)["kernel"]
    assert (t.K, t.N) == (j.K, j.N) == (K, 32)
    assert t.format.to_dict() == j.format.to_dict()
    np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
    np.testing.assert_array_equal(tq.dequantize(t).numpy(),
                                  np.asarray(jq.dequantize(j)))
    # a format given by name resolves too; a leaf without one is refused
    named = dict(leaf, format=j.format.name)
    assert from_jax_params(named, dtype=torch.float32).format == t.format
    bare = {k: v for k, v in leaf.items() if k != "format"}
    with pytest.raises(ValueError, match="format"):
        from_jax_params(bare, dtype=torch.float32)


@pytest.mark.parametrize("fmt", ["w8a16_channel", "w4a8_g128"])
def test_quantize_tree_formats_match_jax(fmt):
    """``format=`` reaches every quantized leaf as in JAX, stacked layers
    included, and w4a8's adaptive group fallback (K = 96 → group 32)
    stores the JAX bytes; embed and lm_head stay dense."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH), quant_format=fmt)
    cfg = dataclasses.replace(configs.get_reduced(ARCH), quant_format=fmt)
    dense = JT.init_params(jax.random.PRNGKey(3), jcfg)
    dense["extra"] = {"kernel": jnp.asarray(_w(96, 64, seed=5))}
    want = jax_to_numpy(JT.quantize_params(dense, jcfg, min_size=0))
    got = T.quantize_params(from_jax_params(jax_to_numpy(dense),
                                            dtype=cfg.dtype), cfg,
                            min_size=0)
    leaves = [(got["layers"]["attn"][n]["kernel"],
               want["layers"]["attn"][n]["kernel"]) for n in ("wq", "wo")]
    leaves += [(got["layers"]["mlp"]["w_down"]["kernel"],
                want["layers"]["mlp"]["w_down"]["kernel"]),
               (got["extra"]["kernel"], want["extra"]["kernel"])]
    for t, j in leaves:
        assert t.format.to_dict() == j["format"]
        np.testing.assert_array_equal(t.packed.numpy(), j["packed"])
        np.testing.assert_array_equal(t.scales.numpy(), j["scales"])
    assert got["extra"]["kernel"].group_size == \
        (96 if fmt == "w8a16_channel" else 32)
    assert isinstance(got["lm_head"]["kernel"], torch.Tensor)


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_plan_matmul_refuses_unsupported_strategy_format_pair(backend):
    problem = planning.MatmulProblem(M=4, N=64, K=256, format="w4a8_g128",
                                     backend=backend)
    for strategy in ("fused", "decoupled", "reference"):
        with pytest.raises(ValueError) as ei:
            planning.plan_matmul(problem, strategy=strategy)
        msg = str(ei.value)
        assert "w4a8_g128" in msg and strategy in msg
        assert "w4a8_xla" in msg and "w4a8_fused" in msg
    with pytest.raises(ValueError, match="does not support"):
        planning.plan_matmul(planning.MatmulProblem(
            M=4, N=64, K=256, group_size=256, format="w8a16_channel",
            backend=backend), strategy="fused")
    with pytest.raises(ValueError, match="cannot execute"):
        planning.execute(planning.KernelPlan(strategy="fused"),
                         torch.zeros(2, 256),
                         tq.quantize(torch.from_numpy(_w(256, 64)),
                                     "w4a8_g128"))


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_planner_refuses_shape_ineligible_w4a8(backend):
    """K not group-divisible: no w4a8 strategy on either device can run
    it, and the planner refuses at plan time, never falling to a plain
    path on CUDA."""
    with pytest.raises(ValueError, match="can execute this problem shape"):
        planning.plan_matmul(planning.MatmulProblem(
            M=4, N=64, K=250, group_size=128, format="w4a8_g128",
            backend=backend), use_cache=False)


def test_planner_errors_when_no_strategy_supports_format():
    tq.register_format(tq.QuantFormat(
        name="_test_w8a16_orphan", weight_bits=8, packing="int8_rows",
        scale_granularity="tensor", group_size=0))
    try:
        with pytest.raises(ValueError, match="no registered strategy"):
            planning.plan_matmul(planning.MatmulProblem(
                M=4, N=64, K=256, format="_test_w8a16_orphan"),
                use_cache=False)
    finally:
        tq._FORMAT_REGISTRY.pop("_test_w8a16_orphan", None)


@pytest.mark.parametrize("fmt,group,cpu,cuda", [
    ("w4a16_g128", 128, "reference", "fused"),
    ("w8a16_channel", 2560, "reference", "w8a16_fused"),
    ("w4a8_g128", 128, "w4a8_xla", "w4a8_fused")])
def test_each_format_plans_its_plain_path_and_its_kernel(fmt, group, cpu,
                                                         cuda):
    for backend, want in (("cpu", cpu), ("cuda", cuda)):
        plan = planning.plan_matmul(planning.MatmulProblem(
            M=8, N=640, K=2560, group_size=group, format=fmt,
            backend=backend), use_cache=False)
        assert plan.strategy == want
    # channel formats never split: group_size = K fails K >= 2·group
    if fmt == "w8a16_channel":
        assert planning.choose_split_k(8, 640, 2560, group_size=2560,
                                       cores=132) == 1


def test_danube_w4a16_plans_unchanged(monkeypatch):
    """The main path's plans do not move: on the H100 cost model ``auto``
    still picks ``fused`` for every danube w4a16_g128 GEMM, in every
    dtype, with the Split-K of ``choose_split_k`` at the card's 132 SMs,
    though ``decoupled`` now competes for the same format."""
    monkeypatch.setattr(planning, "num_cores",
                        lambda backend="cuda": 132 if backend == "cuda"
                        else 8)
    want_split = {(2560, 2560): 4, (2560, 640): 4, (2560, 6912): 4,
                  (6912, 2560): 2}
    for (K, N), split in want_split.items():
        for M in (8, 32):
            for act in ("bfloat16", "float16", "float32"):
                problem = planning.MatmulProblem(
                    M=M, N=N, K=K, act_dtype=act, out_dtype=act,
                    backend="cuda")
                plan = planning.plan_matmul(problem, use_cache=False)
                assert (plan.strategy, plan.split_k) == ("fused", split)
                assert planning.choose_split_k(M, N, K, cores=132) == split
                decoupled = planning._default_plan(problem, "decoupled")
                assert planning.get_strategy("decoupled").cost(
                    problem, decoupled) > planning.get_strategy(
                        "fused").cost(problem, plan)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

P, G, N_REQ = 12, 6, 2


def _jax_weights(fmt):
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH), quant_format=fmt)
    jparams = JT.quantize_params(JT.init_params(jax.random.PRNGKey(0), jcfg),
                                 jcfg, min_size=0)
    cfg = dataclasses.replace(configs.get_reduced(ARCH), quant_format=fmt)
    return jcfg, jparams, cfg, from_jax_params(jax_to_numpy(jparams),
                                               dtype=cfg.dtype, device="cpu")


@pytest.mark.parametrize("fmt,strategy,want_strategy", [
    ("w8a16_channel", "auto", "reference"),
    ("w4a8_g128", "auto", "w4a8_xla"),
    ("w4a16_g128", "decoupled", "decoupled")])
def test_engine_token_parity_with_jax(fmt, strategy, want_strategy):
    """The port's ServingEngine.run gives the JAX engine's greedy tokens on
    REDUCED danube (fp32, the SWA-16 window wrapping) for each new format,
    and for the decoupled pipeline (its plain phases, forced) against the
    JAX engine's own plan."""
    jcfg, jparams, cfg, tparams = _jax_weights(fmt)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(N_REQ, P)).astype(np.int32)
    kw = dict(max_batch=N_REQ, max_prompt_len=P, max_new_tokens=G,
              page_size=4, prefill_chunk=5)
    want = JServingEngine(jcfg, jparams, **kw).run(
        [JRequest(rid=i, prompt=toks[i], max_new_tokens=G)
         for i in range(N_REQ)]).results
    eng = ServingEngine(dataclasses.replace(cfg, w4a16_strategy=strategy),
                        tparams, device="cpu", **kw)
    assert {p.strategy for p in eng.plans.values()} == {want_strategy}
    rep = eng.run([Request(rid=i, prompt=toks[i], max_new_tokens=G)
                   for i in range(N_REQ)])
    assert rep.results == want
    assert all(len(v) == G for v in rep.results.values())


def test_engine_refuses_a_strategy_for_another_format():
    """A forced strategy that cannot run the weights' format is refused
    when the engine is built, with the planner's message."""
    _, _, cfg, tparams = _jax_weights("w4a8_g128")
    with pytest.raises(ValueError, match="does not support quantization "
                                         "format 'w4a8_g128'"):
        ServingEngine(dataclasses.replace(cfg, w4a16_strategy="decoupled"),
                      tparams, max_batch=2, max_prompt_len=8,
                      max_new_tokens=2, page_size=4, device="cpu")


def test_serve_launcher_formats_and_no_quant_on_cpu():
    base = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "6",
            "--gen", "3", "--page-size", "4", "--device", "cpu"]
    for extra in (["--format", "w8a16_channel"], ["--format", "w4a8_g128"],
                  ["--strategy", "decoupled"], ["--no-quant"]):
        rep = tserve.main(base + extra)
        assert sorted(rep.results) == [0, 1], extra
        assert all(len(v) == 3 for v in rep.results.values())
    with pytest.raises(ValueError, match="unknown quantization format"):
        tserve.main(base + ["--format", "w3a3"])
    with pytest.raises(ValueError, match="unknown KV-cache format"):
        tserve.validate_kv_format("kv4", "w4a16_g128")
    with pytest.raises(ValueError, match="does not support"):
        tserve.main(base + ["--format", "w8a16_channel", "--strategy",
                            "fused"])
