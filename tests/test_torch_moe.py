"""The port's MoE family against the JAX package on the CPU: ``moe_ffn``
(dense and W4A16 experts, tokens dropping at the default capacity factor,
the round(2.5) boundary, full capacity), the capacity rule, top-k ties,
the expert-batched GEMM against its per-expert loop, ``quantize_tree`` on
(L, E, K, N) stacks with a dense router, the converter on an olmoe tree,
the serve steps, and engine-level greedy token parity on REDUCED
olmoe-1b-7b and mixtral-8x7b (dense and W4A16, 2 slots, chunked prefill,
ngram speculation, a shared prefix), the train step (three steps against
JAX's: gradients through the capacity dispatch, the router reached through
the top-k weights, the aux loss dropped on both sides), remat, plus the
launchers.

Weights are the JAX package's, converted leaf for leaf; inputs come from
numpy with a fixed seed. REDUCED configs run in fp32: ``moe_ffn`` is held
to 1e-5, logits after two layers and a vocab-wide head to 1e-4 (the two
frameworks sum in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro.runtime import kvcache as jkvc
from repro.runtime.engine import Request as JRequest
from repro.runtime.engine import ServingEngine as JServingEngine

from repro_torch import configs
from repro_torch.convert import from_jax_params
from repro_torch.core.quant import QuantizedTensor, quantize
from repro_torch.kernels import planning
from repro_torch.kernels.w4a16_fused import (w4a16_fused, w4a16_fused_plain,
                                             W4A16_GEMM_EXPERTS)
from repro_torch.kernels.w8a16_fused import w8a16_fused
from repro_torch.launch import serve as tserve
from repro_torch.models import layers, moe
from repro_torch.models import transformer as T
from repro_torch.runtime.engine import Request, ServingEngine

from torch_parity_helpers import (assert_train_matches, check_remat,
                                  jax_to_numpy, jax_trained, port_train,
                                  train_launcher_round_trip)

ARCHS = ("olmoe-1b-7b", "mixtral-8x7b")


def _moe_params(arch, quantized, seed=0):
    """One MoE layer's params of the REDUCED config, JAX's and the port's
    (the same bytes)."""
    jcfg = jconfigs.get_reduced(arch)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg.d_model, jcfg.d_ff,
                       jcfg.num_experts, jnp.float32)
    if quantized:
        jp = jlayers.quantize_tree(jp, min_size=0)
    tp = from_jax_params(jax_to_numpy(jp), dtype=torch.float32, device="cpu")
    return jcfg, jp, configs.get_reduced(arch), tp


def _tokens(T_, d, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (T_, d)).astype(np.float32)


def _max_load(tp, x, cfg):
    """The most (token, k) pairs any expert is chosen for."""
    logits = layers.linear(tp["router"], torch.from_numpy(x))
    _, sel = moe.stable_top_k(torch.softmax(logits, -1),
                              cfg.experts_per_token)
    return int(torch.bincount(sel.reshape(-1),
                              minlength=cfg.num_experts).max())


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

# (T, capacity factor): T = 8 at the default factor drops tokens; for
# olmoe's E = 8, k = 2 it is the round(2.5) = 2 boundary, for mixtral's E
# = 4, T = 4 is; a factor of E gives every pair a place
MOE_CASES = [(8, 1.25), (4, 1.25), (13, 1.25), (8, 64.0)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("T_,cf", MOE_CASES)
def test_moe_ffn_matches_jax(arch, quantized, T_, cf):
    jcfg, jp, cfg, tp = _moe_params(arch, quantized)
    x = _tokens(T_, cfg.d_model)
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.experts_per_token,
              capacity_factor=cf)
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), cfg=jcfg, **kw)
    ty, taux = moe.moe_ffn(tp, torch.from_numpy(x), cfg=cfg, **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    cap = moe.capacity(T_, cfg.experts_per_token, cfg.num_experts, cf)
    if cf == 1.25 and T_ == 8:
        # the case drops pairs: some expert is chosen past its capacity
        assert _max_load(tp, x, cfg) > cap
    if cf == 64.0:
        assert cap == T_ * cfg.experts_per_token


def test_moe_ffn_keeps_leading_axes():
    jcfg, jp, cfg, tp = _moe_params("olmoe-1b-7b", True)
    x = _tokens(6, cfg.d_model).reshape(2, 3, cfg.d_model)
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.experts_per_token)
    jy, _ = jmoe.moe_ffn(jp, jnp.asarray(x), cfg=jcfg, **kw)
    ty, _ = moe.moe_ffn(tp, torch.from_numpy(x), cfg=cfg, **kw)
    assert ty.shape == (2, 3, cfg.d_model)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)


def test_capacity_matches_the_jax_rule():
    """``capacity`` is JAX's expression (``moe.py:95-96``), banker's
    rounding included, over a grid of (T, k, E, cf)."""
    for T_ in (1, 2, 4, 5, 8, 10, 13, 32, 40, 256):
        for k, E in ((1, 4), (2, 4), (2, 8), (8, 64)):
            for cf in (0.5, 1.0, 1.25, 2.0, 64.0):
                want = min(int(max(k, round(T_ * k / E * cf))), T_ * k)
                assert moe.capacity(T_, k, E, cf) == want
    # the serving shapes: mixtral decode at B = 8 is round(2.5) = 2, its
    # 32-token chunk 10; olmoe's top-8 floor holds at 8 for decode,
    # chunk and the k = 4 verify (40 rows)
    assert moe.capacity(8, 2, 8, 1.25) == 2
    assert moe.capacity(32, 2, 8, 1.25) == 10
    assert [moe.capacity(t, 8, 64, 1.25) for t in (8, 32, 40)] == [8, 8, 8]


def test_top_k_ties_take_the_lower_index_first():
    g = np.array([[0.25, 0.25, 0.25, 0.25],
                  [0.1, 0.3, 0.3, 0.3],
                  [0.4, 0.2, 0.4, 0.0],
                  [0.0, 0.5, 0.0, 0.5]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(g), k)
        tv, ti = moe.stable_top_k(torch.from_numpy(g), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_dropped_and_empty_slots_through_the_dispatch():
    """A router that sends every token to expert 0 first: pairs past the
    capacity drop (they add nothing), experts nobody chose see zero rows,
    and the output still equals JAX's."""
    jcfg, jp, cfg, tp = _moe_params("mixtral-8x7b", True)
    router = np.zeros((cfg.d_model, cfg.num_experts), np.float32)
    router[:, 0] = 1.0
    router[:, 1] = 0.5
    jp = dict(jp, router={"kernel": jnp.asarray(router)})
    tp = dict(tp, router={"kernel": torch.from_numpy(router)})
    x = np.abs(_tokens(8, cfg.d_model))
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.experts_per_token)
    jy, _ = jmoe.moe_ffn(jp, jnp.asarray(x), cfg=jcfg, **kw)
    ty, _ = moe.moe_ffn(tp, torch.from_numpy(x), cfg=cfg, **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    # cap = round(8·2/4·1.25) = 5: tokens 5.. of expert 0 and 1 drop
    np.testing.assert_array_equal(ty.numpy()[5:], 0.0)


# ---------------------------------------------------------------------------
# the expert-batched GEMM
# ---------------------------------------------------------------------------

def _stack(E, K, N, fmt, seed=0):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(
        rng.standard_normal((E, K, N)).astype(np.float32) * K ** -0.5)
    tree = layers.quantize_tree({"moe": {"w": {"kernel": w}}}, format=fmt,
                                min_size=0)
    return tree["moe"]["w"]["kernel"]


@pytest.mark.parametrize("fmt", ["w4a16_g128", "w8a16_channel",
                                 "w4a8_g128"])
@pytest.mark.parametrize("M", [1, 5])
def test_batched_execute_equals_the_per_expert_loop(fmt, M):
    """``planning.execute`` on an (E, K/p, N) stack equals E 2-D calls on
    its slices, for every format's planned CPU strategy; the W4A16 and
    W8A16 wrappers take the stack whole."""
    E, K, N = 4, 256, 96
    qt = _stack(E, K, N, fmt)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (E, M, K)).astype(np.float32))
    x[1] = 0.0                                  # an expert nobody chose
    problem = planning.MatmulProblem.from_operands(x[0], qt.layer(0),
                                                   batch=E)
    plan = planning.plan_matmul(problem, use_cache=False)
    got = planning.execute(plan, x, qt)
    want = torch.stack([planning.execute(plan, x[e], qt.layer(e))
                        for e in range(E)])
    assert got.shape == (E, M, N)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    np.testing.assert_array_equal(got[1].numpy(), 0.0)
    if fmt == "w4a16_g128":
        torch.testing.assert_close(w4a16_fused(x, qt), want, rtol=0, atol=0)
        torch.testing.assert_close(
            w4a16_fused_plain(x, qt, split_k=2),
            torch.stack([w4a16_fused_plain(x[e], qt.layer(e), split_k=2)
                         for e in range(E)]), rtol=0, atol=0)
    if fmt == "w8a16_channel":
        torch.testing.assert_close(w8a16_fused(x, qt), want, rtol=0, atol=0)
    # the CPU runs the plain versions: nothing launched
    assert W4A16_GEMM_EXPERTS.launches == 0


def test_batched_execute_refuses_a_mismatched_stack():
    qt = _stack(4, 256, 96, "w4a16_g128")
    plan = planning.KernelPlan("reference")
    with pytest.raises(ValueError, match="expert stack of 4"):
        planning.execute(plan, torch.zeros(3, 2, 256), qt)
    with pytest.raises(ValueError, match="does not chain"):
        w4a16_fused(torch.zeros(2, 256), qt)


def test_planner_counts_the_expert_stack():
    """Batched problems cost E GEMMs and count E·tiles toward Split-K; the
    engine's pre-planning marks ``moe`` leaves as batched."""
    p1 = planning.MatmulProblem(M=2, N=4096, K=14336, backend="cuda")
    p8 = dataclasses.replace(p1, batch=8)
    assert planning.get_strategy("fused").cost(
        p8, planning.KernelPlan("fused")) == pytest.approx(
        8 * planning.get_strategy("fused").cost(
            p1, planning.KernelPlan("fused")))
    # mixtral's w_down: 16 column tiles alone split K 8 ways on 132 SMs;
    # the stack's 128 tiles nearly fill the card, so no split
    assert planning.choose_split_k(2, 4096, 14336, cores=132) == 8
    assert planning.choose_split_k(2, 4096, 14336, cores=132, batch=8) == 1
    qt = _stack(4, 256, 96, "w4a16_g128")
    tree = {"layers": {"moe": {"w_up": {"kernel": qt}},
                       "attn": {"wq": {"kernel": qt.layer(0)}}}}
    planning.PLAN_CACHE.clear()
    planning.plan_for_params(tree, M=8)
    batches = sorted(p.batch for p in planning.PLAN_CACHE._plans)
    assert batches == [1, 4]
    planning.PLAN_CACHE.clear()


# ---------------------------------------------------------------------------
# quantize_tree (the repair) and the converter
# ---------------------------------------------------------------------------

def test_quantize_tree_expert_stacks_and_router_skip():
    """At the default ``min_size`` (65536) a 1024 x 128 router is large
    enough to quantize, yet the JAX package keeps every ``router`` dense;
    (L, E, K, N) expert stacks quantize slice-wise into one
    QuantizedTensor with per-(layer, expert, group, N) scales, byte for
    byte as JAX's vmapped quantize."""
    rng = np.random.default_rng(0)
    L, E, d, ff = 2, 3, 1024, 256
    tree = {"layers": {"moe": {
        "router": {"kernel": rng.standard_normal((L, d, 128))},
        "w_gate": {"kernel": rng.standard_normal((L, E, d, ff))},
        "w_down": {"kernel": rng.standard_normal((L, E, ff, d))},
    }}}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    jq = jax_to_numpy(jlayers.quantize_tree(jax.tree.map(jnp.asarray, tree)))
    tq = layers.quantize_tree(jax.tree.map(torch.from_numpy, tree))
    tm, jm = tq["layers"]["moe"], jq["layers"]["moe"]
    assert isinstance(tm["router"]["kernel"], torch.Tensor)
    assert isinstance(jm["router"]["kernel"], np.ndarray)
    for name in ("w_gate", "w_down"):
        got, want = tm[name]["kernel"], jm[name]["kernel"]
        assert isinstance(got, QuantizedTensor)
        assert got.packed.dim() == 4 and got.K == tree["layers"]["moe"][
            name]["kernel"].shape[-2]
        np.testing.assert_array_equal(got.packed.numpy(), want["packed"])
        np.testing.assert_array_equal(got.scales.numpy(), want["scales"])
        # one slice is the 2-D quantizer's output for that matrix
        one = quantize(torch.from_numpy(
            tree["layers"]["moe"][name]["kernel"][1, 2]), got.format)
        np.testing.assert_array_equal(got.layer(1).layer(2).packed.numpy(),
                                      one.packed.numpy())


def test_convert_olmoe_tree_leaf_for_leaf():
    jcfg = jconfigs.get_reduced("olmoe-1b-7b")
    jq = jax_to_numpy(JT.quantize_params(
        JT.init_params(jax.random.PRNGKey(0), jcfg), jcfg, min_size=0))
    tq = from_jax_params(jq, dtype=torch.float32, device="cpu")
    cfg = configs.get_reduced("olmoe-1b-7b")
    L, E, d, ff = cfg.num_layers, cfg.num_experts, cfg.d_model, cfg.d_ff
    m = tq["layers"]["moe"]
    assert isinstance(m["router"]["kernel"], torch.Tensor)
    assert tuple(m["router"]["kernel"].shape) == (L, d, E)
    assert tuple(m["w_gate"]["kernel"].packed.shape) == (L, E, d // 2, ff)
    assert tuple(m["w_down"]["kernel"].packed.shape) == (L, E, ff // 2, d)

    def walk(t, j, path=()):
        if isinstance(t, dict):
            assert set(t) == set(j), path
            for k in t:
                walk(t[k], j[k], path + (k,))
        elif isinstance(t, QuantizedTensor):
            np.testing.assert_array_equal(t.packed.numpy(), j["packed"])
            np.testing.assert_array_equal(t.scales.numpy(), j["scales"])
            assert t.format.name == j["format"]["name"]
        else:
            np.testing.assert_array_equal(t.numpy(), j)

    walk(tq, jq)
    # the port's own quantizer gives the same tree from the dense weights
    dense = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tq2 = T.quantize_params(from_jax_params(jax_to_numpy(dense),
                                            dtype=torch.float32), cfg,
                            min_size=0)
    walk(tq2, jq)


def test_moe_param_counts_match_jax():
    for arch in ARCHS:
        for get, jget in ((configs.get_config, jconfigs.get_config),
                          (configs.get_reduced, jconfigs.get_reduced)):
            c, j = get(arch), jget(arch)
            assert c.param_count() == j.param_count()
            assert c.active_param_count() == j.active_param_count()
    # init_params builds exactly that many on the reduced configs
    cfg = configs.get_reduced("mixtral-8x7b")
    gen = torch.Generator().manual_seed(0)
    params = T.init_params(gen, cfg, device="cpu")
    n = sum(t.numel() for t in jax.tree.leaves(
        params, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert n == cfg.param_count() + cfg.num_layers * 2 * cfg.d_model \
        + cfg.d_model                                       # norms


# ---------------------------------------------------------------------------
# steps and engine
# ---------------------------------------------------------------------------

_WEIGHTS = {}


def _weights(arch, quantized):
    key = (arch, quantized)
    if key not in _WEIGHTS:
        jcfg = dataclasses.replace(jconfigs.get_reduced(arch),
                                   w4a16_strategy="xla")
        jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
        if quantized:
            jparams = JT.quantize_params(jparams, jcfg, min_size=0)
        cfg = configs.get_reduced(arch)
        tparams = from_jax_params(jax_to_numpy(jparams), dtype=cfg.dtype,
                                  device="cpu")
        _WEIGHTS[key] = (jcfg, jparams, cfg, tparams)
    return _WEIGHTS[key]


@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_and_decode_steps_match_jax(arch):
    """A padded prefill chunk (its padding rows routed too) then three
    decode steps over both slots (one inactive): logits at every step."""
    jcfg, jparams, cfg, tparams = _weights(arch, True)
    fmt, ps, nb, cache_len, C = "kv_fp16", 4, 9, 16, 8
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=5).astype(np.int32)
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    jpool = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (jcfg.num_layers,) + x.shape),
        jkvc.init_pool(nb, ps, jcfg.num_kv_heads, jcfg.head_dim,
                       jcfg.dtype, fmt))
    js = {"cache": {"kv": jpool}}
    ts = T.init_paged_state(cfg, 2, cache_len, page_size=ps, num_blocks=nb,
                            kv_format=fmt, device="cpu")
    positions = np.full((1, C), -1, np.int32)
    positions[0, :5] = np.arange(5)
    seg = np.zeros(C, np.int32)
    seg[:5] = prompt
    jh = JT.layers.embed(jparams["embed"], jnp.asarray(seg))[None]
    jh = jnp.where(jnp.asarray(positions >= 0)[..., None], jh, 0.0)
    jl, js = JT.prefill_chunk_step(
        jparams, jcfg, js, jh, jnp.asarray(positions),
        jnp.asarray(table[:1]), 0, cache_len=cache_len, kv_format=fmt)
    th = torch.from_numpy(np.array(jh))
    tl, ts = T.prefill_chunk_step(
        tparams, cfg, ts, th, torch.from_numpy(positions),
        torch.from_numpy(table[:1]), cache_len=cache_len, kv_format=fmt)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    tok = np.array([7, 9], np.int32)
    tables = table.copy()
    tables[1] = -1
    for step in range(3):
        pos = np.array([5 + step, 0], np.int32)
        jl, js = JT.decode_step(
            jparams, jcfg, js, jnp.asarray(tok), jnp.asarray(pos),
            tables=jnp.asarray(tables), cache_len=cache_len, kv_format=fmt)
        tl, ts = T.decode_step(
            tparams, cfg, ts, torch.from_numpy(tok), torch.from_numpy(pos),
            tables=torch.from_numpy(tables), cache_len=cache_len,
            kv_format=fmt)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)


def test_forward_matches_jax():
    """The training forward (the FFN switch in sequence mode; the aux loss
    dropped, as JAX's forward drops it)."""
    jcfg, jparams, cfg, tparams = _weights("mixtral-8x7b", False)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    jl = JT.forward(jparams, jcfg, jnp.asarray(toks))
    tl = T.forward(tparams, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=1e-4, atol=1e-4)


def _prompts(cfg, n, plen, seed=0, kind="repeat"):
    """``n`` prompts: ``same`` (one prompt n times), ``distinct``, or
    ``repeat`` (the first two repeat a short sequence, which gives prompt
    lookup something to propose)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(n, plen)).astype(np.int32)
    if kind == "same":
        return [toks[0]] * n
    if kind == "distinct":
        return list(toks)
    base = toks[0, :max(2, plen // 3)]
    rep = np.tile(base, -(-plen // len(base)))[:plen]
    return [rep if i < 2 else toks[i] for i in range(n)]


def _engine_pair(arch, quantized, prompts, G, *, arrival_every=1, jax=True,
                 **kw):
    """JAX's report (None without ``jax``: a run the test holds only
    against the port's own), the port's report and its engine."""
    jcfg, jparams, cfg, tparams = _weights(arch, quantized)

    def reqs(make):
        return [make(rid=i, prompt=p, max_new_tokens=G,
                     arrival_step=i * arrival_every)
                for i, p in enumerate(prompts)]

    common = dict(max_batch=2, max_prompt_len=max(len(p) for p in prompts),
                  max_new_tokens=G, page_size=4, **kw)
    jrep = JServingEngine(jcfg, jparams, **common).run(reqs(JRequest)) \
        if jax else None
    eng = ServingEngine(cfg, tparams, device="cpu", **common)
    return jrep, eng.run(reqs(Request)), eng


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("quantized", [False, True])
def test_engine_token_parity_with_jax(arch, quantized):
    """The acceptance: 3 requests through 2 slots, chunked prefill of 5,
    the default capacity factor (tokens drop): JAX's greedy tokens."""
    cfg = configs.get_reduced(arch)
    assert cfg.moe_capacity_factor == 1.25
    jrep, rep, eng = _engine_pair(arch, quantized, _prompts(cfg, 3, 12), 6,
                                  prefill_chunk=5)
    assert rep.results == jrep.results and sorted(rep.results) == [0, 1, 2]
    assert all(len(v) == 6 for v in rep.results.values())
    assert rep.steps == jrep.steps
    assert eng.alloc.pages_in_use == 0
    if quantized:
        assert {p.strategy for p in eng.plans.values()} == {"reference"}


def test_engine_ngram_speculation_parity_with_jax():
    """olmoe with ngram speculation: every verify step routes all B·(k+1)
    rows together, as JAX's does."""
    cfg = configs.get_reduced("olmoe-1b-7b")
    prompts = _prompts(cfg, 3, 9, seed=4)
    jrep, rep, eng = _engine_pair("olmoe-1b-7b", True, prompts, 8,
                                  prefill_chunk=4, speculate="ngram",
                                  spec_k=3)
    assert rep.results == jrep.results
    assert (rep.proposed_tokens, rep.accepted_tokens, rep.steps) == \
        (jrep.proposed_tokens, jrep.accepted_tokens, jrep.steps)
    assert rep.proposed_tokens > 0
    assert eng.alloc.pages_in_use == 0


def test_engine_draft_speculation_parity_with_jax():
    """olmoe with a one-layer MoE draft (``draft:layers=1``, JAX's draft
    weights converted): the draft's ring prefill and decode route through
    the MoE too, and the tokens and acceptance equal JAX's."""
    from repro.runtime import speculative as jspec
    from repro_torch.runtime import speculative as spec
    jcfg, jparams, cfg, tparams = _weights("olmoe-1b-7b", True)
    jprop = jspec.make_proposer("draft:layers=1", target_cfg=jcfg)
    tprop = spec.DraftModelProposer(
        dataclasses.replace(cfg, num_layers=1),
        from_jax_params(jax_to_numpy(jprop.params), dtype=cfg.dtype,
                        device="cpu"))
    prompts = _prompts(cfg, 3, 9, seed=4)
    common = dict(max_batch=2, max_prompt_len=9, max_new_tokens=6,
                  page_size=4, prefill_chunk=4, spec_k=3)

    def reqs(make):
        return [make(rid=i, prompt=p, max_new_tokens=6, arrival_step=i)
                for i, p in enumerate(prompts)]

    jrep = JServingEngine(jcfg, jparams, speculate=jprop, **common).run(
        reqs(JRequest))
    rep = ServingEngine(cfg, tparams, speculate=tprop, device="cpu",
                        **common).run(reqs(Request))
    assert rep.results == jrep.results
    assert (rep.proposed_tokens, rep.accepted_tokens, rep.steps) == \
        (jrep.proposed_tokens, jrep.accepted_tokens, jrep.steps)
    assert rep.proposed_tokens > 0


@pytest.mark.parametrize("chunk,arrival", [(4, 0), (3, 2)])
def test_engine_shared_prefix_parity_with_jax(chunk, arrival):
    """olmoe with identical prompts, admitted in lockstep or staggered:
    tokens, peak pages and prefill steps saved equal JAX's, and sharing
    holds fewer pages than distinct prompts do."""
    cfg = configs.get_reduced("olmoe-1b-7b")
    kw = dict(arrival_every=arrival, prefill_chunk=chunk)
    jshared, shared, eng = _engine_pair(
        "olmoe-1b-7b", True, _prompts(cfg, 2, 8, seed=6, kind="same"), 4, **kw)
    _, distinct, _ = _engine_pair(
        "olmoe-1b-7b", True, _prompts(cfg, 2, 8, seed=6, kind="distinct"), 4,
        jax=False, **kw)
    assert shared.results == jshared.results
    assert (shared.peak_pages, shared.prefill_steps_saved) == \
        (jshared.peak_pages, jshared.prefill_steps_saved)
    assert shared.peak_pages < distinct.peak_pages
    assert eng.alloc.pages_in_use == 0


def test_serve_launcher_moe_on_cpu(monkeypatch):
    rep = tserve.main(["--arch", "olmoe-1b-7b", "--reduced", "--batch", "2",
                       "--prompt-len", "6", "--gen", "3", "--page-size", "4",
                       "--device", "cpu"])
    assert sorted(rep.results) == [0, 1]
    assert all(len(v) == 3 for v in rep.results.values())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--arch", "mixtral-8x7b", "--reduced"])


def test_train_launcher_refuses_moe(tmp_path):
    """The launcher trains both MoE archs (it refused them once): two
    microbatches, checkpoints that restore, and the post-training planning
    pass, which plans each expert stack as one batched problem of E
    GEMMs."""
    import json
    for arch in ARCHS:
        cfg = configs.get_reduced(arch)
        plans = tmp_path / f"{arch}.json"
        train_launcher_round_trip(arch, tmp_path / arch, "--microbatches",
                                  "2", "--plan-cache", str(plans))
        batches = sorted(p["problem"]["batch"]
                         for p in json.loads(plans.read_text())["plans"])
        assert batches.count(cfg.num_experts) >= 2 and batches[0] == 1


# ---------------------------------------------------------------------------
# training: the train step against JAX's, remat, the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn_impl", ["chunked", "flash"])
@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(jax_trained, arch, micro, attn_impl):
    """Three ``make_train_step`` steps from JAX's parameters against
    JAX's (``torch_parity_helpers.assert_train_matches``)."""
    want = jax_trained(arch, micro)
    got = port_train(arch, micro, want["params0"], attn_impl=attn_impl)
    assert_train_matches(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_grads(arch, monkeypatch):
    check_remat(arch, monkeypatch)
