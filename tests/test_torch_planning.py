"""The port's planner against the JAX package's: the Split-K, kv-partition
and Q-block heuristics give the same decisions at a given core count (8,
the JAX package's CPU default, and the H100's 132 SMs), and the port's own
rules — ``fused`` only for CUDA operands and always for them,
``reference``/``gather`` on the CPU, plans keyed ``"KxN"``, the in-memory
plan cache, the H100 roofline."""
import itertools

import pytest
import torch

from repro.kernels import planning as jplanning

from repro_torch.core import costmodel
from repro_torch.core.quant import quantize
from repro_torch.kernels import planning
from repro_torch.kernels import w4a16_fused as wf

GEMMS = [(2560, 2560), (2560, 640), (2560, 6912), (6912, 2560),
         (128, 64), (256, 128), (4096, 14336), (384, 96)]


@pytest.mark.parametrize("cores", [8, 132])
def test_choose_split_k_matches_jax(cores, monkeypatch):
    monkeypatch.setattr(jplanning, "num_cores", lambda: cores)
    for (K, N), M, g in itertools.product(GEMMS, (1, 8, 32, 256),
                                          (128, 64, 32)):
        assert planning.choose_split_k(M, N, K, group_size=g,
                                       cores=cores) == \
            jplanning.choose_split_k(M, N, K, group_size=g), (M, N, K, g)


@pytest.mark.parametrize("cores", [8, 132])
def test_choose_kv_partitions_and_q_block_match_jax(cores, monkeypatch):
    monkeypatch.setattr(jplanning, "num_cores", lambda: cores)
    for B, Hkv, pages, q_tiles in itertools.product(
            (1, 2, 8, 64), (1, 2, 8), (1, 2, 4, 68, 512), (1, 2, 3)):
        assert planning.choose_kv_partitions(
            B, Hkv, pages, q_tiles=q_tiles, cores=cores) == \
            jplanning.choose_kv_partitions(B, Hkv, pages, q_tiles=q_tiles)
    for q_len, group in itertools.product((1, 5, 12, 32, 7), (1, 4, 6, 8,
                                                              16, 64)):
        assert planning.choose_q_block(q_len, group) == \
            jplanning.choose_q_block(q_len, group)


def _problem(backend, M=8, K=2560, N=2560, act="bfloat16"):
    return planning.MatmulProblem(M=M, N=N, K=K, backend=backend,
                                  act_dtype=act, out_dtype=act)


def test_fused_only_for_cuda_operands():
    cpu = planning.plan_matmul(_problem("cpu"), use_cache=False)
    assert cpu.strategy == "reference" and cpu.split_k == 1
    cuda = planning.plan_matmul(_problem("cuda"), use_cache=False)
    assert cuda.strategy == "fused"
    assert cuda.split_k == planning.choose_split_k(
        8, 2560, 2560, cores=planning.num_cores("cuda"))
    # forcing beats the ranking; a strategy/format mismatch is refused
    assert planning.plan_matmul(_problem("cpu"), strategy="fused").strategy \
        == "fused"
    with pytest.raises(ValueError, match="unknown strategy"):
        planning.plan_matmul(_problem("cpu"), strategy="xla")
    with pytest.raises(ValueError, match="does not support"):
        planning.plan_matmul(planning.MatmulProblem(
            M=1, N=16, K=128, format="w8a16_channel"), strategy="fused")


def test_plan_for_params_keys_and_resolve_plan():
    w = quantize(torch.randn(256, 128, generator=torch.Generator()
                             .manual_seed(0)))
    params = {"layers": {"mlp": {"w_up": {"kernel": w}}},
              "lm_head": {"kernel": torch.zeros(4, 4)}}
    plans = planning.plan_for_params(params, M=8)
    assert list(plans) == ["256x128"] and plans["256x128"].strategy == \
        "reference"

    class Cfg:
        w4a16_plan = plans
        w4a16_strategy = "auto"

    x = torch.randn(32, 256)     # a chunk-sized M reuses the "KxN" plan
    problem = planning.MatmulProblem.from_operands(x, w)
    assert planning.resolve_plan(problem, Cfg) is plans["256x128"]
    out = planning.matmul(x, w, cfg=Cfg)
    assert out.shape == (32, 128)


@pytest.mark.parametrize("act", ["bfloat16", "float16", "float32"])
def test_auto_on_cuda_always_fused(act):
    """On CUDA ``auto`` picks the kernel for every dtype and shape, the
    reduced configurations' fp32 and shapes the kernel cannot take
    included; it never routes a CUDA problem to the plain path. A shape
    the kernel cannot take raises when it runs."""
    for M, K, N in ((8, 2560, 2560), (4096, 2560, 6912), (1, 128, 40),
                    (3, 96, 16)):
        plan = planning.plan_matmul(_problem("cuda", M=M, K=K, N=N, act=act),
                                    use_cache=False)
        assert plan.strategy == "fused", (M, K, N, act)
    assert not planning.get_strategy("reference").supports(_problem("cuda"))
    # the wrapper's operand check (run for CUDA tensors) refuses N % 16
    qt = quantize(torch.randn(128, 40, generator=torch.Generator()
                              .manual_seed(0)), group_size=32)
    with pytest.raises(ValueError, match="N % 16"):
        wf._check_kernel_operands(torch.zeros(2, 128), qt, 1)
    wf._check_kernel_operands(torch.zeros(2, 128),
                              quantize(torch.zeros(128, 48)), 1)


def test_plan_cache_memo():
    cache = planning.PlanCache()
    prob = _problem("cuda")
    plan = planning.plan_matmul(prob, cache=cache)
    assert len(cache) == 1 and cache.misses == 1
    assert planning.plan_matmul(prob, cache=cache) is plan
    assert cache.get(prob) == plan and cache.hits == 2
    assert planning.plan_matmul(prob, cache=cache, strategy="reference") \
        .strategy == "reference" and len(cache) == 1    # forced: not cached
    cache.clear()
    assert len(cache) == 0 and cache.hits == cache.misses == 0


def _attn(**kw):
    base = dict(B=8, Hq=32, Hkv=8, D=80, cache_len=544, page_size=8,
                window=4096, kv_format="kv_fp16", backend="cuda")
    base.update(kw)
    return planning.AttentionProblem(**base)


def test_plan_attention_fused_on_cuda_gather_on_cpu():
    plan = planning.plan_attention(_attn())
    assert plan.path == "fused"
    assert plan.kv_partitions == planning.choose_kv_partitions(
        8, 8, 68, cores=planning.num_cores("cuda"))
    chunk = planning.plan_attention(_attn(B=1, q_len=32))
    assert chunk.path == "fused"
    assert planning.plan_attention(_attn(backend="cpu")).path == "gather"
    with pytest.raises(ValueError, match="does not support"):
        planning.plan_attention(_attn(backend="cpu"), path="fused")
    with pytest.raises(ValueError, match="unknown attention path"):
        planning.plan_attention(_attn(), path="flash3")
    # the ring path serves only an engine without the paged pool
    with pytest.raises(ValueError, match="does not support"):
        planning.plan_attention(_attn(), path="ring")
    assert planning.plan_attention(_attn(), path="gather").path == "gather"


def test_h100_roofline():
    """Decode GEMMs and paged attention are bound by bytes on the H100;
    the fused paths move fewer bytes than the plain ones."""
    nbytes = costmodel.w4a16_gemm_bytes(8, 6912, 2560)
    flops = costmodel.w4a16_gemm_flops(8, 6912, 2560)
    assert costmodel.bound_by(nbytes, flops) == "bytes"
    assert costmodel.roofline_s(nbytes, flops) == nbytes / 3.35e12
    assert costmodel.bound_by(0, 1e12) == "operations"
    assert costmodel.w4a16_time_fused(8, 6912, 2560) < \
        costmodel.w4a16_time_dequant_matmul(8, 6912, 2560)
    for q_len in (1, 32):
        assert costmodel.paged_attn_bytes(
            "fused", 8, 32, 8, 80, 544, quantized=False, q_len=q_len,
            kv_partitions=2) < costmodel.paged_attn_bytes(
            "gather", 8, 32, 8, 80, 544, quantized=False, q_len=q_len)
    with pytest.raises(ValueError, match="unknown attention path"):
        costmodel.paged_attn_bytes("flash3", 1, 1, 1, 1, 1, quantized=False)
    # the ring: the dense window read once, q in and out back (JAX's terms)
    assert costmodel.paged_attn_bytes(
        "ring", 8, 32, 8, 80, 544, quantized=True) == \
        8 * 544 * 2 * 2 * 8 * 80 + 2 * 8 * 32 * 80 * 2


def test_h100_gemm_family_bounds():
    """One danube layer's seven GEMMs at M=8 on the H100 roofline: W4A8 ≈
    fused W4A16 (0.53 bytes per weight) < W8A16 (1) < dense bf16 (2) <
    the decoupled design (packed read, bf16 workspace written and read
    back, S fp32 partials twice), all bound by bytes."""
    layer = [(2560, 2560), (2560, 640), (2560, 640), (2560, 2560),
             (2560, 6912), (2560, 6912), (6912, 2560)]
    M = 8

    def us(fn, **kw):
        return sum(fn(M, N, K, **kw) for K, N in layer) * 1e6
    fused = us(costmodel.w4a16_time_fused)
    assert fused == pytest.approx(11.23, abs=0.01)
    # int8 activations: half of x's bytes
    assert us(costmodel.w4a8_time_fused) == pytest.approx(11.18, abs=0.01)
    assert us(costmodel.w8a16_time_fused) == pytest.approx(20.98, abs=0.01)
    assert us(costmodel.dense_time) == pytest.approx(41.69, abs=0.01)
    decoupled = sum(costmodel.w4a16_time_decoupled(
        M, N, K, split_k=planning.choose_split_k(M, N, K, cores=132))
        for K, N in layer) * 1e6
    assert decoupled == pytest.approx(95.82, abs=0.01)
    assert costmodel.w4a8_time_plain(M, 2560, 2560) > \
        costmodel.w4a8_time_fused(M, 2560, 2560)
    for K, N in layer:
        assert costmodel.bound_by(costmodel.w4a8_gemm_bytes(M, N, K),
                                  costmodel.w4a16_gemm_flops(M, N, K),
                                  int8=True) == "bytes"


def _problems():
    """Problems of both packages' vocabularies: the port's CUDA kernels,
    the CPU plain path, another format."""
    return [planning.MatmulProblem(M=8, N=2560, K=2560, backend="cuda"),
            planning.MatmulProblem(M=32, N=640, K=2560, backend="cpu",
                                   act_dtype="float32",
                                   out_dtype="float32"),
            planning.MatmulProblem(M=8, N=6912, K=2560, backend="cuda",
                                   format="w8a16_channel", group_size=2560)]


def test_plan_cache_round_trip(tmp_path):
    """save → load restores every decision; the write is atomic (no temp
    file left); a bad version or malformed entry raises ValueError, which
    ``tolerant`` loading turns into -1."""
    path = str(tmp_path / "plans.json")
    cache = planning.PlanCache()
    for prob in _problems():
        cache.put(prob, planning.plan_matmul(prob, use_cache=False))
    assert cache.save(path) == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == ["plans.json"]
    fresh = planning.PlanCache()
    assert fresh.load(path) == 3
    assert fresh._plans == cache._plans
    (tmp_path / "bad.json").write_text('{"version": 2, "plans": []}')
    with pytest.raises(ValueError, match="version"):
        fresh.load(str(tmp_path / "bad.json"))
    (tmp_path / "bad.json").write_text('{"version": 1, "plans": [{}]}')
    with pytest.raises(ValueError, match="malformed"):
        fresh.load(str(tmp_path / "bad.json"))
    assert planning.load_plan_cache(str(tmp_path / "missing.json"),
                                    tolerant=True) == -1


def test_plan_cache_files_cross_packages(tmp_path):
    """The port reads a JAX-written file (tile sizes dropped, the ``xla``
    plans it cannot dispatch dropped) and JAX's ``PlanCache.load`` reads a
    port-written one (tile sizes defaulted)."""
    jpath, tpath = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jcache = jplanning.PlanCache()
    jp = jplanning.MatmulProblem(M=8, N=2560, K=2560, backend="tpu")
    jcache.put(jp, jplanning.KernelPlan(strategy="fused", split_k=4,
                                        block_m=16, block_n=512))
    jcache.put(jplanning.MatmulProblem(M=8, N=640, K=2560, backend="cpu"),
               jplanning.KernelPlan(strategy="xla"))
    jcache.save(jpath)
    tcache = planning.PlanCache()
    assert tcache.load(jpath) == 1
    (prob, plan), = tcache._plans.items()
    assert prob == planning.MatmulProblem(M=8, N=2560, K=2560,
                                          backend="tpu")
    assert plan == planning.KernelPlan(strategy="fused", split_k=4)

    tcache = planning.PlanCache()
    for prob in _problems():
        tcache.put(prob, planning.plan_matmul(prob, use_cache=False))
    tcache.save(tpath)
    jcache = jplanning.PlanCache()
    assert jcache.load(tpath) == 3
    got = {(p.M, p.N, p.K, p.backend, p.format): (pl.strategy, pl.split_k)
           for p, pl in jcache._plans.items()}
    want = {(p.M, p.N, p.K, p.backend, p.format): (pl.strategy, pl.split_k)
            for p, pl in tcache._plans.items()}
    assert got == want


def test_serve_launcher_plan_cache(tmp_path, capsys):
    """``--plan-cache`` is written after serving and loaded on the next
    run, whose plans then hit the cache."""
    from repro_torch.launch import serve as tserve
    path = str(tmp_path / "plans.json")
    argv = ["--arch", "h2o-danube-1.8b", "--reduced", "--batch", "2",
            "--prompt-len", "6", "--gen", "2", "--page-size", "4",
            "--device", "cpu", "--plan-cache", path]
    planning.PLAN_CACHE.clear()
    tserve.main(argv)
    first = capsys.readouterr().out
    planning.PLAN_CACHE.clear()
    tserve.main(argv)
    out = capsys.readouterr().out
    assert f"4 plans -> {path} (3 hits / 4 misses this run)" in first
    assert f"loaded 4 plans from {path}" in out
    assert " / 0 misses this run)" in out


# ---------------------------------------------------------------------------
# the refine pass (kernels/autotune.py) and plans as JSON
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,N,K", list(itertools.product(
    [1, 8, 16, 64], [128, 256, 1024, 6144], [2048, 6144, 16384])))
def test_autotune_plans_are_launches_the_kernel_takes(M, N, K):
    """Every plan is a launch ``gemm_geometry`` accepts: a power-of-two
    split whose K slices are whole groups, the row tile and K rows a
    block of that launch's geometry, ``GEMM_BN`` columns."""
    from repro_torch.kernels.autotune import autotune_w4a16
    from repro_torch.kernels.gemm import (GEMM_BN, gemm_geometry,
                                          sums_in_kernel)
    bm, bn, bk, s = autotune_w4a16(M, N, K, group=128)
    assert s & (s - 1) == 0 and (K // s) % 128 == 0 and bn == GEMM_BN
    geo = gemm_geometry("int4", M, N, K, s, torch.bfloat16,
                        direct=sums_in_kernel(s, torch.bfloat16,
                                              torch.bfloat16),
                        group=128, sms=132)
    assert (bm, bk) == (geo.bm, K // geo.ks)


def test_autotune_split_k_grows_with_k_at_small_m():
    """The regime of JAX's ``test_autotune_split_k_regimes``: at small M
    and K ≫ N the split grows with K (the Hopper kernel's geometry fills
    the card with in-cluster slices first, so it stays 1 until K is deep);
    a square decode GEMM stays at 1, as the kernel's geometry already
    fills the card."""
    from repro_torch.kernels.autotune import autotune_w4a16
    for M, N in ((1, 256), (8, 256), (1, 64), (8, 128)):
        splits = [autotune_w4a16(M, N, K)[3]
                  for K in (2048, 4096, 8192, 16384, 32768, 65536)]
        assert splits == sorted(splits) and splits[-1] > 1, (M, N, splits)
    assert autotune_w4a16(8, 2560, 2560)[3] == 1
    # granite's (6144, 128) stays unsplit, where the heuristic picks 16
    assert autotune_w4a16(8, 128, 6144)[3] == 1
    assert planning.choose_split_k(8, 128, 6144, cores=132) == 16


def test_refine_reaches_the_search_past_a_cached_plan():
    """``refine=True`` runs the search even when a heuristic plan is
    cached and replaces it (JAX's rule); refine is off by default, so no
    default plan changes; a forced strategy refines too."""
    from repro_torch.kernels.autotune import autotune_w4a16
    cache = planning.PlanCache()
    # a meta problem is planned as the card's (132 SMs without one)
    prob = _problem("meta", M=8, K=6144, N=128)
    heuristic = planning.plan_matmul(prob, cache=cache)
    assert heuristic.split_k == planning.choose_split_k(
        8, 128, 6144, cores=planning.num_cores("meta")) == 16
    refined = planning.plan_matmul(prob, refine=True, cache=cache)
    assert refined.strategy == heuristic.strategy == "fused"
    assert refined.split_k == autotune_w4a16(8, 128, 6144)[3] == 1
    assert cache.get(prob) == refined
    assert planning.plan_matmul(prob, strategy="fused", refine=True) == \
        refined
    # the plain path has no split to refine
    assert planning.plan_matmul(_problem("cpu"), refine=True,
                                use_cache=False).split_k == 1
    from repro_torch.kernels import ops
    w = quantize(torch.randn(256, 128, generator=torch.Generator()
                             .manual_seed(1)))
    x = torch.randn(4, 256, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(ops.w4a16_matmul(x, w, autotune=True),
                               ops.w4a16_matmul(x, w))


def test_plan_json_round_trips_and_reads_jax_plans():
    plan = planning.KernelPlan(strategy="fused", split_k=4,
                               out_dtype="bfloat16")
    assert planning.KernelPlan.from_json(plan.to_json()) == plan
    jplan = jplanning.KernelPlan(strategy="decoupled", split_k=8,
                                 block_m=16, block_n=512, block_k=1024)
    assert planning.KernelPlan.from_json(jplan.to_json()) == \
        planning.KernelPlan(strategy="decoupled", split_k=8)
    # JAX reads the port's JSON (its tiles at their defaults)
    back = jplanning.KernelPlan.from_json(plan.to_json())
    assert (back.strategy, back.split_k, back.out_dtype) == \
        ("fused", 4, "bfloat16")


def test_resolve_plan_takes_jax_override_forms():
    """``cfg.w4a16_plan`` as a plan, a mapping (to a plan or a dict; a
    layer it does not name is planned) or a plan's JSON gives JAX's
    ``resolve_plan`` decision for each form."""
    prob = _problem("cpu", M=8, K=256, N=128, act="float32")
    jprob = jplanning.MatmulProblem(M=8, N=128, K=256, backend="cpu",
                                    act_dtype="float32",
                                    out_dtype="float32")
    forced = planning.KernelPlan(strategy="reference", split_k=2)
    jforced = jplanning.KernelPlan(strategy="reference", split_k=2)

    class Cfg:
        w4a16_strategy = "auto"

    forms = [(forced, jforced),
             ({"256x128": forced}, {"256x128": jforced}),
             ({"256x128": forced.to_dict()}, {"256x128": jforced.to_dict()}),
             (forced.to_json(), jforced.to_json())]
    for tform, jform in forms:
        tcfg, jcfg = Cfg(), Cfg()
        tcfg.w4a16_plan, jcfg.w4a16_plan = tform, jform
        got = planning.resolve_plan(prob, tcfg)
        want = jplanning.resolve_plan(jprob, jcfg)
        assert (got.strategy, got.split_k) == (want.strategy, want.split_k)
    tcfg = Cfg()
    tcfg.w4a16_plan = {"64x64": forced}
    assert planning.resolve_plan(prob, tcfg) == planning.plan_matmul(prob)


def test_refine_plans_keeps_the_engine_tokens():
    """``ServingEngine(refine_plans=True)`` plans through the refine pass
    (on the CPU the plain path, unsplit) and serves JAX's tokens."""
    import jax
    from repro import configs as jconfigs
    from repro.models import transformer as JT
    from repro.runtime.engine import Request as JRequest
    from repro.runtime.engine import ServingEngine as JServingEngine
    from repro_torch import configs
    from repro_torch.convert import from_jax_params
    from repro_torch.runtime.engine import Request, ServingEngine
    from torch_parity_helpers import jax_to_numpy
    import numpy as np

    arch = "h2o-danube-1.8b"
    jcfg = jconfigs.get_reduced(arch)
    jparams = JT.quantize_params(JT.init_params(jax.random.PRNGKey(0), jcfg),
                                 jcfg, min_size=0)
    cfg = configs.get_reduced(arch)
    tparams = from_jax_params(jax_to_numpy(jparams), dtype=cfg.dtype,
                              device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
    kw = dict(max_batch=2, max_prompt_len=8, max_new_tokens=4,
              page_size=4, refine_plans=True)
    want = JServingEngine(jcfg, jparams, **kw).run(
        [JRequest(rid=i, prompt=toks[i].astype(np.int32), max_new_tokens=4)
         for i in range(2)])
    eng = ServingEngine(cfg, tparams, device="cpu", **kw)
    got = eng.run([Request(rid=i, prompt=toks[i].astype(np.int32),
                           max_new_tokens=4) for i in range(2)])
    assert got.results == {k: [int(t) for t in v]
                           for k, v in want.results.items()}
    assert eng.plans and all(p.split_k == 1 for p in eng.plans.values())
