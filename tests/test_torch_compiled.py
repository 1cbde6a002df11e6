"""The compiled serving steps (``runtime/steps.py``: the ``jit_*`` steps,
``CompiledStep``; the counterparts of JAX's ``jax.jit`` steps) on the CPU.

A CUDA graph captures work on the card only, so here the capture is a
stand-in patched in for ``steps.GRAPHS`` (:class:`StandIn`): its capture
runs the step once on the static inputs to make the static outputs and
puts the static inputs back (a capture launches nothing); its replay
re-runs the step on the static inputs and copies what it returns into
those static outputs. The aliasing is then a CUDA graph's: a replay
overwrites the outputs of the last one, and the state is the caller's own
tensors. With it the port's engine, compiled, gives the greedy tokens of
JAX's engine (which jits every step) on REDUCED configs: danube paged with
chunked prefill under both KV formats, rwkv6-7b (carries, one chunk graph
for every slot), whisper-small (the encoder compiled), olmoe-1b-7b, and danube
with the ngram and draft proposers. Weights are the JAX package's,
converted leaf for leaf; tokens must be equal.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.runtime import speculative as jspec
from repro.runtime.engine import Request as JRequest
from repro.runtime.engine import ServingEngine as JServingEngine

from repro_torch import configs
from repro_torch.convert import from_jax_params
from repro_torch.kernels import build
from repro_torch.launch import serve as tserve
from repro_torch.runtime import speculative as spec
from repro_torch.runtime import steps as rsteps
from repro_torch.runtime.engine import Request, ServingEngine

from torch_parity_helpers import jax_to_numpy


class StandIn:
    """``steps.GRAPHS`` on the CPU (module docstring). ``fail`` makes every
    capture raise as a capture that meets a host sync does. ``nodes``: the
    function names of the graph's kernel nodes a capture reports (None:
    the kernel nodes its counted launches would make)."""

    device_type = "cpu"

    def __init__(self, fail=False, nodes=None):
        self.fail, self.captures, self.replays = fail, 0, 0
        self.nodes = nodes

    def new_pool(self):
        return None

    def warm_up(self, run):
        return run()

    def capture(self, run, statics, pool):
        if self.fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        saved = [s.clone() if isinstance(s, torch.Tensor) else None
                 for s in statics]
        before = build.launch_counts()
        out = run()
        nodes = self.nodes
        if nodes is None:
            nodes = [f"void {' '.join(k.device)}<8>(Args)"
                     for k, n in build.launch_counts().items()
                     if isinstance(k, build.CudaKernel) and k.device
                     for _ in range(n - before.get(k, 0))]
        for s, c in zip(statics, saved):
            if c is not None:
                s.copy_(c)
        self.captures += 1

        def replay():
            # a graph's replay enters no wrapper: the counts it launched
            # come from the capture (CompiledStep adds them)
            before = build.launch_counts()
            new = run()
            for a, b in zip(rsteps.flat_leaves(out), rsteps.flat_leaves(new)):
                if isinstance(a, torch.Tensor) and a is not b:
                    a.copy_(b)
            build.add_launches({k: before[k] - n for k, n in
                                build.launch_counts().items() if k in before})
            self.replays += 1
        return out, replay, 0, nodes


@pytest.fixture
def graphs(monkeypatch):
    g = StandIn()
    monkeypatch.setattr(rsteps, "GRAPHS", g)
    return g


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """JAX's REDUCED weights (W4A16; JAX's plain ``xla`` strategy, as its
    engine runs them on the CPU) and the port's converted copy."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch),
                               w4a16_strategy="xla")
    jparams = JT.quantize_params(JT.init_params(jax.random.PRNGKey(0), jcfg),
                                 jcfg, min_size=0)
    cfg = configs.get_reduced(arch)
    return jcfg, jparams, cfg, from_jax_params(jax_to_numpy(jparams),
                                               dtype=cfg.dtype, device="cpu")


def _requests(make, cfg, n, plen, gen, seed=0, arrive=True):
    """``n`` requests, the first two repeating a segment (ngram matches),
    with audio frames where the arch takes them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(n, plen)).astype(np.int32)
    rep = np.tile(toks[0, :4], -(-plen // 4))[:plen]
    out = []
    for i in range(n):
        audio = None
        if cfg.family == "encdec":
            audio = rng.standard_normal((cfg.encoder_seq, cfg.d_model)) \
                .astype(np.float32)
        out.append(make(rid=i, prompt=rep if i < 2 else toks[i],
                        max_new_tokens=gen,
                        arrival_step=i if arrive else 0,
                        audio_embeds=audio))
    return out


def _pool_ptrs(state):
    return [t.data_ptr() for t in rsteps.flat_leaves(state)
            if isinstance(t, torch.Tensor)]


ENGINE_CASES = {
    "danube-kv_fp16": ("h2o-danube-1.8b", dict(kv_format="kv_fp16",
                                               prefill_chunk=5)),
    "danube-kv8_channel": ("h2o-danube-1.8b",
                           dict(kv_format="kv8_channel", prefill_chunk=5)),
    "rwkv": ("rwkv6-7b", dict(prefill_chunk=3)),
    "whisper": ("whisper-small", dict(prefill_chunk=4)),
    "olmoe": ("olmoe-1b-7b", dict(prefill_chunk=5)),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_compiled_engine_gives_jax_tokens(graphs, case):
    """3 requests through 2 slots, chunked prefill between decode steps,
    the window wrapping (12 + 6 tokens over 16): JAX's tokens, every step
    after a signature's first a replay, the state's tensors the same from
    the first step to the last (the pool is never copied) and across a
    second run of the same engine."""
    arch, kw = ENGINE_CASES[case]
    jcfg, jparams, cfg, tparams = _weights(arch)
    kw = dict(max_batch=2, max_prompt_len=12, max_new_tokens=6,
              page_size=4, **kw)
    want = JServingEngine(jcfg, jparams, **kw).run(
        _requests(JRequest, jcfg, 3, 12, 6)).results
    eng = ServingEngine(cfg, tparams, device="cpu", compiled=True, **kw)
    assert eng.compiled and eng.steps_note == "compiled"
    eng.start()
    ptrs = _pool_ptrs(eng._state)
    for r in _requests(Request, cfg, 3, 12, 6):
        eng.submit(r)
    while eng.has_work():
        eng.step()
        assert _pool_ptrs(eng._state) == ptrs
    assert eng.report.results == want
    assert graphs.captures == eng.graph_pool.graphs > 0
    assert graphs.replays > 0
    captured = graphs.captures
    again = eng.run(_requests(Request, cfg, 3, 12, 6))
    assert again.results == want and _pool_ptrs(eng._state) == ptrs
    assert graphs.captures == captured          # every signature seen
    fns = [*eng._serve_fns.values(), *eng._chunk_fns.values(),
           eng._encode]
    assert eng.graph_pool.graphs == sum(
        len(f.graphs) for f in fns if isinstance(f, rsteps.CompiledStep))
    if arch in ("rwkv6-7b", "whisper-small"):
        # the chunk step reads a slot's carry or cross K/V rows through a
        # 0-d slot tensor: one graph a live-page bucket serves both slots,
        # as JAX's one executable takes the slot as a traced int32
        for chunk in eng._chunk_fns.values():
            (sig,) = chunk.graphs
            assert ((), torch.int64, torch.device("cpu")) in sig[1]


@pytest.mark.parametrize("kind", ["ngram", "draft"])
def test_compiled_speculation_gives_jax_tokens(graphs, kind):
    """danube with a proposer: the verify step (and the draft's decode and
    prefill) compiled; JAX's tokens, proposals and acceptances."""
    jcfg, jparams, cfg, tparams = _weights("h2o-danube-1.8b")
    if kind == "ngram":
        jprop = tprop = "ngram"
    else:
        jprop = jspec.make_proposer("draft:layers=1", target_cfg=jcfg)
        tprop = spec.DraftModelProposer(
            dataclasses.replace(cfg, num_layers=1),
            from_jax_params(jax_to_numpy(jprop.params), dtype=cfg.dtype,
                            device="cpu"))
    kw = dict(max_batch=2, max_prompt_len=12, max_new_tokens=8,
              page_size=4, prefill_chunk=5, spec_k=3)
    jrep = JServingEngine(jcfg, jparams, speculate=jprop, **kw).run(
        _requests(JRequest, jcfg, 3, 12, 8))
    eng = ServingEngine(cfg, tparams, device="cpu", compiled=True,
                        speculate=tprop, **kw)
    rep = eng.run(_requests(Request, cfg, 3, 12, 8))
    assert rep.results == jrep.results
    assert (rep.proposed_tokens, rep.accepted_tokens, rep.steps) == \
        (jrep.proposed_tokens, jrep.accepted_tokens, jrep.steps)
    assert rep.proposed_tokens > 0 and eng._verify_fns
    assert all(isinstance(f, rsteps.CompiledStep)
               for f in eng._verify_fns.values())
    if kind == "draft":
        assert tprop.compiled and tprop._jit_step.graphs
        assert eng.graph_pool is tprop._jit_step.pool


def test_two_prefills_ending_in_one_step_emit_their_own_tokens(graphs):
    """Two slots whose prompts fit one chunk prefill in the same step
    through one chunk graph: each slot's first-token row is cloned before
    the other's replay overwrites the static logits. On a second run both
    chunks are replays."""
    _, _, cfg, tparams = _weights("h2o-danube-1.8b")
    kw = dict(max_batch=2, max_prompt_len=8, max_new_tokens=3, page_size=4,
              prefill_chunk=8)
    reqs = _requests(Request, cfg, 2, 8, 3, seed=4, arrive=False)
    want = ServingEngine(cfg, tparams, device="cpu", **kw).run(reqs)
    eng = ServingEngine(cfg, tparams, device="cpu", compiled=True, **kw)
    eng.run(reqs)
    replays = graphs.replays
    got = eng.run(reqs)
    assert graphs.replays > replays
    assert got.results == want.results
    firsts = [got.results[r][0] for r in (0, 1)]
    assert firsts == [want.results[r][0] for r in (0, 1)]
    assert not torch.equal(got.prefill_logits[0], got.prefill_logits[1])
    for r in (0, 1):
        torch.testing.assert_close(got.prefill_logits[r],
                                   want.prefill_logits[r], rtol=0, atol=0)


def test_a_new_live_bucket_captures_and_a_seen_one_replays(graphs):
    """The gather path's decode step: one graph per live-page bucket
    (JAX's recompiles are bounded alike), captured the first time the
    bucket is met; a second run captures nothing."""
    _, _, cfg, tparams = _weights("h2o-danube-1.8b")
    kw = dict(max_batch=2, max_prompt_len=3, max_new_tokens=12,
              page_size=2, prefill_chunk=4)
    eng = ServingEngine(cfg, tparams, device="cpu", compiled=True, **kw)
    assert eng.attn_path == "gather"
    seen = []
    make = eng._serve_step

    def serve_step(live_pages=None):
        fn = make(live_pages)
        before = len(fn.graphs)

        def call(params, inputs):
            out = fn(params, inputs)
            seen.append((live_pages, len(fn.graphs) - before))
            return out
        return call
    eng._serve_step = serve_step
    reqs = _requests(Request, cfg, 2, 3, 12, arrive=False)
    eng.run(reqs)
    buckets = [b for b, _ in seen]
    assert len(set(buckets)) > 1                # the bucket grew
    first = {}
    for b, new in seen:
        assert new == (b not in first)
        first.setdefault(b, True)
    assert set(eng._serve_fns) == set(buckets)
    assert all(len(f.graphs) == 1 for f in eng._serve_fns.values())
    n = eng.graph_pool.graphs
    seen.clear()
    eng.run(reqs)
    assert eng.graph_pool.graphs == n and not any(new for _, new in seen)


def test_launch_counts_add_the_capture_per_replay(graphs):
    """A replay enters no wrapper: the capture's launches are taken back
    (a capture launches nothing) and added at every replay, so a step's
    count reads the same compiled or eager."""
    kern = build.CudaKernel("counted", "w4a16_gemm.cu", "none", [])
    form = build.KernelForm(kern, "counted_form")

    def step(params, inputs):
        kern.launches += 3          # what three wrapper launches count
        form.launches += 1
        return {"next": inputs["x"] * params["w"]}

    fn = rsteps.CompiledStep(step, "counted_step")
    params = {"w": torch.tensor(2.0)}
    for i in range(4):
        out = fn(params, {"x": torch.full((3,), float(i))})
        assert torch.equal(out["next"], torch.full((3,), 2.0 * i))
        assert (kern.launches, form.launches) == (3 * (i + 1), i + 1)
    assert (graphs.captures, graphs.replays) == (1, 3)
    build.COUNTED.remove(kern)
    build.COUNTED.remove(form)


# the device functions' names as the profiler gave them on the card (the
# names ``libcuda`` gives graph nodes are their mangled forms)
DEVICE_NAMES = {
    "w4a16_gemm": [
        "void gemm_tile::tc_gemm_kernel<__nv_bfloat16, 8, "
        "gemm_tile::Int4Ring>",
        "_ZN9gemm_tile14tc_gemm_kernelI13__nv_bfloat16Li32ENS_8Int4RingEEEv"
        "PKT_NT1_IS4_E4ArgsEPS4_PfNS_8TcParamsE",
        "void gemm_tile::f32_gemm_kernel<16, gemm_tile::Int4GroupStage>"],
    "dense_gemm": ["void gemm_tile::tc_gemm_kernel<__nv_bfloat16, 8, "
                   "gemm_tile::DenseRing>"],
    "w8a16_gemm": ["void gemm_tile::tc_gemm_kernel<__nv_bfloat16, 8, "
                   "gemm_tile::Int8Ring>"],
    "dequant_w4": ["void (anonymous namespace)::dequant_w4_kernel"
                   "<__nv_bfloat16>"],
    "reduce_partials": ["void (anonymous namespace)::reduce_partials_kernel"
                        "<__nv_bfloat16>"],
    "w4a8_gemm": ["void (anonymous namespace)::w4a8_gemm_kernel"
                  "<__nv_bfloat16, 8>"],
    "w4a8_quantize": ["void (anonymous namespace)::quantize_rows_kernel"
                      "<__nv_bfloat16, 2>"],
    "paged_attention": ["void (anonymous namespace)::paged_attn_kernel"
                        "<__nv_bfloat16, 80, false>"],
    "flash_attention": ["void (anonymous namespace)::flash_fwd_kernel"
                        "<__nv_bfloat16, 64>"],
}


def test_each_kernel_names_its_own_device_function():
    """A kernel's ``device`` substrings pick out its own device
    functions and no other kernel's nor PyTorch's, so a graph's kernel
    nodes count each kernel's launches apart."""
    from repro_torch.kernels import flash_attention, gemm, \
        paged_attention, w4a8_fused, w4a16_decoupled, w4a16_fused, \
        w8a16_fused
    kernels = {k.name: k for k in (
        w4a16_fused.W4A16_GEMM, gemm.DENSE_GEMM, w8a16_fused.W8A16_GEMM,
        w4a16_decoupled.DEQUANT_W4, w4a16_decoupled.REDUCE_PARTIALS,
        w4a8_fused.W4A8_GEMM, w4a8_fused.W4A8_QUANTIZE,
        paged_attention.PAGED_ATTENTION, flash_attention.FLASH_ATTENTION)}
    assert set(kernels) == set(DEVICE_NAMES)
    assert {k.name for k in build.COUNTED if isinstance(k, build.CudaKernel)
            and k.device} == set(DEVICE_NAMES)
    torch_names = ["void at::native::vectorized_elementwise_kernel<4>",
                   "nvjet_tst_512x8_64x3_2x1_v_bz_NNT",
                   "void cutlass::Kernel2<cutlass_80_simt_sgemm_64x64_8x5"
                   "_nn_align1>"]
    for name, k in kernels.items():
        for other, names in DEVICE_NAMES.items():
            for n in names:
                assert all(p in n for p in k.device) == (other == name), \
                    (name, n)
        assert not any(all(p in n for p in k.device) for n in torch_names)
    # the names of one of each, against counts of one each
    names = [ns[0] for ns in DEVICE_NAMES.values()]
    assert build.node_mismatch({k: 1 for k in kernels.values()}, names) == []
    bad = build.node_mismatch({kernels["w4a16_gemm"]: 2}, names)
    assert "w4a16_gemm: 2 launches counted, 1 kernel nodes in the graph" \
        in bad and len(bad) == len(kernels)


def test_a_graph_without_its_counted_launches_raises(monkeypatch):
    """The capture holds the launches counted during it against its
    graph's kernel nodes: a counted launch the graph lacks raises, naming
    the kernel; a graph that holds them counts them in the pool's
    ``nodes``."""
    kern = build.CudaKernel("counted", "w4a16_gemm.cu", "none", [],
                            device=("counted_kernel",))

    def step(params, inputs):
        kern.launches += 2          # what two wrapper launches count
        return {"next": inputs["x"] * params["w"]}

    params = {"w": torch.tensor(2.0)}
    try:
        monkeypatch.setattr(rsteps, "GRAPHS", StandIn(
            nodes=["void counted_kernel<8>(Args)", "void other<8>(Args)"]))
        fn = rsteps.CompiledStep(step, "counted_step")
        with pytest.raises(RuntimeError, match="counted_step at signature "
                           r"\(3,\) float32: the graph's kernel nodes "
                           "disagree .* counted: 2 launches counted, 1 "
                           "kernel nodes"):
            fn(params, {"x": torch.ones(3)})
        assert not fn.graphs
        monkeypatch.setattr(rsteps, "GRAPHS", StandIn())
        fn = rsteps.CompiledStep(step, "counted_step")
        fn(params, {"x": torch.ones(3)})
        assert fn.graphs and fn.pool.nodes == 2
    finally:
        build.COUNTED.remove(kern)


def test_outputs_alias_and_the_donated_state_is_written_back(graphs):
    """A state leaf the step returns anew is copied into the caller's
    leaf (inside the graph); the call returns the caller's state tree; a
    replay overwrites the last replay's outputs (JAX's donation and a
    graph's static buffers)."""
    def step(params, state, inputs):
        new = {"cache": {"carry": state["cache"]["carry"] + inputs["x"],
                         "pool": state["cache"]["pool"]}}
        state["cache"]["pool"].add_(1)          # in place, as the pool
        return {"logits": new["cache"]["carry"] * 10, "state": new}

    fn = rsteps.CompiledStep(step, "toy_step", state=lambda a: a[0])
    params = {}
    state = {"cache": {"carry": torch.zeros(2), "pool": torch.zeros(4)}}
    carry, pool = state["cache"]["carry"], state["cache"]["pool"]
    outs = []
    for i in range(3):
        out = fn(params, state, {"x": torch.ones(2)})
        assert out["state"] is state
        assert state["cache"]["carry"] is carry
        assert state["cache"]["pool"] is pool
        outs.append(out["logits"])
    assert torch.equal(carry, torch.full((2,), 3.0))
    assert torch.equal(pool, torch.full((4,), 3.0))
    # replays 2 and 3 share one static output: the last value in both
    assert outs[1] is outs[2] and torch.equal(outs[2], carry * 10)
    assert torch.equal(outs[0], torch.full((2,), 10.0))
    with pytest.raises(ValueError, match="other weights"):
        fn({"w": 1}, state, {"x": torch.ones(2)})


def test_compiled_true_is_refused_where_steps_stay_eager():
    """On the CPU (no stand-in) and on a mesh, ``compiled=True`` raises,
    naming the reason; the default runs those eagerly and says why; the
    ``jit_*`` steps refuse a mesh, JAX's sharded steps' named departure."""
    _, _, cfg, tparams = _weights("h2o-danube-1.8b")
    kw = dict(max_batch=2, max_prompt_len=8, max_new_tokens=3, page_size=4,
              device="cpu")
    with pytest.raises(ValueError, match="compiled=True: CUDA graphs "
                       "capture work on the card only"):
        ServingEngine(cfg, tparams, compiled=True, **kw)
    for compiled in (None, False):
        eng = ServingEngine(cfg, tparams, compiled=compiled, **kw)
        assert not eng.compiled and eng.graph_pool is None
        assert eng.steps_note == "eager (CUDA graphs capture work on the " \
            "card only; cpu steps run eagerly)"
    with pytest.raises(ValueError, match="on a mesh the serving steps stay "
                       "eager: a rank's collectives go through gloo"):
        ServingEngine(cfg, tparams, mesh=object(), compiled=True, **kw)
    assert rsteps.eager_reason("cuda", object()) == rsteps.MESH_DEPARTURE
    assert rsteps.eager_reason("cuda") is None
    for jit in (rsteps.jit_serve_step, rsteps.jit_encode_step):
        with pytest.raises(ValueError, match="on a mesh"):
            jit(cfg, mesh=object())
    for jit in (rsteps.jit_prefill_chunk_step, rsteps.jit_verify_step,
                rsteps.jit_prefill_step):
        with pytest.raises(ValueError, match="on a mesh"):
            jit(cfg, 16, mesh=object())
    # a compiled step given CPU tensors without a stand-in refuses them
    with pytest.raises(ValueError, match="serve_step: CUDA graphs capture"):
        rsteps.jit_serve_step(cfg)(tparams, {"tokens": torch.zeros(2)})


def test_a_failing_capture_raises_and_nothing_falls_back(monkeypatch):
    """A capture that fails raises, naming the step and its signature: no
    eager fallback, the run stops."""
    monkeypatch.setattr(rsteps, "GRAPHS", StandIn(fail=True))
    _, _, cfg, tparams = _weights("h2o-danube-1.8b")
    eng = ServingEngine(cfg, tparams, device="cpu", compiled=True,
                        max_batch=2, max_prompt_len=8, max_new_tokens=3,
                        page_size=4, prefill_chunk=4)
    before = build.launch_counts()
    with pytest.raises(RuntimeError, match=r"capturing prefill_chunk_step "
                       r"failed at signature .*\(1, 4, 128\) float32, "
                       r"\(1, 4\) int32.*: operation not permitted"):
        eng.run(_requests(Request, cfg, 2, 8, 3, arrive=False))
    assert build.launch_counts() == before


def test_serve_launcher_says_how_it_ran(capsys):
    """The steps line: eager on the CPU, with the reason, ``--eager`` or
    not."""
    argv = ["--arch", "h2o-danube-1.8b", "--reduced", "--batch", "2",
            "--prompt-len", "6", "--gen", "2", "--page-size", "4",
            "--device", "cpu"]
    for extra in ([], ["--eager"]):
        tserve.main(argv + extra)
        assert "[serve] steps: eager (CUDA graphs capture work on the " \
            "card only; cpu steps run eagerly)" in capsys.readouterr().out


def test_serve_launcher_compiled_under_the_stand_in(graphs, capsys):
    """With a capture to use, the launcher compiles by default and prints
    what it captured; ``--eager`` prints the same sample generation."""
    argv = ["--arch", "rwkv6-7b", "--reduced", "--batch", "2",
            "--prompt-len", "6", "--gen", "3", "--device", "cpu"]
    tserve.main(argv)
    out = capsys.readouterr().out
    assert "[serve] steps: compiled (CUDA graphs: " in out
    assert f"{graphs.captures} captured, 0.0 MiB in their pools" in out
    sample = [ln for ln in out.splitlines() if "sample generation" in ln]
    tserve.main(argv + ["--eager"])
    eager = capsys.readouterr().out
    assert "[serve] steps: eager (compiled=False)" in eager
    assert sample == [ln for ln in eager.splitlines()
                      if "sample generation" in ln]
