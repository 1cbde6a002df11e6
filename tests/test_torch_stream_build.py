"""The streamed serving build (``models/transformer.py:init_serving_params``:
weights drawn and quantized layer by layer) and the serve launcher's
choice of build on the CPU, at REDUCED size:

- the streamed W4A16 leaves equal ``quantize_params`` of the same dense
  draws (``quantize=False``, stacked as ``init_params`` stacks them), and
  the JAX package's ``quantize_params`` of them, bit for bit; the planner
  plans the per-layer list as the stacked tree;
- the port's engine on the streamed tree gives the JAX engine's greedy
  tokens on JAX's quantization of the same dense weights (MoE at a
  capacity factor where no pair drops);
- the launcher's streamed build serves the engine's tokens;
- the reckoning (``T.serving_build_bytes``, ``launch.serve.plan_build``)
  on the meta device: the streamed peak equals the bytes a meta run of the
  build holds at once; the launcher streams full mixtral-8x7b and
  granite-20b and builds danube whole, whatever the KV pool or the
  device; it refuses by the larger of the build's peak and the packed
  weights beside the KV pool, and refuses llama3-405b before drawing.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.runtime.engine import Request as JRequest
from repro.runtime.engine import ServingEngine as JServingEngine

from repro_torch import configs
from repro_torch.core.quant import QuantizedTensor
from repro_torch.kernels import planning
from repro_torch.launch import dryrun
from repro_torch.launch import serve as tserve
from repro_torch.launch.presets import serve_settings_for
from repro_torch.launch.train import CARD_BYTES
from repro_torch.models import transformer as T
from repro_torch.runtime.engine import Request, ServingEngine

from torch_parity_helpers import jax_to_numpy

STREAMED = ("h2o-danube-1.8b", "mixtral-8x7b", "granite-20b",
            "starcoder2-7b")
HELD = ("mixtral-8x7b", "granite-20b")
P, G = 8, 4


@functools.lru_cache(maxsize=None)
def built(arch):
    """The REDUCED config, its streamed W4A16 tree and the dense tree of
    the same draws (seed 0, the launcher's default)."""
    cfg = configs.get_reduced(arch)

    def draw(quantize):
        gen = torch.Generator()
        gen.manual_seed(0)
        return T.init_serving_params(gen, cfg, device="cpu",
                                     quantize=quantize)
    return cfg, draw(True), draw(False)


def flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from flat(v, path + (i,))
    else:
        yield path, tree


def fields(leaf):
    if isinstance(leaf, QuantizedTensor):
        return (leaf.packed, leaf.scales, leaf.zeros, leaf.group_size,
                leaf.format.name, leaf.out_dtype)
    return (leaf,)


def assert_bit_equal(got, want):
    got, want = list(flat(got)), list(flat(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert type(a) is type(b), path
        for x, y in zip(fields(a), fields(b)):
            if isinstance(x, torch.Tensor):
                assert x.dtype == y.dtype and torch.equal(x, y), path
            else:
                assert x == y, path


def restack(layers):
    """Per-layer dicts → one dict of (L, ...) stacks (init_params's form)."""
    if isinstance(layers[0], dict):
        return {k: restack([lp[k] for lp in layers]) for k in layers[0]}
    return torch.stack(layers)


def stacked_trees(dense):
    """The dense draws as init_params's stacked tree, and that tree as the
    JAX package's (jnp arrays)."""
    stacked = dict(dense, layers=restack(dense["layers"]))
    jtree = {}
    for path, v in flat(stacked):
        d = jtree
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = jnp.asarray(v.numpy())
    return stacked, jtree


@pytest.mark.parametrize("arch", STREAMED)
def test_streamed_tree_is_quantize_params_of_its_dense_draws(arch):
    """The streamed leaves equal ``quantize_params`` of the same dense draws
    stacked as ``init_params`` stacks them, layer by layer, and the
    planner plans the per-layer list as the stacked tree."""
    cfg, streamed, dense = built(arch)
    assert len(streamed["layers"]) == cfg.num_layers
    stacked, _ = stacked_trees(dense)
    port = T.quantize_params(stacked, cfg, min_size=0)
    assert_bit_equal(streamed, T.unstack_layers(port))
    assert planning.plan_for_params(streamed, M=8) == \
        planning.plan_for_params(port, M=8)
    # the dense draws have init_params's leaves and shapes, layer by layer
    meta = T.unstack_layers(T.abstract_params(cfg))
    assert [(p, tuple(t.shape), t.dtype) for p, t in flat(dense)] == \
        [(p, tuple(t.shape), t.dtype) for p, t in flat(meta)]
    # every layer linear quantized; embed, head and router dense
    lp = streamed["layers"][-1]
    assert isinstance(lp["attn"]["wo"]["kernel"], QuantizedTensor)
    assert not isinstance(streamed["embed"]["table"], QuantizedTensor)
    assert not isinstance(streamed["lm_head"]["kernel"], QuantizedTensor)
    if cfg.family == "moe":
        assert not isinstance(lp["moe"]["router"]["kernel"],
                              QuantizedTensor)
        assert lp["moe"]["w_gate"]["kernel"].packed.shape[0] == \
            cfg.num_experts


@pytest.mark.parametrize("arch", HELD)
def test_streamed_leaves_equal_jax_quantize_params(arch):
    """The dense draws restacked and handed to JAX's ``quantize_params``:
    its packed ints and scales equal the streamed leaves, layer by
    layer."""
    cfg, streamed, dense = built(arch)
    jcfg = jconfigs.get_reduced(arch)
    _, jtree = stacked_trees(dense)
    jq = jax_to_numpy(JT.quantize_params(jtree, jcfg, min_size=0))
    n = 0
    for i, lp in enumerate(streamed["layers"]):
        for path, leaf in flat(lp):
            jl = jq["layers"]
            for k in path:
                jl = jl[k]
            if not isinstance(leaf, QuantizedTensor):
                assert not isinstance(jl, dict) or "packed" not in jl, path
                continue
            assert np.array_equal(jl["packed"][i].view(np.int8),
                                  leaf.packed.numpy()), (i, path)
            assert np.array_equal(jl["scales"][i], leaf.scales.numpy()), \
                (i, path)
            assert jl["zeros"] is None and leaf.zeros is None
            assert jl["group_size"] == leaf.group_size
            n += 1
    assert n == cfg.num_layers * 7      # attention 4, the MLP or experts 3


@pytest.mark.parametrize("arch", HELD)
def test_engine_on_the_streamed_tree_gives_jax_engines_tokens(arch):
    cfg, streamed, dense = built(arch)
    jcfg = jconfigs.get_reduced(arch)
    if cfg.family == "moe":        # no (token, expert) pair drops
        cfg = dataclasses.replace(
            cfg, moe_capacity_factor=float(cfg.num_experts))
        jcfg = dataclasses.replace(
            jcfg, moe_capacity_factor=float(jcfg.num_experts))
    jparams = JT.quantize_params(stacked_trees(dense)[1], jcfg, min_size=0)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, size=(3, P)).astype(np.int32)
    kw = dict(max_batch=2, max_prompt_len=P, max_new_tokens=G, page_size=4,
              prefill_chunk=4)
    want = JServingEngine(jcfg, jparams, **kw).run(
        [JRequest(rid=i, prompt=toks[i], max_new_tokens=G, arrival_step=i)
         for i in range(3)]).results
    got = ServingEngine(cfg, streamed, device="cpu", **kw).run(
        [Request(rid=i, prompt=toks[i], max_new_tokens=G, arrival_step=i)
         for i in range(3)]).results
    assert got == want
    assert all(len(v) == G for v in got.values())


def test_serve_launcher_streamed_build_gives_the_engines_tokens(
        capsys, monkeypatch):
    """The launcher streams an arch whose whole build passes one card (here
    REDUCED mixtral, its whole peak reckoned past the card) and serves
    the engine's tokens on the streamed tree."""
    arch = "mixtral-8x7b"
    reckon = T.serving_build_bytes
    monkeypatch.setattr(T, "serving_build_bytes", lambda cfg, **kw:
                        dataclasses.replace(reckon(cfg, **kw),
                                            whole=CARD_BYTES + 1))
    rep = tserve.main(["--arch", arch, "--reduced", "--batch", "2",
                       "--prompt-len", "6", "--gen", "3", "--page-size", "4",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "(streamed build: peak " in out and "MB reckoned" in out
    cfg, streamed, _ = built(arch)
    sset = serve_settings_for(arch)
    want = ServingEngine(
        cfg, streamed, max_batch=2, max_prompt_len=6, max_new_tokens=3,
        page_size=4, prefill_chunk=sset.prefill_chunk,
        kv_format=sset.kv_format, attn_path=sset.attn_path,
        device="cpu").run(tserve.make_requests(cfg, 2, 6, 3, 0))
    assert rep.results == want.results
    assert all(len(v) == 3 for v in rep.results.values())


@pytest.mark.parametrize("arch, layers", [("granite-20b", 3),
                                          ("h2o-danube-1.8b", 2),
                                          ("mixtral-8x7b", 2)])
def test_streamed_peak_is_the_meta_builds_peak(arch, layers):
    """The reckoned streamed peak equals the most bytes of storage that
    the build, run on the meta device at full width, holds at once
    (``dryrun.MetaMemory``), and the packed bytes what it keeps."""
    cfg = dataclasses.replace(configs.get_config(arch), num_layers=layers)
    mem = dryrun.MetaMemory()
    with mem:
        params = T.init_serving_params(torch.Generator(), cfg, device="meta")
    est = T.serving_build_bytes(cfg)
    assert est.streamed == mem.peak
    assert est.packed == mem.live
    del params


def test_build_reckoning_on_the_meta_device(monkeypatch):
    """No weight is drawn: every ``randn`` of the reckoning is on meta. The
    choice rests on the shapes alone: neither the KV pool nor the
    device's bytes move it."""
    randn = torch.randn

    def meta_only(*args, **kw):
        assert str(kw.get("device")) == "meta", kw
        return randn(*args, **kw)
    monkeypatch.setattr(torch, "randn", meta_only)
    gib = 2 ** 30
    for arch, mode in [("mixtral-8x7b", "streamed"),
                       ("granite-20b", "streamed"),
                       ("starcoder2-7b", "whole"),
                       ("h2o-danube-1.8b", "whole")]:
        cfg = configs.get_config(arch)
        plan = tserve.plan_build(cfg)
        assert plan.mode == mode, arch
        assert plan.peak == (plan.bytes.streamed if mode == "streamed"
                             else plan.bytes.whole)
        assert plan.need <= CARD_BYTES
        for kv, have in [(40 * gib, CARD_BYTES), (0, 2 * CARD_BYTES)]:
            assert tserve.plan_build(cfg, kv_bytes=kv, have=have).mode \
                == mode, (arch, kv, have)
    mixtral = tserve.plan_build(configs.get_config("mixtral-8x7b"))
    assert mixtral.bytes.whole > CARD_BYTES > mixtral.bytes.streamed
    # mixtral's packed bytes by hand: int4 weights and fp32 group-128
    # scales for every layer linear and expert, bf16 router, norms,
    # embedding and head
    c = configs.get_config("mixtral-8x7b")
    d, ff, E = c.d_model, c.d_ff, c.num_experts

    def w4(K, N):
        return K * N // 2 + K // c.group_size * N * 4
    layer = 2 * w4(d, c.q_dim) + 2 * w4(d, c.kv_dim) \
        + E * (2 * w4(d, ff) + w4(ff, d)) + 2 * d * E + 2 * 2 * d
    assert mixtral.bytes.packed == c.num_layers * layer \
        + 2 * 2 * c.padded_vocab * d + 2 * d


def test_the_kv_pool_counts_beside_the_packed_weights():
    """The engine allocates its pool once the build's transients are
    freed: a config fits when both the build's peak and the packed weights
    beside the pool do, though the peak and the pool together pass."""
    cfg = configs.get_config("mixtral-8x7b")
    est = tserve.plan_build(cfg).bytes
    transient = est.streamed - est.packed
    have = est.streamed + transient // 2
    kv = have - est.packed                 # packed + kv == have < peak + kv
    plan = tserve.plan_build(cfg, kv_bytes=kv, have=have)
    assert plan.peak + kv > have and plan.need == have
    with pytest.raises(ValueError, match="beside the KV pool"):
        tserve.plan_build(cfg, kv_bytes=kv + 1, have=have)
    with pytest.raises(ValueError, match="the build's peak"):
        tserve.plan_build(cfg, have=est.streamed - 1)


def test_launcher_refuses_what_cannot_fit_before_drawing(monkeypatch):
    init_params = T.init_params

    def meta_only(gen, cfg, *, device=None, **kw):
        assert str(device) == "meta", "a weight was drawn"
        return init_params(gen, cfg, device=device, **kw)

    def drawn(*a, **kw):
        raise AssertionError("a weight was drawn")
    monkeypatch.setattr(T, "init_params", meta_only)
    monkeypatch.setattr(T, "init_serving_params", drawn)
    with pytest.raises(ValueError, match="llama3-405b cannot serve on one "
                                         "device: its streamed build"):
        tserve.build(tserve.build_args(["--arch", "llama3-405b",
                                        "--device", "cpu"]))


@pytest.mark.parametrize("arch", ["rwkv6-7b", "hymba-1.5b", "whisper-small"])
def test_streamed_build_refuses_other_families(arch):
    cfg = configs.get_reduced(arch)
    with pytest.raises(NotImplementedError, match=repr(cfg.family)):
        T.init_serving_params(torch.Generator(), cfg, device="cpu")
    # the launcher builds them whole, at full size too
    assert T.serving_build_bytes(cfg).streamed is None
    assert tserve.plan_build(cfg).mode == "whole"
    assert tserve.plan_build(configs.get_config(arch)).mode == "whole"
    # a mesh's ranks cut each leaf as it is drawn: the whole build
    assert tserve.plan_build(configs.get_config("mixtral-8x7b"),
                             mesh=True).mode == "whole"
