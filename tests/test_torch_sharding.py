"""The port's sharding rules (``repro_torch/runtime/sharding.py``,
``planning.shard_problem``) against the JAX package's, on spec-level
meshes: no ranks and no collectives (``test_torch_mesh.py`` runs the
ranks).

The port's cut departs from JAX's where a rank that runs its shard alone
cannot take JAX's layout; each departure has a case of its own:
``row_groups`` (a row-parallel K splits only into whole quant groups),
``kv_heads`` (KV heads fewer than the model axis are replicated whole, not
split by columns) and ``attention_whole`` (query heads the model axis does
not divide keep the attention block whole).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.core import quant as jquant
from repro.kernels import planning as jplanning
from repro.models import transformer as JT
from repro.runtime import sharding as jshd

from repro_torch import configs
from repro_torch.convert import from_jax_params
from repro_torch.core import quant
from repro_torch.core.quant import QuantizedTensor
from repro_torch.kernels import planning
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as T
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.engine import ServingEngine

from torch_parity_helpers import jax_to_numpy

MESHES = [(1, 2), (1, 4), (2, 4), (1, 8)]


class FakeMesh:
    """Spec-level mesh stand-in (the JAX package's tests' FakeMesh, plus
    this rank's coordinates)."""

    def __init__(self, sizes, coords=None):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)
        self.coords = dict(coords or {})


def fake(dm, model=0, data=0):
    return FakeMesh({"data": dm[0], "model": dm[1]},
                    {"data": data, "model": model})


def meta_kernel(shape):
    return torch.empty(shape, device="meta")


# ---------------------------------------------------------------------------
# name rules, batch specs, pool specs
# ---------------------------------------------------------------------------

def test_name_rules_are_jax_rules():
    assert (shd.COL, shd.ROW, shd.REP) == (jshd.COL, jshd.ROW, jshd.REP)
    for names in (("layers", "attn", "wq", "kernel"),
                  ("layers", "mlp", "w_down", "kernel"),
                  ("layers", "moe", "router", "kernel"),
                  ("layers", "moe", "w_up", "kernel"), ("lm_head", "kernel"),
                  ("final_norm", "scale"), ("layers", "tm_o", "kernel")):
        assert shd.leaf_kind_for_path(names) == jshd._leaf_kind(list(names))


def test_tp_rules_dense():
    """granite-20b at model 16: column-parallel QKV/up, row-parallel
    out/down, the vocab over model (JAX's ``test_tp_rules_dense`` without
    FSDP); its single KV head is held whole by every rank."""
    cfg = configs.get_config("granite-20b")
    lay = shd.Layout(cfg, fake((1, 16), model=3))
    d, ff, q = cfg.d_model, cfg.d_ff, cfg.q_dim

    def cut(path, shape):
        return lay.leaf_cut(path, {"kernel": meta_kernel(shape)})

    assert cut(("layers", "attn", "wq"), (d, q)) == ("col", -1, 16, 3)
    assert cut(("layers", "attn", "wk"), (d, cfg.kv_dim)) == \
        ("col", -1, 1, 0)
    assert cut(("layers", "attn", "wo"), (q, d)) == ("row", -2, 16, 3)
    assert cut(("layers", "mlp", "w_up"), (d, ff)) == ("col", -1, 16, 3)
    assert cut(("layers", "mlp", "w_down"), (ff, d)) == ("row", -2, 16, 3)
    assert lay.leaf_cut(("embed",), {"table": meta_kernel(
        (cfg.padded_vocab, d))}) == ("vocab", -2, 16, 3)
    assert lay.local_cfg().num_heads == cfg.num_heads // 16
    assert lay.local_cfg().num_kv_heads == 1


def test_tp_rules_respect_divisibility():
    """internvl2-1b at model 16: d_ff 4864 divides (w_up column-parallel,
    as in JAX); its 14 query heads do not, so its attention stays whole
    (the ``attention_whole`` departure)."""
    cfg = configs.get_config("internvl2-1b")
    lay = shd.Layout(cfg, fake((1, 16)))
    assert lay.leaf_cut(("layers", "mlp", "w_up"), {"kernel": meta_kernel(
        (cfg.d_model, cfg.d_ff))})[:2] == ("col", -1)
    assert lay.leaf_cut(("layers", "attn", "wq"), {"kernel": meta_kernel(
        (cfg.d_model, cfg.q_dim))}) is None
    assert not lay.attn_sharded and lay.local_cfg().num_heads == 14


def test_quantized_leaves_shard_like_dense():
    """A QuantizedTensor's packed (L, K/2, N) and scales (L, K/g, N)
    follow one rule: both cut on N (column) or both on K (row)."""
    cfg = dataclasses.replace(configs.get_reduced("granite-20b"),
                              group_size=32)
    gen = torch.Generator().manual_seed(0)
    params = T.quantize_params(T.init_params(gen, cfg), cfg, min_size=0)
    local = shd.shard_params(params, fake((2, 2), model=1), cfg)
    for name, dim in (("w_up", -1), ("w_down", -2)):
        whole = params["layers"]["mlp"][name]["kernel"]
        got = local["layers"]["mlp"][name]["kernel"]
        for w, g in ((whole.packed, got.packed), (whole.scales, got.scales)):
            want = list(w.shape)
            want[dim] //= 2
            assert list(g.shape) == want
        assert local["layers"]["mlp"][name]["tp"] == \
            ("col" if dim == -1 else "row")


@pytest.mark.parametrize("B", [1, 3, 16, 256])
def test_batch_spec_matches_jax(B):
    for sizes in ({"pod": 2, "data": 16, "model": 16},
                  {"data": 4, "model": 2}, {"data": 1, "model": 4}):
        m = FakeMesh(sizes)
        axes = shd.batch_spec(B, m)
        assert P(axes or None) == jshd.batch_spec(B, m)
        assert shd.batch_axis_entry(B, m) == jshd.batch_axis_entry(B, m)


def _pool_state(cfg):
    from repro_torch.runtime import kvcache as kvc
    return {"cache": {"kv": kvc.init_pool(
        5, 4, cfg.num_kv_heads, cfg.head_dim, cfg.dtype, "kv8_channel",
        num_layers=cfg.num_layers, device="meta")}}


def _jax_pool_specs(cfg, mesh):
    from repro.runtime import kvcache as jkvc
    state = {"cache": {"kv": jax.eval_shape(lambda: jax.tree.map(
        lambda x: jax.numpy.broadcast_to(x, (cfg.num_layers,) + x.shape),
        jkvc.init_pool(5, 4, cfg.num_kv_heads, cfg.head_dim,
                       jax.numpy.float32, "kv8_channel")))}}
    real = jshd.NamedSharding
    try:
        jshd.NamedSharding = lambda m, spec: spec
        specs = jshd.decode_state_shardings(state, cfg, mesh)
    finally:
        jshd.NamedSharding = real
    return [tuple(s) + (None,) * (n - len(tuple(s)))
            for s, n in zip(specs["cache"]["kv"], (5, 5, 3, 4, 4))]


@pytest.mark.parametrize("arch,dm,same", [
    ("h2o-danube-1.8b", (2, 4), True),      # 8 KV heads over 4: as JAX
    ("llama3-405b", (1, 4), False),         # 2 over 4: kv_heads departure
])
def test_pool_specs(arch, dm, same):
    """Pages replicate over "data"; the KV-head dim shards over "model"
    (JAX's rule) — also where the port replicates each KV head over
    tp/Hkv ranks, which JAX replicates whole."""
    cfg = configs.get_reduced(arch) if not same else configs.get_config(arch)
    jcfg = (jconfigs.get_reduced if not same else jconfigs.get_config)(arch)
    mesh = fake(dm)
    got = [s for s in shd.decode_state_shardings(_pool_state(cfg), cfg,
                                                 mesh)["cache"]["kv"]]
    assert got[0] == (None, None, None, "model", None)
    assert got[2] == (None, None, None)
    assert (got == _jax_pool_specs(jcfg, mesh)) == same


# ---------------------------------------------------------------------------
# shard_problem against JAX's, every quantized leaf of the ten configs
# ---------------------------------------------------------------------------

_ABSTRACT = {}


def jax_quantized_leaves(arch):
    """(names, abstract QuantizedTensor) of the full config's W4A16
    params (shapes only)."""
    if arch not in _ABSTRACT:
        cfg = jconfigs.get_config(arch)
        tree = jax.eval_shape(lambda: JT.quantize_params(
            JT.init_params(jax.random.PRNGKey(0), cfg), cfg))
        flat, _ = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda t: isinstance(t, jquant.QuantizedTensor))
        _ABSTRACT[arch] = [
            (tuple(str(getattr(k, "key", k)) for k in path), leaf)
            for path, leaf in flat
            if isinstance(leaf, jquant.QuantizedTensor)]
    return _ABSTRACT[arch]


def problems(leaf, M=8):
    K = leaf.packed.shape[-2] * leaf.format.pack_factor
    N = leaf.packed.shape[-1]
    kw = dict(M=M, N=N, K=K, group_size=leaf.group_size,
              format=leaf.format.name)
    quant.resolve_format(leaf.format.to_dict())
    return jplanning.MatmulProblem(**kw), planning.MatmulProblem(**kw)


def port_local(cfg, dm, names, leaf, problem):
    """The GEMM a rank executes for this leaf: the Layout's cut."""
    mesh = fake(dm)
    qt = QuantizedTensor(
        meta_kernel(leaf.packed.shape).to(torch.int8),
        meta_kernel(leaf.scales.shape), None, leaf.group_size,
        torch.bfloat16, quant.resolve_format(leaf.format.to_dict()))
    cut = shd.Layout(cfg, mesh).leaf_cut(names[:-1], {"kernel": qt})
    kind = "rep" if cut is None or cut[0] == "gather" else \
        ("row" if cut[1] == -2 else "col")
    return planning.shard_problem(problem, mesh, kind,
                                  parts=cut[2] if kind == "col" else None)


def departure(cfg, dm, names, problem, got, want):
    """Which named departure explains ``got`` != JAX's ``want`` (None when
    they agree)."""
    tp = dm[1]
    if (got.M, got.N, got.K) == (want.M, want.N, want.K):
        return None
    lay = shd.Layout(cfg, fake(dm))
    if ("attn" in names or "cross" in names) and not lay.attn_sharded:
        assert cfg.num_heads % tp or (cfg.num_kv_heads % tp
                                      and tp % cfg.num_kv_heads)
        assert (got.N, got.K) == (problem.N, problem.K)
        return "attention_whole"
    if names[-2] in ("wk", "wv") and tp > cfg.num_kv_heads:
        assert tp % cfg.num_kv_heads == 0
        assert got.N == problem.N // cfg.num_kv_heads == cfg.head_dim
        return "kv_heads"
    assert shd.leaf_kind_for_path(names) == "row"
    assert not planning.splits_k(problem, tp) and problem.K % tp == 0
    assert (got.K, want.K) == (problem.K, problem.K // tp)
    return "row_groups"


@pytest.mark.parametrize("dm", MESHES, ids=lambda dm: f"{dm[0]}x{dm[1]}")
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_shard_problem_matches_jax(arch, dm):
    """Every quantized leaf of the full config: the local GEMM the port
    executes equals JAX's ``shard_problem`` (M over the data axis, N or K
    over model) but for the named departures."""
    cfg = configs.get_config(arch)
    mesh = fake(dm)
    for names, leaf in jax_quantized_leaves(arch):
        jp, tp_ = problems(leaf)
        want = jplanning.shard_problem(jp, mesh,
                                       jshd._leaf_kind(list(names)))
        got = port_local(cfg, dm, names, leaf, tp_)
        assert got.M == want.M == 8 // dm[0]
        departure(cfg, dm, names, tp_, got, want)


@pytest.mark.parametrize("name,arch,dm,leaf,port,jax_", [
    # danube's d_ff 6912 is 54 groups of 128: K/4 would split one
    ("row_groups", "h2o-danube-1.8b", (1, 4), "w_down", 6912, 1728),
    # granite's single KV head: every rank holds it whole
    ("kv_heads", "granite-20b", (1, 4), "wk", 128, 32),
    # internvl2's 14 query heads: the attention stays whole
    ("attention_whole", "internvl2-1b", (1, 4), "wq", 896, 224),
])
def test_named_departure(name, arch, dm, leaf, port, jax_):
    cfg = configs.get_config(arch)
    mesh = fake(dm)
    hit = [(names, lf) for names, lf in jax_quantized_leaves(arch)
           if names[-2] == leaf]
    assert len(hit) == 1
    names, lf = hit[0]
    jp, tp_ = problems(lf)
    want = jplanning.shard_problem(jp, mesh, jshd._leaf_kind(list(names)))
    got = port_local(cfg, dm, names, lf, tp_)
    assert departure(cfg, dm, names, tp_, got, want) == name
    dim = "K" if name == "row_groups" else "N"
    assert (getattr(got, dim), getattr(want, dim)) == (port, jax_)


# ---------------------------------------------------------------------------
# the weight cut: reassembly, draw-time cut, plans
# ---------------------------------------------------------------------------

def _converted(arch, group_size=128):
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch),
                               group_size=group_size)
    jparams = JT.quantize_params(JT.init_params(jax.random.PRNGKey(0), jcfg),
                                 jcfg, min_size=0)
    cfg = dataclasses.replace(configs.get_reduced(arch),
                              group_size=group_size)
    return cfg, from_jax_params(jax_to_numpy(jparams), dtype=cfg.dtype)


def _arrays(leaf):
    if isinstance(leaf, QuantizedTensor):
        return [leaf.packed, leaf.scales]
    return [leaf]


def _walk(tree, path=()):
    if isinstance(tree, dict):
        if "kernel" in tree or "table" in tree:
            yield path, tree
            return
        for k, v in tree.items():
            yield from _walk(v, path + (k,))


@pytest.mark.parametrize("arch,dm", [
    ("h2o-danube-1.8b", (1, 2)), ("h2o-danube-1.8b", (1, 4)),
    ("llama3-405b", (1, 4)), ("olmoe-1b-7b", (1, 2)),
    ("internvl2-1b", (2, 2))])
def test_shard_params_reassembles_the_whole_tree(arch, dm):
    """shard_params on converted JAX params: the model ranks' slices of
    every leaf concatenate back to the whole leaf exactly (KV heads held
    by several ranks counted once); data ranks hold the same slices."""
    cfg, whole = _converted(arch)
    tp = dm[1]
    ranks = [shd.shard_params(whole, fake(dm, model=r), cfg)
             for r in range(tp)]
    assert shd.shard_params(whole, fake(dm, model=1, data=dm[0] - 1),
                            cfg)["layers"]["attn"]["wq"]["kernel"] \
        .packed.equal(ranks[1]["layers"]["attn"]["wq"]["kernel"].packed)
    lay = shd.Layout(cfg, fake(dm))
    n_cut = 0
    for path, p in _walk(whole):
        key = "table" if "table" in p else "kernel"
        parts = [dict(_walk(r))[path] for r in ranks]
        cut = lay.leaf_cut(path, p)
        if cut is None or cut[0] == "gather":
            for q in parts:
                assert q[key] is p[key]
            continue
        n_cut += 1
        _, dim, n, _ = cut
        # the first rank of each group that holds the same part
        held = parts[::tp // n]
        for a, pieces in zip(_arrays(p[key]),
                             zip(*(_arrays(q[key]) for q in held))):
            assert torch.equal(torch.cat(pieces, dim=dim), a)
    assert n_cut >= 5


@pytest.mark.parametrize("arch,dm,group", [
    ("h2o-danube-1.8b", (1, 2), 128), ("h2o-danube-1.8b", (1, 4), 32),
    ("llama3-405b", (1, 4), 128), ("olmoe-1b-7b", (1, 2), 128)])
def test_draw_time_cut_equals_cut_of_quantized(arch, dm, group):
    """``init_params(cut=layout.cut)`` then quantizing the slice gives
    exactly the slice of the whole quantized tree, on every rank: the
    generator is consumed as without the cut, and a row-parallel K splits
    only into whole groups."""
    cfg = dataclasses.replace(configs.get_reduced(arch), group_size=group)
    whole = T.quantize_params(
        T.init_params(torch.Generator().manual_seed(3), cfg), cfg,
        min_size=0)
    for r in range(dm[1]):
        mesh = fake(dm, model=r)
        want = shd.shard_params(whole, mesh, cfg)
        got = T.quantize_params(T.init_params(
            torch.Generator().manual_seed(3), cfg,
            cut=shd.Layout(cfg, mesh).cut), cfg, min_size=0)
        assert shd.is_local(got) and shd.is_local(want)
        for (pa, a), (pb, b) in zip(_walk(got), _walk(want)):
            assert pa == pb and a.get("tp") == b.get("tp")
            key = "table" if "table" in a else "kernel"
            for x, y in zip(_arrays(a[key]), _arrays(b[key])):
                assert torch.equal(x, y)


def test_plans_are_keyed_on_shard_local_shapes():
    """REDUCED danube at (1,4) with groups of 32: wq plans at N/4 and wo at
    K/4 (whole groups); with groups of 128 wo (K = 128, one group) stays
    whole and w_down (two groups) too — the ``row_groups`` departure.
    ``plan_for_params(mesh=)`` on the whole tree plans the keys a rank's
    own tree plans."""
    for group, want in ((32, {"128x32", "32x128", "128x64", "64x128"}),
                        (128, {"128x32", "128x128", "128x64", "256x128"})):
        cfg, whole = _converted("h2o-danube-1.8b", group)
        mesh = fake((1, 4), model=2)
        planning.PLAN_CACHE.clear()
        keys = set(planning.plan_for_params(whole, M=2, mesh=mesh, cfg=cfg))
        local = shd.shard_params(whole, mesh, cfg)
        assert set(planning.plan_for_params(local, M=2)) == keys == want
        # wq N/4 = 32 and w_up N/4 = 64 at every group size
        assert {"128x32", "128x64"} <= keys


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,what", [
    ("rwkv6-7b", "wkv"), ("hymba-1.5b", "ssm"), ("whisper-small", "enc_kv")])
def test_carry_and_encdec_families_refuse_a_mesh(arch, what):
    """The carry and encdec families once refused a mesh for want of
    their sharded per-slot state (``what``); they no longer do: the engine
    builds on a spec-level (2, 2) mesh, its state holding the rank's one
    slot of two and its half of the heads or SSM channels."""
    cfg = configs.get_reduced(arch)
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    eng = ServingEngine(cfg, params, mesh=fake((2, 2), model=1, data=1),
                        device="cpu", max_batch=2)
    state = eng._init_state()
    leaf = state["enc_kv"][0] if what == "enc_kv" else state["cache"][what]
    assert leaf.shape[1] == 1
    want = {"wkv": cfg.num_heads, "ssm": cfg.d_inner,
            "enc_kv": cfg.num_kv_heads}[what] // 2
    assert leaf.shape[3 if what == "enc_kv" else 2] == want


def test_mesh_size_must_equal_the_world():
    with pytest.raises(ValueError, match="needs 4 ranks but 1 is running"):
        tmesh.parse_mesh("2x2")
    with pytest.raises(ValueError, match="DATAxMODEL"):
        tmesh.parse_mesh("4")
    with pytest.raises(RuntimeError, match="initialized process group"):
        tmesh.make_local_mesh(1, 1)


def test_rank_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.rank_device()
    assert tmesh.rank_device("cpu") == torch.device("cpu")
    assert tmesh.choose_backend(torch.device("cpu"), 4) == "gloo"


def test_moe_dp_dispatch_matches_jax_per_shard():
    """The MoE's data-parallel dispatch (``moe_ffn(shards=n)``) against
    JAX's ``_dispatch_ffn`` run on each shard's tokens, split with numpy:
    per-shard capacity (tokens drop per shard), fp32 at 1e-5."""
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    from repro_torch.models import moe

    jcfg = jconfigs.get_reduced("olmoe-1b-7b")
    jp = JT.init_params(jax.random.PRNGKey(1), jcfg)
    lp = jax.tree.map(lambda t: t[0], jp["layers"]["moe"])
    tp = from_jax_params(jax_to_numpy(lp), dtype=torch.float32)
    E, k = jcfg.num_experts, jcfg.experts_per_token
    x = np.random.default_rng(0).standard_normal(
        (12, jcfg.d_model)).astype(np.float32)
    for shards in (1, 2, 3):
        want = np.concatenate([np.asarray(jmoe._dispatch_ffn(
            lp, jnp.asarray(xs), num_experts=E, top_k=k,
            capacity_factor=0.5, cfg=None)[0])
            for xs in np.split(x, shards)])
        got, _ = moe.moe_ffn(tp, torch.from_numpy(x), num_experts=E,
                             top_k=k, capacity_factor=0.5, shards=shards)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
