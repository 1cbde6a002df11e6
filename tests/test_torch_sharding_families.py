"""The cut rules of the recurrent-carry and encoder-decoder families
(``repro_torch/runtime/sharding.py``) against the JAX package's specs, on
spec-level meshes (``shape`` and ``coords``): no ranks, no collectives.

Every linear, embedding and bare tensor of the REDUCED rwkv6-7b,
hymba-1.5b and whisper-small trees at model axes of 2 and 4, and of the
full-width hymba-1.5b at 2 and 5, on every model rank: where the port cuts
a leaf, the dim is the one JAX's ``param_shardings`` names "model", the
parts the model axis (a KV head's ranks under ``kv_heads``) and the index
the rank's; where the port's cut and JAX's spec disagree, the leaf falls
under a named departure. The departures this family adds each have a case
of their own: ``bare_slices`` (rwkv's ``w_bias`` and the SSM's ``A_log``
and ``D`` follow their leaves' columns; JAX replicates them),
``time_mix_whole`` (rwkv heads the model axis does not divide keep the
time mix whole; JAX cuts through a head) and ``enc_kv_heads`` (``enc_kv``
cut by KV head; JAX cuts its frames). The decode state's carry specs are
JAX's but for ``enc_kv``; the FSDP rule of the training shares is JAX's
``param_shardings(fsdp=True)``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.runtime import sharding as jshd

from repro_torch import configs
from repro_torch.core.tree import tree_flatten_with_keys
from repro_torch.models import transformer as T
from repro_torch.runtime import sharding as shd

# one torch thread a test process (see its docstring)
import torch_parity_helpers  # noqa: F401

ARCHS = ("rwkv6-7b", "hymba-1.5b", "whisper-small")
# (arch, full width?, model axis)
GRID = [(a, False, tp) for a in ARCHS for tp in (2, 4)] + \
    [("hymba-1.5b", True, 2), ("hymba-1.5b", True, 5)]
BARE = ("w_bias", "A_log", "D")


class FakeMesh:
    """Spec-level (data, model) mesh stand-in with this rank's
    coordinates."""

    def __init__(self, dm, data=0, model=0):
        self.shape = {"data": dm[0], "model": dm[1]}
        self.axis_names = ("data", "model")
        self.coords = {"data": data, "model": model}


def configs_for(arch, full):
    get = (configs.get_config, jconfigs.get_config) if full else \
        (configs.get_reduced, jconfigs.get_reduced)
    return get[0](arch), get[1](arch)


def _specs(fn):
    real = jshd.NamedSharding
    try:
        jshd.NamedSharding = lambda m, spec: spec
        return fn()
    finally:
        jshd.NamedSharding = real


def jax_param_specs(jcfg, dm, fsdp=False):
    """JAX's ``param_shardings`` as PartitionSpecs keyed by leaf path."""
    abstract = jax.eval_shape(
        lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))
    specs = _specs(lambda: jshd.param_shardings(abstract, FakeMesh(dm),
                                                fsdp=fsdp))
    return {tuple(str(getattr(k, "key", k)) for k in path): spec
            for path, spec in jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}


def axis_dim(spec, ndim, axis):
    """The (negative) dim of ``spec`` that names ``axis``, else None."""
    entries = list(spec) + [None] * (ndim - len(spec))
    for i, e in enumerate(entries):
        if e == axis or (isinstance(e, tuple) and axis in e):
            return i - ndim
    return None


def units(tree, path=()):
    """(path, unit) of every linear or embedding dict and every bare
    tensor outside one: what ``Layout.cut`` takes."""
    if isinstance(tree, dict):
        if "kernel" in tree or "table" in tree:
            yield path, tree
            return
        for k, v in tree.items():
            yield from units(v, path + (k,))
    else:
        yield path, tree


def port_cut(lay, path, unit):
    """(dim, parts, index) of the port's cut of ``unit``; ("gather",) for a
    whole row-parallel leaf behind a gathered input; None when whole."""
    if isinstance(unit, torch.Tensor):
        return lay.bare_cut(path)
    cut = lay.leaf_cut(path, unit)
    return cut if cut is None or cut[0] == "gather" else cut[1:]


def departure(lay, path, cut, jdim):
    """The named departure that explains the port's ``cut`` where JAX
    names dim ``jdim`` "model" (None where they agree); asserts its
    conditions."""
    cfg, tp, name = lay.cfg, lay.tp, path[-1]
    if cut is not None and cut[0] != "gather" and cut[0] == jdim \
            and cut[1] == tp:
        return None
    if cut is None and jdim is None:
        return None
    if name in BARE:
        assert jdim is None and cut is not None
        return "bare_slices"
    if "attn" in path or "cross" in path:
        if not lay.attn_sharded:
            assert cut is None and (cfg.num_heads % tp or (
                cfg.num_kv_heads % tp and tp % cfg.num_kv_heads))
            return "attention_whole"
        if name in ("wk", "wv") and cut[1] < tp:
            assert cut[1] == cfg.num_kv_heads and tp % cfg.num_kv_heads == 0
            return "kv_heads"
    if cfg.family == "rwkv" and name.startswith("tm_") \
            and not lay.tm_sharded:
        assert cut is None and cfg.num_heads % tp and jdim is not None
        return "time_mix_whole"
    assert cut == ("gather",) and jdim == -2, (path, cut, jdim)
    return "row_groups"


# the departures each grid point shows (leaf names)
DEPARTURES = {
    ("rwkv6-7b", False, 2): {"bare_slices": {"w_bias"},
                             "row_groups": {"tm_o"}},
    ("rwkv6-7b", False, 4): {"time_mix_whole": {"tm_r", "tm_k", "tm_v",
                                                "tm_g", "tm_w", "tm_o"},
                             "row_groups": {"cm_v"}},
    ("hymba-1.5b", False, 2): {"bare_slices": {"A_log", "D"},
                               "row_groups": {"wo"}},
    ("hymba-1.5b", False, 4): {"bare_slices": {"A_log", "D"},
                               "kv_heads": {"wk", "wv"},
                               "row_groups": {"wo", "out_proj", "w_down"}},
    ("whisper-small", False, 2): {"row_groups": {"wo"}},
    ("whisper-small", False, 4): {"row_groups": {"wo", "w_down"}},
    ("hymba-1.5b", True, 2): {"bare_slices": {"A_log", "D"},
                              "attention_whole": {"wq", "wk", "wv", "wo"},
                              "row_groups": {"out_proj", "w_down"}},
    ("hymba-1.5b", True, 5): {"bare_slices": {"A_log", "D"}},
}


@pytest.mark.parametrize("arch,full,tp", GRID, ids=[
    f"{a}{'-full' if f else ''}-tp{tp}" for a, f, tp in GRID])
def test_every_leaf_cut_against_jax(arch, full, tp):
    """Every unit of the tree on every model rank: the dim, the parts and
    the index of its cut, against JAX's spec; the departures are exactly
    the named ones (``DEPARTURES``). Every rank's cut of one unit differs
    only in its index."""
    cfg, jcfg = configs_for(arch, full)
    want = jax_param_specs(jcfg, (1, tp))
    meta = T.init_params(torch.Generator(), cfg, device="meta")
    seen = {}
    for r in range(tp):
        lay = shd.Layout(cfg, FakeMesh((1, tp), model=r))
        for path, unit in units(meta):
            if isinstance(unit, dict):
                key = "table" if "table" in unit else "kernel"
                leaf, ref = path + (key,), unit[key]
            else:
                leaf, ref = path, unit
            jdim = axis_dim(want[leaf], ref.dim(), "model")
            cut = port_cut(lay, path, unit)
            if cut is not None and cut[0] != "gather":
                dim, parts, index = cut
                assert index == r * parts // tp, (path, r)
                assert ref.shape[dim] % parts == 0
            name = departure(lay, path, cut, jdim)
            if name is not None:
                seen.setdefault(name, set()).add(path[-1])
    assert seen == DEPARTURES[arch, full, tp]


def test_bare_slices_departure():
    """rwkv's ``w_bias`` and the SSM's ``A_log`` and ``D``: JAX replicates
    them (``P()``) and lets GSPMD slice them for the columns a device
    holds; a port rank holds the slice of its own columns (REDUCED, model
    axis 2, rank 1)."""
    for arch, name, dim, shape in (
            ("rwkv6-7b", ("layers", "w_bias"), -1, (2, 64)),
            ("hymba-1.5b", ("layers", "ssm", "A_log"), -2, (2, 128, 8)),
            ("hymba-1.5b", ("layers", "ssm", "D"), -1, (2, 128))):
        cfg, jcfg = configs_for(arch, False)
        assert tuple(jax_param_specs(jcfg, (1, 2))[name]) == ()
        lay = shd.Layout(cfg, FakeMesh((1, 2), model=1))
        assert lay.bare_cut(name) == (dim, 2, 1)
        whole = T.init_params(torch.Generator().manual_seed(0), cfg)
        local = shd.shard_params(whole, FakeMesh((1, 2), model=1), cfg)
        got, full = local, whole
        for k in name:
            got, full = got[k], full[k]
        assert tuple(got.shape) == shape
        n = full.shape[dim] // 2
        assert torch.equal(got, full.narrow(dim, n, n))


def test_time_mix_whole_departure():
    """REDUCED rwkv (2 heads of 64) at a model axis of 4: JAX cuts the
    time-mix columns by 4 (half a head each); the port keeps the time mix
    whole, its two heads on every rank, and still cuts the channel mix."""
    cfg, jcfg = configs_for("rwkv6-7b", False)
    lay = shd.Layout(cfg, FakeMesh((1, 4), model=3))
    spec = jax_param_specs(jcfg, (1, 4))[("layers", "tm_r", "kernel")]
    assert axis_dim(spec, 3, "model") == -1
    meta = {"kernel": torch.empty((2, 128, 128), device="meta")}
    assert lay.leaf_cut(("layers", "tm_r"), meta) is None
    assert not lay.tm_sharded and lay.local_cfg().num_heads == 2
    assert lay.bare_cut(("layers", "w_bias")) is None
    ck = {"kernel": torch.empty((2, 128, 256), device="meta")}
    assert lay.leaf_cut(("layers", "cm_k"), ck) == ("col", -1, 4, 3)


def _jax_state_specs(jcfg, batch, dm):
    state = jax.eval_shape(lambda: JT.init_paged_state(
        jcfg, batch, 16, page_size=4, num_blocks=5))
    return _specs(lambda: jshd.decode_state_shardings(state, jcfg,
                                                      FakeMesh(dm)))


def _port_state(cfg, batch):
    return T.init_paged_state(cfg, batch, 16, page_size=4, num_blocks=5,
                              device="meta")


def _pad(spec, n):
    return tuple(spec) + (None,) * (n - len(tuple(spec)))


@pytest.mark.parametrize("arch,dm", [
    ("rwkv6-7b", (2, 2)), ("rwkv6-7b", (1, 2)), ("hymba-1.5b", (2, 2)),
    ("hymba-1.5b", (4, 2)), ("whisper-small", (2, 2))])
def test_carry_specs_are_jax(arch, dm):
    """The decode state of 4 slots: rwkv's ``wkv`` by head and the SSM's
    ``ssm`` by channel over "model", the token shifts whole, every per-slot
    leaf's batch over "data" where the 4 slots divide it, as in JAX's
    ``decode_state_shardings``; ``enc_kv`` by KV head, where JAX cuts its
    frames (``enc_kv_heads``)."""
    cfg, jcfg = configs_for(arch, False)
    got = shd.decode_state_shardings(_port_state(cfg, 4), cfg, FakeMesh(dm))
    want = _jax_state_specs(jcfg, 4, dm)
    for name, spec in got["cache"].items():
        if name == "kv":
            continue
        assert spec == _pad(want["cache"][name], len(spec)), name
        assert spec[1] == ("data" if 4 % dm[0] == 0 else None)
    if cfg.family == "encdec":
        for g, w in zip(got["enc_kv"], want["enc_kv"]):
            assert g == (None, "data", None, "model", None)
            assert _pad(w, 5) == (None, "data", "model", None, None)


def test_enc_kv_heads_departure():
    """whisper-small's ``enc_kv`` (L, B, 1500 frames, 12 KV heads, 64) at
    (2, 2): JAX cuts the frames over "model" (GSPMD gathers them for each
    cross-attention); a port rank holds its 6 KV heads for every frame,
    the heads its cross-attention reads. With the attention whole (a model
    axis of 8 does not divide 12 heads) neither dim is cut over "model"
    (a data axis of one rank still names the batch, as JAX's rule does)."""
    cfg, jcfg = configs_for("whisper-small", True)
    got = shd.decode_state_shardings(_port_state(cfg, 4), cfg,
                                     FakeMesh((2, 2)))
    want = _jax_state_specs(jcfg, 4, (2, 2))
    assert got["enc_kv"][0] == (None, "data", None, "model", None)
    assert _pad(want["enc_kv"][0], 5) == (None, "data", "model", None, None)
    lay = shd.Layout(cfg, FakeMesh((2, 2)))
    assert lay.local_cfg().num_kv_heads == 6
    whole = shd.decode_state_shardings(_port_state(cfg, 4), cfg,
                                       FakeMesh((1, 8)))
    assert whole["enc_kv"][0] == (None, "data", None, None, None)


@pytest.mark.parametrize("dm", [(2, 2), (1, 4), (4, 1)],
                         ids=["2x2", "1x4", "4x1"])
@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_cut_is_jax_param_shardings(arch, dm):
    """The training shares of the full config: the dim FSDP cuts over
    "data" is the one JAX's ``param_shardings(fsdp=True)`` names "data"
    (never a bare tensor's); a leaf the port cuts over the whole model
    axis is cut on the dim JAX names "model", but for the bare slices and
    biases, which JAX replicates."""
    cfg, jcfg = configs_for(arch, True)
    want = jax_param_specs(jcfg, dm, fsdp=True)
    shards = shd.TrainShards(cfg, FakeMesh(dm), fsdp=True)
    assert set(shards.leaves) == set(want)
    for path, s in shards.leaves.items():
        spec, nd = want[path], len(s.shape)
        assert s.fsdp == (axis_dim(spec, nd, "data") if dm[0] > 1
                          else None), path
        if path[-1] in BARE:
            assert s.fsdp is None
            assert (s.tp is None) == (dm[1] == 1 or (
                path[-1] == "w_bias" and cfg.num_heads % dm[1] != 0))
        elif s.tp is not None and s.tp[1] == dm[1] and path[-1] != "bias":
            assert s.tp[0] == axis_dim(spec, nd, "model"), path


@pytest.mark.parametrize("dm", [(2, 2), (1, 4), (1, 2)],
                         ids=["2x2", "1x4", "1x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_shares_reassemble(arch, dm):
    """Every rank's shares of a random whole REDUCED tree (FSDP on),
    put back together by each leaf's cut, give the tree bit for bit; the
    clip norm's per-rank parts sum to the whole tree's sum of squares."""
    cfg = configs.get_reduced(arch)
    whole = T.init_params(torch.Generator().manual_seed(1), cfg)
    flat = dict(tree_flatten_with_keys(whole))
    grid = {(d, r): shd.TrainShards(cfg, FakeMesh(dm, d, r), fsdp=True)
            for d in range(dm[0]) for r in range(dm[1])}
    shares = {c: dict(tree_flatten_with_keys(s.cut(whole)))
              for c, s in grid.items()}
    for path, s in grid[0, 0].leaves.items():
        def slice_of(r):
            parts = [shares[d, r][path] for d in range(dm[0])]
            if s.fsdp is None:
                return parts[0]
            return torch.cat(parts, dim=s.fsdp)
        if s.tp is None:
            got = slice_of(0)
        else:
            dim, parts, _ = s.tp
            got = torch.cat([slice_of(r) for r in
                             range(0, dm[1], dm[1] // parts)], dim=dim)
        assert torch.equal(got, flat[path]), path
    total = 0.0
    for s in grid.values():
        s.layout.reduce_world = lambda t: t
        total += float(s.global_norm(s.cut(whole))) ** 2
    want = sum(float(torch.sum(t.double() ** 2)) for t in flat.values())
    np.testing.assert_allclose(total, want, rtol=1e-5)


def test_draw_time_cut_equals_cut_of_the_whole_tree():
    """``init_params(cut=layout.cut)`` (the bare tensors cut as drawn too)
    equals ``shard_params`` of the whole tree, quantized, on every rank of
    REDUCED hymba and rwkv at a model axis of 2 and whisper at 4."""
    for arch, tp in (("hymba-1.5b", 2), ("rwkv6-7b", 2),
                     ("whisper-small", 4)):
        cfg = configs.get_reduced(arch)
        whole = T.quantize_params(
            T.init_params(torch.Generator().manual_seed(3), cfg), cfg,
            min_size=0)
        for r in range(tp):
            mesh = FakeMesh((1, tp), model=r)
            want = dict(tree_flatten_with_keys(
                shd.shard_params(whole, mesh, cfg)))
            got = dict(tree_flatten_with_keys(T.quantize_params(
                T.init_params(torch.Generator().manual_seed(3), cfg,
                              cut=shd.Layout(cfg, mesh).cut), cfg,
                min_size=0)))
            assert got.keys() == want.keys()
            for k, w in want.items():
                g = got[k]
                if isinstance(w, str):
                    assert g == w, k
                elif hasattr(w, "packed"):
                    assert torch.equal(g.packed, w.packed), k
                    assert torch.equal(g.scales, w.scales), k
                else:
                    assert torch.equal(g, w), k


def test_local_config_widths():
    """A rank's config: full-width hymba at (1,5) runs 5 query heads over
    1 KV head and 640 of the 3200 SSM channels, d_model 1600 and head_dim
    64 unchanged; at (1,2) the attention whole (25/5) and 1600 channels;
    rwkv6-7b at (1,4) 16 of 64 time-mix heads of 64."""
    cfg = configs.get_config("hymba-1.5b")
    c5 = shd.Layout(cfg, FakeMesh((1, 5))).local_cfg()
    assert (c5.num_heads, c5.num_kv_heads, c5.d_inner, c5.d_model,
            c5.head_dim) == (5, 1, 640, 1600, 64)
    c2 = shd.Layout(cfg, FakeMesh((1, 2))).local_cfg()
    assert (c2.num_heads, c2.num_kv_heads, c2.d_inner) == (25, 5, 1600)
    r4 = shd.Layout(configs.get_config("rwkv6-7b"),
                    FakeMesh((1, 4))).local_cfg()
    assert (r4.num_heads, r4.head_dim, r4.d_model) == (16, 64, 4096)
    assert dataclasses.replace(cfg, ssm_inner=None).d_inner == 3200
