"""The port's training state on a mesh (``runtime/sharding.py``
``fsdp_dim`` and ``TrainShards``), the training presets and
``TrainSettings`` against the JAX package's, on spec-level meshes: no
ranks and no collectives (``test_torch_train_mesh.py`` runs the ranks).

The FSDP rule is JAX's ``param_shardings(fsdp=True)``: a leaf's "data"
dim in JAX's spec is the dim the port cuts a rank's TP slice along.
Cutting every rank's shares and reassembling them gives the whole tree
back, and the clip's global norm counts every distinct element once over
the ranks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import presets as jpresets
from repro.models import transformer as JT
from repro.runtime import sharding as jshd
from repro.runtime import steps as jsteps

from repro_torch import configs
from repro_torch.core.tree import tree_flatten_with_keys
from repro_torch.launch import presets
from repro_torch.models import transformer as T
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import steps as tsteps

# one torch thread a test process (see its docstring)
import torch_parity_helpers  # noqa: F401

TRAIN_ARCHS = ("h2o-danube-1.8b", "internvl2-1b", "olmoe-1b-7b",
               "mixtral-8x7b", "starcoder2-7b", "granite-20b", "llama3-405b")
MESHES = [(2, 2), (4, 1), (1, 4), (2, 4), (8, 2)]


class FakeMesh:
    """Spec-level mesh stand-in with this rank's coordinates."""

    def __init__(self, dm, data=0, model=0):
        self.shape = {"data": dm[0], "model": dm[1]}
        self.axis_names = ("data", "model")
        self.coords = {"data": data, "model": model}


def jax_specs(arch, dm):
    """JAX's ``param_shardings(fsdp=True)`` of the full config, as
    PartitionSpecs keyed by leaf path."""
    cfg = jconfigs.get_config(arch)
    abstract = jax.eval_shape(
        lambda: JT.init_params(jax.random.PRNGKey(0), cfg))
    real = jshd.NamedSharding
    try:
        jshd.NamedSharding = lambda m, spec: spec
        specs = jshd.param_shardings(abstract, FakeMesh(dm), fsdp=True)
    finally:
        jshd.NamedSharding = real
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


@pytest.mark.parametrize("dm", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_fsdp_cut_is_jax_param_shardings(arch, dm):
    """Every leaf of the full config: the dim the port cuts over "data" is
    the one JAX's ``param_shardings(fsdp=True)`` names "data" (None where
    the data axis does not divide it: norms, biases and scalars never);
    where the port cuts a matrix over the whole model axis, JAX names
    "model" on the same dim (a column-cut leaf's bias, which JAX
    replicates, the port cuts with its columns, as serving does)."""
    want = jax_specs(arch, dm)
    shards = shd.TrainShards(configs.get_config(arch), FakeMesh(dm),
                             fsdp=True)
    assert set(shards.leaves) == set(want)
    cut = 0
    for path, s in shards.leaves.items():
        spec, nd = want[path], len(s.shape)
        # a data axis of one rank cuts nothing
        assert s.fsdp == (axis_dim(spec, nd, "data") if dm[0] > 1
                          else None), path
        if s.tp is not None and s.tp[1] == dm[1] and path[-1] != "bias":
            assert s.tp[0] == axis_dim(spec, nd, "model"), path
            cut += 1
    assert cut or dm[1] == 1


def reassemble(arch, dm, fsdp):
    """Every rank's shares of a random whole tree of the REDUCED config,
    put back together by each leaf's cut: FSDP shares concatenated over
    "data", then one of each group of model ranks holding a part
    concatenated over "model"."""
    cfg = configs.get_reduced(arch)
    gen = torch.Generator()
    gen.manual_seed(1)
    whole = T.init_params(gen, cfg)
    grid = {(d, r): shd.TrainShards(cfg, FakeMesh(dm, d, r), fsdp=fsdp)
            for d in range(dm[0]) for r in range(dm[1])}
    shares = {c: dict(tree_flatten_with_keys(s.cut(whole)))
              for c, s in grid.items()}
    leaves = grid[0, 0].leaves
    out = {}
    for path, s in leaves.items():
        def slice_of(r):
            parts = [shares[d, r][path] for d in range(dm[0])]
            if s.fsdp is None:
                assert all(torch.equal(p, parts[0]) for p in parts)
                return parts[0]
            return torch.cat(parts, dim=s.fsdp)
        if s.tp is None:
            out[path] = slice_of(0)
            continue
        dim, parts, _ = s.tp
        out[path] = torch.cat([slice_of(r) for r in
                               range(0, dm[1], dm[1] // parts)], dim=dim)
    return whole, out


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "tp-only"])
@pytest.mark.parametrize("dm", [(2, 2), (4, 1), (1, 4), (2, 4)],
                         ids=["2x2", "4x1", "1x4", "2x4"])
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "olmoe-1b-7b",
                                  "llama3-405b"])
def test_cut_then_gather_is_the_identity(arch, dm, fsdp):
    """Cutting every rank's shares of a whole tree and reassembling them
    (what ``TrainShards.whole`` gathers) gives the tree bit for bit."""
    whole, got = reassemble(arch, dm, fsdp)
    want = dict(tree_flatten_with_keys(whole))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert torch.equal(got[path], w), path


@pytest.mark.parametrize("dm", [(2, 2), (1, 4), (4, 1), (2, 1)],
                         ids=["2x2", "1x4", "4x1", "2x1"])
@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "tp-only"])
def test_global_norm_counts_each_element_once(dm, fsdp):
    """Each rank's part of the clip's norm (its world sum left out), summed
    over the ranks, is the whole tree's sum of squares: a share counted by
    each data rank, a TP part by one of the ranks holding it (REDUCED
    danube at (1,4): each KV head by one of its two ranks), a replicated
    leaf once."""
    cfg = configs.get_reduced("h2o-danube-1.8b")
    gen = torch.Generator()
    gen.manual_seed(2)
    whole = T.init_params(gen, cfg)
    want = sum(float(torch.sum(t.double() ** 2))
               for _, t in tree_flatten_with_keys(whole))
    total = 0.0
    for d in range(dm[0]):
        for r in range(dm[1]):
            s = shd.TrainShards(cfg, FakeMesh(dm, d, r), fsdp=fsdp)
            s.layout.reduce_world = lambda t: t
            total += float(s.global_norm(s.cut(whole))) ** 2
    np.testing.assert_allclose(total, want, rtol=1e-5)


def test_a_quantized_tree_is_refused():
    cfg = configs.get_reduced("h2o-danube-1.8b")
    whole = T.quantize_params(T.init_params(torch.Generator(), cfg), cfg,
                              min_size=0)
    shards = shd.TrainShards(cfg, FakeMesh((2, 2)), fsdp=True)
    with pytest.raises(TypeError, match="never trains"):
        shards.cut(whole)


def _fields(settings):
    return {f.name: (getattr(settings, f.name).__name__
                     if f.name.endswith("dtype") and hasattr(
                         getattr(settings, f.name), "__name__")
                     else str(getattr(settings, f.name)).split(".")[-1]
                     if f.name.endswith("dtype")
                     else getattr(settings, f.name))
            for f in dataclasses.fields(settings)}


def test_train_settings_are_jax_field_for_field():
    """The same fields in the same order with the same defaults (dtypes by
    name)."""
    assert [f.name for f in dataclasses.fields(tsteps.TrainSettings)] == \
        [f.name for f in dataclasses.fields(jsteps.TrainSettings)]
    assert _fields(tsteps.TrainSettings()) == \
        _fields(jsteps.TrainSettings())


def test_presets_are_jax_field_for_field():
    """``PRESETS`` and ``settings_for`` equal JAX's for every arch (and the
    default for one without a preset); llama3-405b keeps bf16 moments."""
    assert set(presets.PRESETS) == set(jpresets.PRESETS)
    for arch in list(jconfigs.ARCHS) + ["no-such-arch"]:
        assert _fields(presets.settings_for(arch)) == \
            _fields(jpresets.settings_for(arch)), arch
    assert presets.settings_for("llama3-405b").opt_dtype == torch.bfloat16
    assert jpresets.settings_for("llama3-405b").opt_dtype == jnp.bfloat16
