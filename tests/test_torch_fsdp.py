"""Weight-gathered layers (``runtime/sharding.py``: ``serve_shares``,
``Layout.gather_shares``, ``TrainShards.gather_layer``) against the JAX
package's ``param_shardings(fsdp=True)``, on spec-level meshes and on the
meta device: no ranks. The gloo-rank cases (``fsdp_serve`` tokens and
logits, ZeRO-3 train steps against JAX's) ride the spawns of
``tests/test_torch_mesh.py`` and ``tests/test_torch_train_mesh.py``.

- Every arch's REDUCED quantized serving tree at a (2, 2) mesh: each
  part's share (a QuantizedTensor's packed payload, scales and zeros; a
  dense kernel or the embedding's table) is cut over "data" on the dim
  JAX's spec names "data", and its shape is JAX's shard shape on every dim
  but the model dim (the port's TP departures are held in
  ``test_torch_sharding*.py``); the data ranks' shares put back together
  are the rank's TP slice bit for bit.
- The ZeRO-3 train step of a REDUCED rank on a fake world of 4 (2x2), on
  the meta device with remat: its peak is below the ZeRO-2 step's (the
  whole slice gathered) by at least L - 2 layers' TP bytes; it
  all-gathers each cut leaf of a layer twice a microbatch (the forward and
  the recompute) and the leaves outside the layers once, and
  reduce-scatters each once.
"""
import dataclasses
import math

import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.runtime import sharding as jshd

from repro_torch import configs
from repro_torch.core.quant import QuantizedTensor
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as T
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import steps as tsteps

# one torch thread a test process (see its docstring)
import torch_parity_helpers  # noqa: F401

DM = (2, 2)
PARTS = ("packed", "scales", "zeros")


class SpecMesh:
    def __init__(self, dm, data=0, model=0):
        self.shape = {"data": dm[0], "model": dm[1]}
        self.axis_names = ("data", "model")
        self.coords = {"data": data, "model": model}


def jax_quantized_specs(arch):
    """JAX's ``param_shardings(fsdp=True)`` of the REDUCED quantized
    abstract tree at (2, 2): {key path: (spec, whole shape)}."""
    cfg = jconfigs.get_reduced(arch)
    abstract = jax.eval_shape(lambda p: JT.quantize_params(p, cfg,
                                                           min_size=0),
                              JT.abstract_params(cfg))
    real = jshd.NamedSharding
    try:
        jshd.NamedSharding = lambda m, spec: spec
        specs = jshd.param_shardings(abstract, SpecMesh(DM), fsdp=True)
    finally:
        jshd.NamedSharding = real

    def key(path):
        # a QuantizedTensor's children flatten as 0, 1, 2
        names = [str(getattr(k, "key", getattr(k, "name", getattr(
            k, "idx", k)))) for k in path]
        if len(names) > 1 and names[-2] == "kernel" and names[-1].isdigit():
            names[-1] = PARTS[int(names[-1])]
        return tuple(names)
    shapes = {key(p): tuple(x.shape)
              for p, x in jax.tree_util.tree_flatten_with_path(abstract)[0]}
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {key(p): (s, shapes[key(p)]) for p, s in flat[0]}


def axis_dim(spec, ndim, axis):
    entries = list(spec) + [None] * (ndim - len(spec))
    for i, e in enumerate(entries):
        if e == axis or (isinstance(e, tuple) and axis in e):
            return i - ndim
    return None


def parts_of(tree, path=()):
    """(key path, tensor, the dict's "data" mark entry or None) of every
    tensor part of a serving tree, QuantizedTensor parts by name."""
    if isinstance(tree, dict):
        mark = tree.get("data")
        dims = None if mark is None else mark.split(",")
        for k, v in tree.items():
            if isinstance(v, QuantizedTensor):
                for i, name in enumerate(PARTS):
                    t = getattr(v, name)
                    if t is not None:
                        yield (path + (k, name), t,
                               None if dims is None else dims[i])
            elif isinstance(v, torch.Tensor):
                yield (path + (k,), v,
                       dims[0] if dims and k in ("kernel", "table") else None)
            elif isinstance(v, dict):
                yield from parts_of(v, path + (k,))


@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_serve_shares_are_jax_param_shardings(arch):
    """Rank (d, 0) of a (2, 2) mesh for d = 0, 1: every part cut over
    "data" exactly where JAX's spec names "data", on that dim; its shape
    JAX's shard shape but on the model dim, where it is the rank's TP
    slice's (a bias or bare tensor cut with its leaf's columns: its TP
    slice's); the two
    data ranks' parts concatenated on the marked dim are the TP slice bit
    for bit. Norms and biases are never cut over "data"."""
    cfg = configs.get_reduced(arch)
    want = jax_quantized_specs(arch)
    whole = T.quantize_params(
        T.init_params(torch.Generator().manual_seed(0), cfg), cfg,
        min_size=0)
    tp_slice = dict((p, t) for p, t, _ in parts_of(
        shd.shard_params(whole, SpecMesh(DM), cfg)))
    shares = []
    for d in range(DM[0]):
        lay = shd.Layout(cfg, SpecMesh(DM, d, 0))
        shares.append(list(parts_of(shd.serve_shares(
            shd.shard_params(whole, SpecMesh(DM, d, 0), cfg), lay))))
    assert {p for p, _, _ in shares[0]} == set(want) == set(tp_slice)
    cut = 0
    for (path, t0, mark), (_, t1, _) in zip(*shares):
        spec, shape = want[path]
        nd = len(shape)
        data = axis_dim(spec, nd, "data")
        assert (None if mark in (None, "") else int(mark)) == data, path
        model = axis_dim(spec, nd, "model")
        piece = list(shape)
        if data is not None:
            piece[data] //= DM[0]
            cut += 1
        if model is not None:
            piece[model] = tp_slice[path].shape[model]
        if model is None and tuple(tp_slice[path].shape) != shape:
            # a bias or bare tensor that follows its leaf's columns (the
            # named departures ``bare_slices``; JAX replicates them):
            # never cut over "data"
            assert path[-1] in ("bias", "w_bias", "A_log", "D"), path
            assert data is None
            piece = list(tp_slice[path].shape)
        assert tuple(t0.shape) == tuple(piece), path
        back = t0 if data is None else torch.cat([t0, t1], dim=data)
        assert torch.equal(back, tp_slice[path]), path
    assert cut, arch


def test_serve_shares_pass_a_whole_data_axis_through():
    """A data axis of one cuts nothing and marks nothing, and gathering
    such a tree hands back its own tensors; ``fsdp_serve`` without a mesh
    is a no-op."""
    cfg = configs.get_reduced("h2o-danube-1.8b")
    whole = T.quantize_params(
        T.init_params(torch.Generator().manual_seed(0), cfg), cfg,
        min_size=0)
    lay = shd.Layout(cfg, SpecMesh((1, 2)))
    tp = shd.shard_params(whole, SpecMesh((1, 2)), cfg)
    same = shd.serve_shares(tp, lay)
    assert all(m is None for _, _, m in parts_of(same))
    back = lay.gather_shares(same)
    assert all(a is b for (_, a, _), (_, b, _)
               in zip(parts_of(back), parts_of(tp)))
    # without a mesh the flag changes nothing, as in JAX
    assert tsteps.serving_cfg(cfg, True) is cfg


def layer_tp_bytes(shards):
    """One layer's TP slice in bytes (the stacked leaves' slices / L)."""
    total, L = 0, shards.layout.cfg.num_layers
    for path, s in shards.leaves.items():
        if path[0] == "layers":
            n = math.prod(s.shape) // (s.tp[1] if s.tp else 1)
            total += n * 4 // L
    return total


def test_zero3_holds_a_layer_at_a_time_on_the_meta_device(monkeypatch):
    """REDUCED danube at 4 layers with remat, fp32, 2 microbatches of 4 x
    16 tokens at 2x2 on a fake world: ZeRO-3's peak sits below ZeRO-2's
    (the whole slice gathered once a step, and its gradients) by more
    than 2 layers' TP bytes; its all-gathers over "data" and its
    reduce-scatters are the reckoned ones (ZeRO-2's: each stacked leaf
    gathered whole once a step)."""
    cfg = dataclasses.replace(configs.get_reduced("h2o-danube-1.8b"),
                              num_layers=4, remat=True)
    L, n = cfg.num_layers, 2
    batch = {k: torch.empty((8, 16), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    gathers = {"data": 0}
    real = shd.Layout._collective

    def counted(self, t, axis, fn, kind, **kw):
        gathers["data"] += kind == "all-gather" and axis == "data"
        return real(self, t, axis, fn, kind, **kw)
    monkeypatch.setattr(shd.Layout, "_collective", counted)
    recs, shards = {}, None
    for name, fields in (("zero3", dict(fsdp=True)),
                         ("zero2", dict(fsdp=True, zero2=True))):
        settings = tsteps.TrainSettings(microbatches=n, **fields)
        step, args, _ = dryrun.train_cell(cfg, batch, settings,
                                          mesh=tmesh.fake_mesh(*DM))
        shards = step.shards
        gathers["data"] = 0
        recs[name] = dict(dryrun.trace(step, args), data=gathers["data"])
        torch.distributed.destroy_process_group()
    layer = layer_tp_bytes(shards)
    peak = {k: r["bytes_per_device"]["peak_total"] for k, r in recs.items()}
    assert peak["zero2"] - peak["zero3"] >= (L - 2) * layer, (peak, layer)
    # each cut leaf of the L layers gathered twice a microbatch (the
    # forward and the remat recompute), each outside them once
    want, scatters = dryrun.zero3_collectives(shards, n)
    cut = sum(s.fsdp is not None for p, s in shards.leaves.items()
              if p[0] == "layers")
    top = sum(s.fsdp is not None for p, s in shards.leaves.items()
              if p[0] != "layers")
    assert (want, scatters) == (n * (2 * L * cut + top), n * (L * cut + top))
    assert recs["zero3"]["data"] == want
    assert recs["zero3"]["collectives"]["reduce-scatter"]["count"] == \
        scatters
    # ZeRO-2 gathers each stacked leaf whole once a step and
    # reduce-scatters it once a microbatch
    stacks = sum(s.fsdp is not None for s in shards.leaves.values())
    assert recs["zero2"]["data"] == stacks
    assert recs["zero2"]["collectives"]["reduce-scatter"]["count"] == \
        n * stacks
