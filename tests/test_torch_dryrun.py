"""The dry run on the meta device (``repro_torch.launch.dryrun``) and what
it reads, against the JAX package on the CPU.

- Configs: ``ARCHS``, ``SHAPES``, ``skip_reason``, ``cache_len_for`` and the
  paper's GEMM grid equal JAX's; ``input_specs`` gives JAX's
  ``ShapeDtypeStruct`` leaves as meta tensors, decode state included.
- ``T.abstract_params`` and its quantized form equal JAX's
  ``abstract_params`` / ``eval_shape(quantize_params)`` leaf for leaf for
  the ten full configs, every leaf on ``meta``.
- Meshes: ``degraded_mesh`` takes 16x16 to 15x16 (240 ranks); two pods are
  512 ranks on one (32, 16) mesh (``pod_as_data``).
- A rank's cut at 16x16 on the fake world equals the spec-level cut at the
  same coordinates (``shard_params``, ``TrainShards``), and JAX's shard
  shapes (``param_shardings(fsdp=True)``) where the port cuts as JAX does.
- REDUCED cells on small fake worlds: the arguments' bytes equal the real
  shards' on the CPU; a one-device train step's FLOPs equal
  ``FlopCounterMode`` on the same step run on CPU tensors.
- Every (arch x shape) cell of the full configs at 16x16 (the first layer
  of each, full width) is OK or SKIP with JAX's reasons; danube's train_4k
  at 15x16 and global batch 240 (full depth) fits one H100.
- Each kernel wrapper's meta output has its plain version's shape and
  dtype, and launches nothing.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.runtime import sharding as jshd

from repro_torch import configs
from repro_torch.core import quant
from repro_torch.core.quant import QuantizedTensor
from repro_torch.kernels import (flash_attention, gemm, paged_attention,
                                 w4a8_fused, w4a16_decoupled, w4a16_fused,
                                 w8a16_fused)
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import kvcache, sharding
from repro_torch.runtime import steps as tsteps


def dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def jax_leaves(tree):
    """{keystr: (shape, dtype name)} of a JAX pytree (a QuantizedTensor's
    payloads under ``[<flat index i>]``)."""
    return {jax.tree_util.keystr(p): (tuple(x.shape), dtype_name(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_leaves(tree, prefix=""):
    """The same map of a port tree (dicts, lists, NamedTuples and
    QuantizedTensors of tensors), in JAX's key spelling."""
    out = {}
    if isinstance(tree, QuantizedTensor):
        parts = [t for t in (tree.packed, tree.scales, tree.zeros)
                 if t is not None]
        for i, t in enumerate(parts):
            out.update(port_leaves(t, f"{prefix}[<flat index {i}>]"))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(port_leaves(v, f"{prefix}['{k}']"))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            out.update(port_leaves(getattr(tree, k), f"{prefix}.{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(port_leaves(v, f"{prefix}[{i}]"))
    elif isinstance(tree, torch.Tensor):
        assert tree.is_meta, prefix
        out[prefix] = (tuple(tree.shape), dtype_name(tree.dtype))
    return out


# -- configs ------------------------------------------------------------------

def test_archs_shapes_and_paper_grid_equal_jax():
    assert configs.ARCHS == jconfigs.ARCHS
    assert configs.PAPER_GEMM_SHAPES == jconfigs.PAPER_GEMM_SHAPES
    assert configs.PAPER_BATCH_SIZES == jconfigs.PAPER_BATCH_SIZES
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert list(configs.all_configs()) == list(jconfigs.all_configs())


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_skip_reason_and_cache_len_equal_jax(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for name in jconfigs.SHAPES:
        shape, jshape = configs.SHAPES[name], jconfigs.SHAPES[name]
        assert configs.skip_reason(cfg, shape) == \
            jconfigs.skip_reason(jcfg, jshape), name
        assert configs.cache_len_for(cfg, shape) == \
            jconfigs.cache_len_for(jcfg, jshape), name


@pytest.mark.parametrize("shape", list(jconfigs.SHAPES))
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_input_specs_equal_jax(arch, shape):
    got = port_leaves(configs.input_specs(configs.get_config(arch),
                                          configs.SHAPES[shape]))
    want = jax_leaves(jconfigs.input_specs(jconfigs.get_config(arch),
                                           jconfigs.SHAPES[shape]))
    assert got == want


# -- abstract params ----------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_abstract_params_equal_jax(arch):
    """Plain and quantized, leaf for leaf; every leaf on meta (nothing
    allocated: llama3-405b's tree would be 810 GB in bf16)."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    plain = T.abstract_params(cfg)
    jplain = JT.abstract_params(jcfg)
    assert port_leaves(plain) == jax_leaves(jplain)
    got = port_leaves(T.quantize_params(plain, cfg))
    want = jax_leaves(jax.eval_shape(
        lambda p: JT.quantize_params(p, jcfg), jplain))
    assert got == want


def test_meta_quantize_is_the_real_layout():
    """A stacked meta leaf quantizes to the packed, scale and zero shapes
    of quantizing the real stack, format by format."""
    w = torch.randn(3, 256, 128)
    for fmt in ("w4a16_g128", "w8a16_channel", "w4a8_g128"):
        from repro_torch.models import layers
        real = layers.quantize_tree({"kernel": w}, format=fmt, min_size=0)
        abst = layers.quantize_tree(
            {"kernel": torch.empty_like(w, device="meta")}, format=fmt,
            min_size=0)
        for a, b in ((real["kernel"], abst["kernel"]),):
            assert a.format == b.format and a.group_size == b.group_size
            for x, y in ((a.packed, b.packed), (a.scales, b.scales),
                         (a.zeros, b.zeros)):
                assert (x is None) == (y is None)
                if x is not None:
                    assert y.is_meta and x.shape == y.shape \
                        and x.dtype == y.dtype


# -- meshes -------------------------------------------------------------------

def test_production_degraded_and_multi_pod_meshes():
    import torch.distributed as dist
    m = tmesh.make_production_mesh(rank=37)
    assert dist.get_world_size() == 256 and tuple(m.shape) == (16, 16)
    assert (m.get_local_rank("data"), m.get_local_rank("model")) == (2, 5)
    d = tmesh.degraded_mesh(m)
    assert dist.get_world_size() == 240 and tuple(d.shape) == (15, 16)
    assert dist.get_rank() == 37
    dist.destroy_process_group()


def test_pod_as_data_departure():
    """Two pods: JAX's (2, 16, 16) mesh over ("pod", "data", "model")
    with data-parallel axes ("pod", "data"); the port's layouts know
    "data" and "model" only, so its 512 ranks are one (32, 16) mesh whose
    data axis is pod-major (rank 300: pod 1, data row 2, model 12 is data
    row 18)."""
    import torch.distributed as dist
    p = tmesh.make_production_mesh(multi_pod=True, rank=300)
    assert dist.get_world_size() == 512 and tuple(p.shape) == (32, 16)
    assert tmesh.dp_axes(p) == ("data",)
    assert (p.get_local_rank("data"), p.get_local_rank("model")) == (18, 12)
    jaxish = np.arange(512).reshape(2, 16, 16)
    assert np.argwhere(jaxish == 300).tolist() == [[1, 2, 12]]
    assert p.size(0) == 2 * 16
    dist.destroy_process_group()


class SpecMesh:
    """A spec-level (data, model) stand-in with this rank's coordinates."""

    def __init__(self, dm, data=0, model=0):
        self.shape = {"data": dm[0], "model": dm[1]}
        self.axis_names = ("data", "model")
        self.coords = {"data": data, "model": model}


def shapes_of(tree):
    return {k: v[0] for k, v in port_leaves(tree).items()}


def jax_shard_shapes(arch, dm):
    """JAX's ``param_shardings(fsdp=True)`` of the full config as shard
    shapes (every named axis divides its dim), keyed by leaf path."""
    cfg = jconfigs.get_config(arch)
    abstract = JT.abstract_params(cfg)
    real = jshd.NamedSharding
    try:
        jshd.NamedSharding = lambda m, spec: spec
        specs = jshd.param_shardings(abstract, SpecMesh(dm), fsdp=True)
    finally:
        jshd.NamedSharding = real
    sizes = {"data": dm[0], "model": dm[1]}
    flat_specs = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    shapes = dict(jax.tree_util.tree_flatten_with_path(abstract)[0])
    out = {}
    for path, spec in flat_specs:
        shape = list(shapes[path].shape)
        for i, e in enumerate(spec):
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None:
                    shape[i] //= sizes[a]
        out[tuple(str(getattr(k, "key", k)) for k in path)] = tuple(shape)
    return out


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "llama3-405b",
                                  "hymba-1.5b", "whisper-small"])
def test_rank_cut_on_the_fake_world(arch):
    """At 16x16, ranks (0,0), (1,7) and (15,15): the serving slice of the
    quantized tree and the training shares from the fake world's
    DeviceMesh equal the spec-level cut at the same coordinates; the
    training shares equal JAX's shard shapes wherever the port cuts a leaf
    over the whole model axis or not at all and JAX does the same (the
    named departures cut otherwise)."""
    cfg = configs.get_config(arch)
    quantized = T.quantize_params(T.abstract_params(cfg), cfg)
    jax_shapes = jax_shard_shapes(arch, (16, 16))
    for d, m in ((0, 0), (1, 7), (15, 15)):
        mesh = tmesh.make_production_mesh(rank=16 * d + m)
        spec = SpecMesh((16, 16), d, m)
        assert shapes_of(sharding.shard_params(quantized, mesh, cfg)) == \
            shapes_of(sharding.shard_params(quantized, spec, cfg))
        shards = sharding.TrainShards(cfg, mesh, fsdp=True)
        got = shards.cut(T.abstract_params(cfg))
        assert shapes_of(got) == shapes_of(sharding.TrainShards(
            cfg, spec, fsdp=True).cut(T.abstract_params(cfg)))
        held = 0
        for path, s in shards.leaves.items():
            leaf = got
            for k in path:
                leaf = leaf[k]
            if tuple(leaf.shape) == jax_shapes[path]:
                held += 1
                continue
            # a named departure: the leaf whole over "model" where JAX
            # cuts it, a KV head held by several ranks, a bias cut with
            # its columns
            assert path[-1] == "bias" or s.tp is None or s.tp[1] < 16, path
        assert held, arch
    torch.distributed.destroy_process_group()


# -- the dry run on REDUCED configs -------------------------------------------

def reduced_batch(cfg, B, S, device="meta", seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                   dtype=torch.int32),
           "labels": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                   dtype=torch.int32)}
    if cfg.vision_prefix:
        out["vision_embeds"] = torch.randn(B, cfg.vision_prefix, cfg.d_model,
                                           generator=g, dtype=cfg.dtype)
    if cfg.family == "encdec":
        out["audio_embeds"] = torch.randn(B, cfg.encoder_seq, cfg.d_model,
                                          generator=g, dtype=cfg.dtype)
    return {k: v.to(device) for k, v in out.items()}


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in dryrun._tensors(tree))


@pytest.mark.parametrize("arch,dm", [("h2o-danube-1.8b", (2, 2)),
                                     ("h2o-danube-1.8b", (1, 4)),
                                     ("whisper-small", (2, 1)),
                                     ("olmoe-1b-7b", (1, 2))])
def test_arguments_are_the_real_shards_bytes(arch, dm):
    """A REDUCED train cell on a small fake world: its argument bytes equal
    the real CPU shares', fresh AdamW state and batch; a decode cell's
    equal the real quantized slice's, paged state and inputs."""
    cfg = configs.get_reduced(arch)
    settings = tsteps.TrainSettings(microbatches=2, fsdp=True, zero2=True)
    batch = reduced_batch(cfg, 8, 16)
    mesh = tmesh.fake_mesh(*dm)
    step, args, _ = dryrun.train_cell(cfg, batch, settings, mesh=mesh)
    rec = dryrun.trace(step, args)
    real = step.shards.cut(T.init_params(torch.Generator().manual_seed(0),
                                         cfg))
    want = nbytes(real) + nbytes(adamw_init(real, AdamWConfig())) \
        + nbytes(reduced_batch(cfg, 8, 16, "cpu"))
    assert rec["bytes_per_device"]["argument"] == want
    assert rec["bytes_per_device"]["peak_total"] > want
    assert rec["collectives"]["total"] > 0
    step, args, _ = dryrun.decode_cell(cfg, 4, 16, page_size=4, mesh=mesh)
    rec = dryrun.trace(step, args)
    whole = T.quantize_params(T.init_params(
        torch.Generator().manual_seed(0), cfg), cfg)
    lay = sharding.Layout(cfg, mesh)
    local = lay.local_cfg()
    rows = lay.rows(4)
    n = 4 if rows is None else rows.stop - rows.start
    state = T.init_paged_state(local, n, 16, page_size=4, num_blocks=17)
    inputs = 2 * 4 * 4 + (4 * 4 * 4 if local.family != "rwkv" else 0) \
        + (4 if local.family in T.CARRY_FAMILIES else 0)
    want = nbytes(sharding.shard_params(whole, mesh, cfg)) + nbytes(state) \
        + inputs
    assert rec["bytes_per_device"]["argument"] == want
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "olmoe-1b-7b"])
def test_train_flops_equal_the_cpu_count(arch):
    """One device, the plain step on chunked attention: the meta trace's
    FLOPs equal ``FlopCounterMode`` over the same step on CPU tensors."""
    cfg = dataclasses.replace(configs.get_reduced(arch), attn_impl="chunked")
    settings = tsteps.TrainSettings(microbatches=2)
    step, args, _ = dryrun.train_cell(cfg, reduced_batch(cfg, 4, 16),
                                      settings, attn_impl="chunked")
    rec = dryrun.trace(step, args)
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    opt_cfg = AdamWConfig(state_dtype=settings.opt_dtype)
    cpu_step = tsteps.make_train_step(cfg, opt_cfg, settings)
    counter = FlopCounterMode(display=False)
    with counter:
        cpu_step(params, adamw_init(params, opt_cfg),
                 {"batch": reduced_batch(cfg, 4, 16, "cpu"), "step": 0})
    assert rec["cost"]["kernel_flops"] == 0
    assert rec["cost"]["flops"] == counter.get_total_flops() > 0


def test_flash_train_counts_the_kernel_operations():
    """On the flash kernel each traced forward launch adds its operations
    (2 x layers x microbatches launches: forward and remat recompute)."""
    from repro_torch.core import costmodel
    cfg = dataclasses.replace(configs.get_reduced("h2o-danube-1.8b"),
                              remat=True)
    settings = tsteps.TrainSettings(microbatches=2)
    step, args, _ = dryrun.train_cell(cfg, reduced_batch(cfg, 4, 16),
                                      settings)
    rec = dryrun.trace(step, args)
    per = costmodel.flash_attn_flops(2, cfg.num_heads, cfg.head_dim,
                                     costmodel.attn_pairs(
                                         16, 16, causal=True,
                                         window=cfg.sliding_window))
    assert rec["cost"]["kernel_flops"] == 2 * cfg.num_layers * 2 * per
    assert flash_attention.FLASH_ATTENTION.launches == 0


# -- the full configs at the production mesh ----------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_every_cell_is_ok_or_skip_with_jax_reasons(arch):
    """Every shape of the full config at 16x16 (its first layer, full
    width): OK with every record's key, or SKIP with JAX's reason."""
    jcfg = jconfigs.get_config(arch)
    for shape in configs.SHAPES:
        rec = dryrun.run_cell(arch, shape, layers=1, verbose=False)
        want = jconfigs.skip_reason(jcfg, jconfigs.SHAPES[shape])
        if want:
            assert rec["status"] == "SKIP" and rec["skip_reason"] == want
            continue
        assert rec["status"] == "OK", rec
        assert rec["mesh"] == "16x16" and rec["kind"] == \
            configs.SHAPES[shape].kind
        b = rec["bytes_per_device"]
        assert b["peak_total"] == b["argument"] + b["output"] + b["temp"]
        assert b["peak_total"] > 0 and rec["cost"]["flops"] > 0
        assert set(rec["collectives"]) == set(
            sharding.COLLECTIVE_KINDS) | {"total"}
        assert isinstance(rec["fits_h100"], bool)
        json.dumps(rec)
    torch.distributed.destroy_process_group()


def test_danube_degraded_mesh_at_batch_240_fits_one_h100():
    """JAX's elastic cell: danube's train_4k at full depth on the 15x16
    survivors at global batch 240 (16 rows a data rank, as at 16x16)."""
    rec = dryrun.run_cell("h2o-danube-1.8b", "train_4k", drop_data=1,
                          global_batch=240, verbose=False)
    assert rec["status"] == "OK", rec
    assert rec["mesh"] == "15x16" and rec["global_batch"] == 240
    assert rec["fits_h100"]
    torch.distributed.destroy_process_group()


def test_cli_writes_records_and_exits_zero(tmp_path):
    out = tmp_path / "cells.json"
    assert dryrun.main(["--arch", "rwkv6-7b", "--shape", "long_500k",
                        "--json", str(out)]) == 0
    rec, = json.loads(out.read_text())
    assert rec["status"] == "OK" and rec["kind"] == "decode"
    torch.distributed.destroy_process_group()


# -- the kernel wrappers on meta ----------------------------------------------

def meta(t):
    return None if t is None else torch.empty_like(t, device="meta")


def qmeta(qt):
    return QuantizedTensor(meta(qt.packed), meta(qt.scales), meta(qt.zeros),
                           qt.group_size, qt.out_dtype, qt.format)


def gemm_cases():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 256, generator=g, dtype=torch.bfloat16)
    w = torch.randn(256, 128, generator=g, dtype=torch.bfloat16)
    xe = torch.randn(3, 8, 256, generator=g, dtype=torch.bfloat16)
    parts = [quant.quantize(torch.randn(256, 128, generator=g))
             for _ in range(3)]
    qe = QuantizedTensor(torch.stack([q.packed for q in parts]),
                         torch.stack([q.scales for q in parts]), None, 128,
                         torch.bfloat16, parts[0].format)
    qt = quant.quantize(w)
    return {
        "w4a16_fused": (w4a16_fused.w4a16_fused, (x, qt), {"split_k": 1}),
        "w4a16_fused_split": (w4a16_fused.w4a16_fused, (x, qt),
                              {"split_k": 4, "out_dtype": torch.float32}),
        "w4a16_experts": (w4a16_fused.w4a16_fused, (xe, qe), {}),
        "gemm": (gemm.gemm, (x, w), {}),
        "w4a16_decoupled": (w4a16_decoupled.w4a16_decoupled, (x, qt),
                            {"split_k": 2}),
        "w8a16_fused": (w8a16_fused.w8a16_fused,
                        (x, quant.quantize(w, "w8a16_channel")), {}),
        "w4a8_fused": (w4a8_fused.w4a8_fused,
                       (x, quant.quantize(w, "w4a8_g128")), {}),
    }


def to_meta(a):
    return qmeta(a) if isinstance(a, QuantizedTensor) else meta(a)


@pytest.mark.parametrize("name", list(gemm_cases()))
def test_gemm_wrappers_on_meta_match_the_plain_shape(name):
    fn, args, kw = gemm_cases()[name]
    want = fn(*args, **kw)
    before = [k.launches for k in dryrun.KERNELS]
    got = fn(*(to_meta(a) for a in args), **kw)
    assert got.is_meta and got.shape == want.shape and \
        got.dtype == want.dtype
    assert [k.launches for k in dryrun.KERNELS] == before


@pytest.mark.parametrize("kind", ["decode", "chunk"])
def test_paged_attention_on_meta_matches_the_plain_shape(kind):
    g = torch.Generator().manual_seed(0)
    fmt = quant.get_kv_format("kv_fp16")
    B, Hq, Hkv, D, ps, pages = 2, 4, 2, 32, 4, 3
    pool = kvcache.init_pool(1 + B * pages, ps, Hkv, D, torch.bfloat16,
                             "kv_fp16")
    tables = torch.arange(1, 1 + B * pages, dtype=torch.int32).reshape(
        B, pages)
    if kind == "decode":
        q = torch.randn(B, Hq, D, generator=g, dtype=torch.bfloat16)
        pos = torch.tensor([5, 7], dtype=torch.int32)
        args = (q, pool, tables, pos)
        fn = paged_attention.fused_paged_attention
    else:
        C = 4
        q = torch.randn(B, C, Hq, D, generator=g, dtype=torch.bfloat16)
        kv = torch.randn(B, C, Hkv, D, generator=g, dtype=torch.bfloat16)
        positions = torch.arange(4, 4 + C, dtype=torch.int32).expand(B, C)
        args = (q, kv, kv, pool, tables, positions)
        fn = paged_attention.fused_chunk_attention
    kw = dict(fmt=fmt, out_dtype=torch.bfloat16, kv_partitions=1)
    want = fn(*args, **kw)

    def to_m(a):
        if isinstance(a, kvcache.PagedKVCache) or (
                isinstance(a, tuple) and hasattr(a, "_fields")):
            return type(a)(*(None if t is None else meta(t) for t in a))
        return meta(a)
    launches = paged_attention.PAGED_ATTENTION.launches
    got = fn(*(to_m(a) for a in args), **kw)
    assert got.is_meta and got.shape == want.shape and \
        got.dtype == want.dtype
    assert paged_attention.PAGED_ATTENTION.launches == launches


def test_flash_forward_on_meta_matches_the_plain_shape():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 32, 4, 32, generator=g, dtype=torch.bfloat16)
    k = torch.randn(2, 32, 2, 32, generator=g, dtype=torch.bfloat16)
    want = flash_attention.flash_attention_forward(q, k, k, window=8)
    traced = flash_attention.FLASH_ATTENTION.traced
    got = flash_attention.flash_attention_forward(meta(q), meta(k), meta(k),
                                                  window=8)
    for a, b in zip(got, want):
        assert a.is_meta and a.shape == b.shape and a.dtype == b.dtype
    assert flash_attention.FLASH_ATTENTION.traced == traced + 1
