"""Megatron-style tensor parallelism by hand (port of
``repro/runtime/sharding.py``).

The JAX package names each leaf's sharding and lets GSPMD place the
shards and insert the collectives. The port runs SPMD by hand: each rank
holds its slice of the weights (:func:`shard_params`) and of the KV pool,
and the model calls the few collectives it needs through the rank's
:class:`Layout` (``cfg.shard``): the row-parallel all-reduce, the
vocab-sharded embedding's all-reduce, the logits' all-gather over
"model", and the all-gathers over "data" of the step's new K/V rows and of
its tokens.

The name rules are the JAX package's (COL/ROW/REP). What a rank executes
departs from them where a rank running its shard alone cannot take JAX's
layout:

- attention shards by head: Q heads when ``Hq % tp == 0``; KV heads when
  ``Hkv % tp == 0``, or, when ``tp % Hkv == 0``, each KV head is held
  whole by ``tp / Hkv`` ranks (Megatron's rule; JAX splits a head's
  columns). Otherwise the attention block stays whole on every rank.
  ``wo`` follows the Q heads.
- a row-parallel leaf splits K only into whole quant groups and packed
  rows (``(K/g) % tp == 0``; JAX shards the packed rows and replicates the
  scales there) and never for a format that quantizes activations (W4A8's
  per-row scale would then cover a rank's K slice). Otherwise it stays
  whole and its input, sharded by the column-parallel leaves before it, is
  all-gathered over "model". A dense leaf is cut as its quantized form
  would be, so quantizing a shard gives the shard of the quantized leaf.
- the embedding and the head shard the vocab (padded) when the model axis
  divides it; the MLP and the expert stacks shard d_ff when it divides.

Every rank of one data row computes the same activations; data-parallel
ranks each run their rows of a step whose batch divides the data axis
(``batch_spec``) and replicate a step whose batch does not (the one-slot
prefill chunk), so the paged pool stays whole on every data replica.

The recurrent-carry families and encoder-decoder refuse a mesh: their
sharded state (the JAX rules for ``wkv``, ``ssm`` and ``enc_kv``) is not
ported.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch
import torch.distributed as dist

from repro_torch.core.quant import QuantizedTensor
from repro_torch.kernels import planning
from repro_torch.launch.mesh import dp_axes
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.runtime.kvcache import PagedKVCache

# column-parallel: output features sharded over "model"
COL = {"wq", "wk", "wv", "w_gate", "w_up", "tm_r", "tm_k", "tm_v", "tm_g",
       "tm_w", "cm_k", "in_proj", "dt_proj", "lm_head"}
# row-parallel: input features (K) sharded over "model"
ROW = {"wo", "w_down", "tm_o", "cm_v", "out_proj"}
# always replicated (small / routing-sensitive)
REP = {"router", "bc_proj"}

MESH_FAMILIES = ("dense", "moe")
_MISSING = {
    "rwkv": "its recurrent carries (wkv, shift, cm_shift)",
    "hybrid": "its SSM carry (ssm) beside the paged pool",
    "encdec": "its encoder and the per-slot cross K/V (enc_kv)",
}


def check_mesh_family(cfg) -> None:
    """Raise for the families the port does not serve on a mesh."""
    if cfg.family not in MESH_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: serving a {cfg.family!r} arch on a mesh is not "
            f"ported — {_MISSING.get(cfg.family, 'its state')} would need "
            f"sharded decode state (the JAX package's "
            f"decode_state_shardings); serve it on one device")


def leaf_kind_for_path(names) -> str:
    """TP kind ("col" | "row" | "rep") of a leaf by its key path (the JAX
    package's name rules; the innermost listed name decides)."""
    for n in reversed(tuple(names)):
        if n in REP:
            return "rep"
        if n in COL:
            return "col"
        if n in ROW:
            return "row"
    return "rep"


axis_size = planning.mesh_axis_size


def axis_rank(mesh, name: str) -> int:
    """This rank's coordinate along ``name`` (a stand-in's ``coords``
    dict, 0 when it has none)."""
    dims = getattr(mesh, "mesh_dim_names", None)
    if dims is not None:
        return mesh.get_local_rank(name) if name in dims else 0
    return int(getattr(mesh, "coords", {}).get(name, 0))


def batch_spec(B: int, mesh) -> tuple:
    """The DP axes a batch of B shards over, as many as divisibility
    allows (JAX's ``batch_spec``; () = replicated)."""
    chosen, prod = [], 1
    for a in dp_axes(mesh):
        n = axis_size(mesh, a)
        if B % (prod * n) == 0:
            chosen.append(a)
            prod *= n
    return tuple(chosen)


def batch_axis_entry(B: int, mesh):
    """:func:`batch_spec` as one spec entry: None, an axis name, or a
    tuple of several."""
    axes = batch_spec(B, mesh)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _take(t: torch.Tensor, dim: int, parts: int, index: int) -> torch.Tensor:
    """Part ``index`` of ``parts`` along ``dim``, copied so that the whole
    tensor can be freed."""
    n = t.shape[dim] // parts
    return t.narrow(dim, index * n, n).clone()


class Layout:
    """One rank's share of a (data, model) mesh for one config: which
    heads, vocab rows and d_ff columns it holds, how each weight leaf is
    cut (:meth:`cut`), and the collectives over the mesh's groups. The
    engine sets it as ``cfg.shard`` on the config the rank runs
    (:meth:`local_cfg`). ``mesh`` may be a spec-level stand-in (``shape``
    and ``coords`` dicts) for the rules; the collectives need a
    DeviceMesh."""

    def __init__(self, cfg, mesh):
        names = getattr(mesh, "mesh_dim_names", None) \
            or getattr(mesh, "axis_names", None)
        if not names or not set(names) & {"data", "model"}:
            raise ValueError(f"a mesh must have 'data' and/or 'model' dims "
                             f"(launch.mesh.make_local_mesh), got {mesh!r}")
        check_mesh_family(cfg)
        self.cfg, self.mesh = cfg, mesh
        self.tp = max(axis_size(mesh, "model"), 1)
        self.dp = max(axis_size(mesh, "data"), 1)
        self.tp_rank = axis_rank(mesh, "model")
        self.dp_rank = axis_rank(mesh, "data")
        tp, Hq, Hkv = self.tp, cfg.num_heads, cfg.num_kv_heads
        self.attn_sharded = tp > 1 and Hq % tp == 0 and (
            Hkv % tp == 0 or tp % Hkv == 0)
        # KV heads split into kv_parts groups; rank r holds group
        # r·kv_parts/tp (tp/Hkv ranks share one head when tp > Hkv)
        self.kv_parts = min(tp, Hkv) if self.attn_sharded else 1
        self.kv_index = self.tp_rank * self.kv_parts // tp
        self.ffn_sharded = tp > 1 and cfg.d_ff % tp == 0
        self.vocab_sharded = tp > 1 and cfg.padded_vocab % tp == 0
        self.base_format = T.serve_format(cfg)

    # -- the rank's config and rows ------------------------------------------

    def local_cfg(self):
        """The config this rank runs: its own head counts (the attention,
        the paged pool and the attention plans see them) and
        ``shard=self``."""
        cfg = self.cfg
        if not self.attn_sharded:
            return dataclasses.replace(cfg, shard=self)
        return dataclasses.replace(
            cfg, num_heads=cfg.num_heads // self.tp,
            num_kv_heads=cfg.num_kv_heads // self.kv_parts, shard=self)

    def rows(self, B: int) -> Optional[slice]:
        """This rank's rows of a step batch of B when it shards over
        "data" (``batch_spec``), else None (every rank runs every row)."""
        if self.dp == 1 or not batch_spec(B, self.mesh):
            return None
        n = B // self.dp
        return slice(self.dp_rank * n, (self.dp_rank + 1) * n)

    def route_shards(self, T: int, split: bool) -> int:
        """Token shards a MoE layer routes ``T`` local tokens in: one when
        the step's rows are this rank's data shard, else (a replicated
        step) the data axis when it divides T, as the JAX package's DP
        dispatch cuts the global tokens."""
        if split or self.dp == 1 or T % self.dp:
            return 1
        return self.dp

    # -- the weight cut ------------------------------------------------------

    def row_ok(self, kernel) -> bool:
        """Can a row-parallel leaf split K over "model"
        (``planning.splits_k``)? A dense leaf is judged as its quantized
        form would be."""
        if isinstance(kernel, QuantizedTensor):
            fmt, K, group = kernel.format, kernel.K, kernel.group_size
        else:
            K = kernel.shape[-2]
            fmt = layers.pick_format(self.base_format, K)
            if fmt is None:
                return K % self.tp == 0
            group = fmt.group_size
        return planning.splits_k(planning.MatmulProblem(
            M=1, N=1, K=K, group_size=group, format=fmt.name), self.tp)

    def leaf_cut(self, path, p):
        """(mark, dim, parts, index) of the linear or embedding dict ``p``
        at key path ``path``; (``"gather"``,) for a whole row-parallel leaf
        behind a sharded input; None when the rank holds it whole."""
        name, tp, r = path[-1], self.tp, self.tp_rank
        if name == "embed":
            return ("vocab", -2, tp, r) if self.vocab_sharded else None
        kind = leaf_kind_for_path(path)
        # the vocab, the attention's heads, the MLP's or experts' d_ff
        held = self.vocab_sharded if name == "lm_head" else \
            self.attn_sharded if "attn" in path else self.ffn_sharded
        if kind == "rep" or not held:
            return None
        if kind == "col":
            if name in ("wk", "wv"):
                return ("col", -1, self.kv_parts, self.kv_index)
            return ("col", -1, tp, r)
        # wo behind sharded heads, w_down behind sharded d_ff
        return ("row", -2, tp, r) if self.row_ok(p["kernel"]) \
            else ("gather",)

    def cut(self, path, p):
        """This rank's copy of the linear (``kernel``, ``bias``) or
        embedding (``table``) dict ``p`` at ``path``, its ``"tp"`` mark
        set when it is cut or gathers its input. A QuantizedTensor's
        packed payload, scales and zeros are cut along the same dim (a
        per-channel scale row stays whole under a K cut)."""
        plan = self.leaf_cut(path, p)
        if plan is None:
            return p
        out = dict(p, tp=plan[0])
        if plan[0] == "gather":
            return out
        _, dim, parts, index = plan
        if "table" in p:
            out["table"] = _take(p["table"], dim, parts, index)
            return out
        k = p["kernel"]
        if isinstance(k, QuantizedTensor):
            def part(t, follows=True):
                return t if t is None or not follows \
                    else _take(t, dim, parts, index)
            grouped = dim == -1 or k.format.scale_granularity == "group"
            out["kernel"] = QuantizedTensor(
                part(k.packed), part(k.scales, grouped),
                part(k.zeros, grouped), k.group_size, k.out_dtype, k.format)
        else:
            out["kernel"] = _take(k, dim, parts, index)
        if "bias" in p and dim == -1:
            out["bias"] = _take(p["bias"], dim, parts, index)
        return out

    # -- collectives ---------------------------------------------------------

    def _collective(self, t: torch.Tensor, axis: str, fn) -> torch.Tensor:
        """Run ``fn(tensor, group)`` over the mesh's ``axis`` group; a
        CUDA tensor on a gloo group goes through host memory."""
        group = self.mesh.get_group(axis)
        staged = t.is_cuda and dist.get_backend(group) == "gloo"
        h = t.detach().cpu() if staged else t.contiguous()
        out = fn(h, group)
        return out.to(t.device) if staged else out

    def reduce_model(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over "model", in ``t``'s dtype."""
        if self.tp == 1:
            return t

        def fn(h, group):
            dist.all_reduce(h, group=group)
            return h
        return self._collective(t, "model", fn)

    def _gather(self, t: torch.Tensor, axis: str, n: int,
                dim: int) -> torch.Tensor:
        if n == 1:
            return t

        def fn(h, group):
            parts = [torch.empty_like(h) for _ in range(n)]
            dist.all_gather(parts, h, group=group)
            return torch.cat(parts, dim=dim)
        return self._collective(t, axis, fn)

    def gather_model(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Concatenate every "model" rank's ``t`` along ``dim``."""
        return self._gather(t, "model", self.tp, dim)

    def gather_rows(self, t: torch.Tensor, rows: Optional[slice]):
        """Every data rank's rows of ``t`` (dim 0), when the step's rows
        shard over "data" (``rows`` not None); else ``t``."""
        if rows is None:
            return t
        return self._gather(t, "data", self.dp, 0)


def shard_params(params, mesh, cfg):
    """This rank's slice of a whole param tree (stacked or unstacked
    layers; QuantizedTensor-aware), each cut leaf marked (``"tp"``). A
    tree that is already a rank's slice (:func:`is_local`) comes back as
    it is."""
    if is_local(params):
        return params
    layout = Layout(cfg, mesh)

    def visit(tree, path):
        if isinstance(tree, Mapping):
            if "kernel" in tree or "table" in tree:
                return layout.cut(path, tree)
            return {k: visit(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [visit(v, path) for v in tree]
        return tree

    return visit(params, ())


def is_local(params) -> bool:
    """True for a tree :func:`shard_params` (or ``T.init_params(...,
    cut=layout.cut)``) cut: some leaf carries a ``"tp"`` mark (every cut
    leaf does)."""
    if isinstance(params, Mapping):
        return "tp" in params or any(is_local(v) for v in params.values())
    if isinstance(params, list):
        return any(is_local(v) for v in params)
    return False


def pool_spec(shape, layout: Layout) -> tuple:
    """Spec of a paged-pool leaf ((L, nb, ps, Hkv, D), (L, nb, ps, Hkv)
    scales or (L, nb, ps) tags): pages replicated over the DP axes, the
    KV-head dim over "model" when the rank holds its own heads."""
    spec = [None] * len(shape)
    if len(shape) >= 4 and layout.attn_sharded:
        spec[3] = "model"
    return tuple(spec)


def decode_state_shardings(state, cfg, mesh):
    """Specs of a paged decode state ``{"cache": {"kv": PagedKVCache}}``
    (the paged-pool rule of JAX's ``decode_state_shardings``): every pool
    leaf by :func:`pool_spec`. With the KV heads replicated over
    ``tp / Hkv`` ranks the head dim is "model" too (each rank holds one
    head); JAX replicates such a pool whole."""
    layout = Layout(cfg, mesh)
    pool = state["cache"]["kv"]
    return {"cache": {"kv": PagedKVCache(*(
        None if t is None else pool_spec(tuple(t.shape), layout)
        for t in pool))}}
