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

Training on a mesh (:class:`TrainShards`, the state of
``runtime.steps.make_train_step(..., mesh=)``) keeps each rank's TP slice
of every leaf and, under FSDP, only its share over "data" (JAX's
``param_shardings(fsdp=True)``: :func:`fsdp_dim`). A leaf that requires
grad takes the autograd-aware forms of the model collectives
(:meth:`Layout.copy_to_model`, :meth:`Layout.reduce_over_model`,
:meth:`Layout.gather_over_model`), so every rank's gradients are those of
its slice for its rows; a KV head held by several ranks sums their
partial gradients over its :meth:`Layout.part_group`.

The recurrent-carry and encoder-decoder families cut by the same rules
(:meth:`Layout.leaf_cut`): rwkv's time mix by whole heads (``num_heads %
tp``), the SSM by its ``d_inner`` channels, cross-attention exactly as
attention, the channel mix as the MLP. Their per-slot state
(:func:`carry_spec`) holds the rank's heads of ``wkv`` and ``enc_kv``,
its channels of ``ssm``, and, where the decode step's slots split over
"data", only the rank's slots; the one-slot prefill chunk, replicated,
commits the slot's carry on the rank that holds its row (the others run it
on rows of their own and drop them: ``ServingEngine``).

Departures from JAX's specs that such a rank needs: JAX replicates the
bare tensors that follow a cut leaf's columns (rwkv's ``w_bias``, the
SSM's ``A_log`` and ``D``: ``P()``) and lets GSPMD slice them; here each
rank holds the slice that matches its columns (:meth:`Layout.bare_cut`).
rwkv's time mix stays whole where the model axis does not divide the heads
(JAX cuts the columns through a head). JAX cuts ``enc_kv``'s frame dim
over "model"; here its KV heads.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch
import torch.distributed as dist

from repro_torch.core.quant import QuantizedTensor
from repro_torch.core.tree import tree_flatten_with_keys
from repro_torch.kernels import planning
from repro_torch.launch.mesh import dp_axes
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.models.rwkv import TM_KEYS
from repro_torch.runtime.kvcache import PagedKVCache

# column-parallel: output features sharded over "model"
COL = {"wq", "wk", "wv", "w_gate", "w_up", "tm_r", "tm_k", "tm_v", "tm_g",
       "tm_w", "cm_k", "in_proj", "dt_proj", "lm_head"}
# row-parallel: input features (K) sharded over "model"
ROW = {"wo", "w_down", "tm_o", "cm_v", "out_proj"}
# always replicated (small / routing-sensitive)
REP = {"router", "bc_proj"}

# every collective of a Layout, by kind: its count and its traffic on this
# rank in bytes (ring-algorithm volumes over a group of S ranks, as JAX's
# dry run reads them off the partitioned HLO: an all-reduce 2·R·(S-1)/S,
# an all-gather or gather R·(S-1) of an operand of R bytes, a
# reduce-scatter R·(S-1)/S); the dry run zeroes and reads them
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "gather")
_RING = {"all-reduce": lambda r, s: 2 * r * (s - 1) / s,
         "all-gather": lambda r, s: r * (s - 1),
         "gather": lambda r, s: r * (s - 1),
         "reduce-scatter": lambda r, s: r * (s - 1) / s}
COLLECTIVES = {k: {"bytes": 0.0, "count": 0} for k in COLLECTIVE_KINDS}


def reset_collectives() -> None:
    for rec in COLLECTIVES.values():
        rec.update(bytes=0.0, count=0)


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


def _cuts(n: int, tp: int) -> bool:
    """Can ``n`` output columns be cut over ``tp`` model ranks: evenly,
    each rank's slice a multiple of 16 (the GEMM kernels' column unit)."""
    return tp > 1 and n % tp == 0 and (n // tp) % 16 == 0


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
        self.cfg, self.mesh = cfg, mesh
        self.tp = max(axis_size(mesh, "model"), 1)
        self.dp = max(axis_size(mesh, "data"), 1)
        self.tp_rank = axis_rank(mesh, "model")
        self.dp_rank = axis_rank(mesh, "data")
        tp, Hq, Hkv = self.tp, cfg.num_heads, cfg.num_kv_heads
        self.attn_sharded = tp > 1 and not cfg.attn_free and Hq % tp == 0 \
            and (Hkv % tp == 0 or tp % Hkv == 0)
        # KV heads split into kv_parts groups; rank r holds group
        # r·kv_parts/tp (tp/Hkv ranks share one head when tp > Hkv)
        self.kv_parts = min(tp, Hkv) if self.attn_sharded else 1
        self.kv_index = self.tp_rank * self.kv_parts // tp
        # d_ff and the SSM's d_inner channels are cut when a rank's slice
        # is a multiple of the GEMM kernels' 16 output columns (hymba's
        # d_ff 5504 and d_inner 3200 over 16 ranks would leave 344 and 200)
        self.ffn_sharded = _cuts(cfg.d_ff, tp)
        self.vocab_sharded = tp > 1 and cfg.padded_vocab % tp == 0
        # rwkv's time mix by whole heads
        self.tm_sharded = tp > 1 and cfg.family == "rwkv" \
            and Hq % tp == 0
        self.ssm_sharded = cfg.family == "hybrid" and _cuts(cfg.d_inner, tp)
        self.base_format = T.serve_format(cfg)
        self._part_groups = {}

    # -- the rank's config and rows ------------------------------------------

    def local_cfg(self):
        """The config this rank runs: its own head counts (the attention,
        the paged pool and the attention plans see them; rwkv's time mix
        and ``wkv`` carry), its SSM channels (``ssm_inner``), ``d_model``
        and ``head_dim`` unchanged, and ``shard=self``."""
        cfg = self.cfg
        fields = {"shard": self}
        if self.attn_sharded:
            fields.update(num_heads=cfg.num_heads // self.tp,
                          num_kv_heads=cfg.num_kv_heads // self.kv_parts)
        if self.tm_sharded:
            fields["num_heads"] = cfg.num_heads // self.tp
        if self.ssm_sharded:
            fields["ssm_inner"] = cfg.d_inner // self.tp
        return dataclasses.replace(cfg, **fields)

    def rows(self, B: int) -> Optional[slice]:
        """This rank's rows of a step batch of B when it shards over
        "data" (``batch_spec``), else None (every rank runs every row).
        The per-slot state of ``max_batch`` slots (the recurrent carries,
        ``enc_kv``) holds the same rows of ``rows(max_batch)``."""
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

    def _cut_group(self, path) -> bool:
        """Is the group the leaf at ``path`` belongs to cut over "model":
        the vocab, the attention's heads (self-, encoder and cross
        attention), the SSM's channels, rwkv's time-mix heads, else the
        MLP's, channel mix's or experts' d_ff."""
        name = path[-1]
        if name == "lm_head":
            return self.vocab_sharded
        if "attn" in path or "cross" in path:
            return self.attn_sharded
        if "ssm" in path:
            return self.ssm_sharded
        if name in TM_KEYS:
            return self.tm_sharded
        return self.ffn_sharded

    def leaf_cut(self, path, p):
        """(mark, dim, parts, index) of the linear or embedding dict ``p``
        at key path ``path``; (``"gather"``,) for a whole row-parallel leaf
        behind a sharded input; None when the rank holds it whole."""
        name, tp, r = path[-1], self.tp, self.tp_rank
        if name == "embed":
            return ("vocab", -2, tp, r) if self.vocab_sharded else None
        kind = leaf_kind_for_path(path)
        if kind == "rep" or not self._cut_group(path):
            return None
        if kind == "col":
            if name in ("wk", "wv"):
                return ("col", -1, self.kv_parts, self.kv_index)
            return ("col", -1, tp, r)
        # wo behind sharded heads, w_down behind sharded d_ff
        return ("row", -2, tp, r) if self.row_ok(p["kernel"]) \
            else ("gather",)

    def bare_cut(self, path) -> Optional[tuple]:
        """(dim, parts, index) of a bare tensor (no linear's or
        embedding's dict) at ``path`` that follows a cut group's columns:
        rwkv's ``w_bias`` (d,) with ``tm_w``'s, the SSM's ``A_log``
        (d_inner, n) and ``D`` (d_inner,) with ``in_proj``'s. None for
        every other bare tensor (norms: whole on every rank)."""
        name, tp, r = path[-1], self.tp, self.tp_rank
        if name == "w_bias" and self.tm_sharded:
            return (-1, tp, r)
        if "ssm" in path and self.ssm_sharded and name in ("A_log", "D"):
            return (-2 if name == "A_log" else -1, tp, r)
        return None

    def cut(self, path, p):
        """This rank's copy of the linear (``kernel``, ``bias``) or
        embedding (``table``) dict ``p`` at ``path``, its ``"tp"`` mark
        set when it is cut or gathers its input. A QuantizedTensor's
        packed payload, scales and zeros are cut along the same dim (a
        per-channel scale row stays whole under a K cut). A bare tensor
        ``p`` is cut by :meth:`bare_cut` (unmarked)."""
        if isinstance(p, torch.Tensor):
            plan = self.bare_cut(path)
            return p if plan is None else _take(p, *plan)
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

    def _group(self, axis):
        """A mesh dim's group ("data", "model"), a group itself, or the
        whole world (None)."""
        if axis is None:
            return dist.group.WORLD
        return self.mesh.get_group(axis) if isinstance(axis, str) else axis

    def _collective(self, t: torch.Tensor, axis, fn, kind: str, *,
                    copy: bool = False) -> torch.Tensor:
        """Run ``fn(tensor, group)`` over ``axis`` (:meth:`_group`), counted
        in :data:`COLLECTIVES` under ``kind``; a CUDA tensor on a gloo
        group goes through host memory, both ways. ``copy`` hands ``fn`` a
        copy where it would get ``t`` itself (an in-place reduction must
        not write into an autograd input)."""
        group = self._group(axis)
        rec = COLLECTIVES[kind]
        rec["count"] += 1
        rec["bytes"] += _RING[kind](t.numel() * t.element_size(),
                                    dist.get_world_size(group))
        staged = t.is_cuda and dist.get_backend(group) == "gloo"
        if staged:
            h = t.detach().cpu()
        else:
            h = t.detach().clone(memory_format=torch.contiguous_format) \
                if copy else t.contiguous()
        out = fn(h, group)
        return out.to(t.device) if staged and out is not None else out

    def all_reduce(self, t: torch.Tensor, axis, *,
                   copy: bool = False) -> torch.Tensor:
        """Sum over ``axis`` (:meth:`_group`: a mesh dim, a group such as
        a :meth:`part_group`, or None for the world), in ``t``'s dtype."""
        def fn(h, group):
            dist.all_reduce(h, group=group)
            return h
        return self._collective(t, axis, fn, "all-reduce", copy=copy)

    def reduce_model(self, t: torch.Tensor, *,
                     copy: bool = False) -> torch.Tensor:
        """Sum over "model", in ``t``'s dtype."""
        if self.tp == 1:
            return t
        return self.all_reduce(t, "model", copy=copy)

    def reduce_data(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over "data", in ``t``'s dtype (in place where ``t`` is not
        staged through host memory)."""
        if self.dp == 1:
            return t
        return self.all_reduce(t, "data")

    def reduce_world(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over every rank of the mesh."""
        if self.dp * self.tp == 1:
            return t
        return self.all_reduce(t, None)

    def reduce_scatter_data(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Sum over "data", then keep this data rank's part of ``dim``
        (``dp`` equal parts): the FSDP gradient's reduce-scatter."""
        if self.dp == 1:
            return t

        def fn(h, group):
            parts = [c.contiguous() for c in h.chunk(self.dp, dim)]
            out = torch.empty_like(parts[0])
            dist.reduce_scatter(out, parts, group=group)
            return out
        return self._collective(t, "data", fn, "reduce-scatter")

    def _gather(self, t: torch.Tensor, axis: str, n: int,
                dim: int) -> torch.Tensor:
        if n == 1:
            return t

        def fn(h, group):
            parts = [torch.empty_like(h) for _ in range(n)]
            dist.all_gather(parts, h, group=group)
            return torch.cat(parts, dim=dim)
        return self._collective(t, axis, fn, "all-gather")

    def gather_model(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Concatenate every "model" rank's ``t`` along ``dim``."""
        return self._gather(t, "model", self.tp, dim)

    def gather_data(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Concatenate every "data" rank's ``t`` along ``dim``."""
        return self._gather(t, "data", self.dp, dim)

    def gather_root(self, t: torch.Tensor, axis: str,
                    dim: int) -> Optional[torch.Tensor]:
        """Every ``axis`` rank's ``t`` concatenated along ``dim`` on the
        first rank of this rank's ``axis`` group; None on the others."""
        n = self.dp if axis == "data" else self.tp
        if n == 1:
            return t

        def fn(h, group):
            root = dist.get_global_rank(group, 0)
            parts = [torch.empty_like(h) for _ in range(n)] \
                if dist.get_rank() == root else None
            dist.gather(h, parts, dst=root, group=group)
            return None if parts is None else torch.cat(parts, dim=dim)
        return self._collective(t, axis, fn, "gather")

    def gather_rows(self, t: torch.Tensor, rows: Optional[slice]):
        """Every data rank's rows of ``t`` (dim 0), when the step's rows
        shard over "data" (``rows`` not None); else ``t``."""
        if rows is None:
            return t
        return self._gather(t, "data", self.dp, 0)

    def part_group(self, parts: int):
        """The group of the model ranks that hold the same one of
        ``parts`` parts of a leaf (``tp / parts`` ranks of this rank's
        data row: a KV head held by a group, ``Layout.kv_parts``); the
        whole "model" group for one part. The groups are made on first use:
        every rank of the world must ask for them at the same time."""
        if parts == 1:
            return self.mesh.get_group("model")
        if parts not in self._part_groups:
            ranks = self.mesh.mesh.reshape(self.dp, self.tp)
            me = dist.get_rank()
            for d in range(self.dp):
                for j in range(parts):
                    members = [int(ranks[d, r]) for r in range(self.tp)
                               if r * parts // self.tp == j]
                    g = dist.new_group(members)
                    if me in members:
                        self._part_groups[parts] = g
        return self._part_groups[parts]

    # -- autograd-aware collectives (Megatron's operators; training) ---------

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        """Identity forward, the gradient summed over "model" backward: in
        front of a column-cut leaf, whose input every model rank holds
        whole but whose gradient each computes only for its own columns."""
        return x if self.tp == 1 else _CopyToModel.apply(x, self)

    def reduce_over_model(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over "model" forward, identity backward: after a row-cut
        leaf and after the vocab-cut embedding."""
        return x if self.tp == 1 else _ReduceOverModel.apply(x, self)

    def gather_over_model(self, x: torch.Tensor,
                          dim: int = -1) -> torch.Tensor:
        """Concatenate over "model" forward; backward keeps this rank's
        slice of the gradient: a ``"gather"``-marked leaf's input, the
        vocab-cut logits."""
        return x if self.tp == 1 else _GatherOverModel.apply(x, self, dim)


class _CopyToModel(torch.autograd.Function):
    """:meth:`Layout.copy_to_model`. ``torch.distributed.nn``'s
    all-reduce is not used: its backward all-reduces the gradient again,
    which multiplies a replicated gradient by tp."""

    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout = layout
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.layout.reduce_model(g, copy=True), None


class _ReduceOverModel(torch.autograd.Function):
    """:meth:`Layout.reduce_over_model`."""

    @staticmethod
    def forward(ctx, x, layout):
        return layout.reduce_model(x, copy=True)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherOverModel(torch.autograd.Function):
    """:meth:`Layout.gather_over_model`."""

    @staticmethod
    def forward(ctx, x, layout, dim):
        ctx.layout, ctx.dim = layout, dim
        return layout.gather_model(x, dim)

    @staticmethod
    def backward(ctx, g):
        lay, dim = ctx.layout, ctx.dim
        n = g.shape[dim] // lay.tp
        return g.narrow(dim, lay.tp_rank * n, n).contiguous(), None, None


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
        if isinstance(tree, torch.Tensor):
            return layout.cut(path, tree)
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


# ---------------------------------------------------------------------------
# training on a mesh: FSDP (ZeRO) shares of a rank's TP slice
# ---------------------------------------------------------------------------

def fsdp_dim(names, shape, n: int) -> Optional[int]:
    """The dim of a whole leaf at key path ``names`` that FSDP cuts over a
    data axis of ``n`` ranks (JAX's ``param_shardings(fsdp=True)`` and its
    ``_matrix_spec``): the embedding's d; a matrix's K for a
    column-parallel or replicated leaf, its N for a row-parallel one; None
    for norms, biases and scalars, and where ``n`` does not divide the
    dim. A negative dim: the TP cut never touches it, so it is the same
    dim of a rank's slice."""
    names = tuple(names)
    if "embed" in names:
        dim = -1
    elif len(shape) >= 2 and "kernel" in names:
        dim = -1 if leaf_kind_for_path(names) == "row" else -2
    else:
        return None
    return dim if n > 0 and shape[dim] % n == 0 else None


@dataclasses.dataclass(frozen=True)
class LeafShard:
    """Where one leaf of the whole tree lies on a rank: ``shape`` the whole
    leaf's; ``tp`` (dim, parts, index) of its TP cut, None where every
    model rank holds it whole; ``fsdp`` the dim its FSDP share is cut
    along over "data" (of more than one rank), None where every data
    rank holds the whole slice."""
    shape: tuple
    tp: Optional[tuple]
    fsdp: Optional[int]


def _map_paths(fn, tree, path=()):
    if isinstance(tree, Mapping):
        return {k: _map_paths(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


class TrainShards:
    """How a (data, model) mesh holds the training state of ``cfg``
    (``runtime.steps.make_train_step(..., mesh=)``): each rank holds its TP
    slice of every leaf (:meth:`Layout.cut`) and, under ``fsdp``, only its
    data-axis share of that slice (:func:`fsdp_dim`). A rank's state is
    the whole tree's key structure with plain tensors (no ``"tp"`` marks):
    parameters, and AdamW's m and v beside them (JAX's ``oshard = {"m":
    pshard, "v": pshard}``).

    :meth:`cut` takes a whole tree to a rank's shares; :meth:`gather_data`
    gathers shares back into TP slices (before a forward); :meth:`whole`
    gathers the whole tree from every rank to rank 0 (tests, checkpoints);
    :meth:`reduce_grads` takes a microbatch's gradients of the TP slices to
    the shares; :meth:`global_norm` is the clip's norm over every distinct
    element once. A QuantizedTensor never trains: :meth:`cut` refuses
    one."""

    def __init__(self, cfg, mesh, *, fsdp: bool):
        self.layout = lay = Layout(cfg, mesh)
        self.fsdp = fsdp
        self.marks = {}          # linear / embedding dict path -> "tp" mark
        self.leaves = {}         # leaf path -> LeafShard
        meta = T.init_params(torch.Generator(), cfg, device="meta")

        def visit(tree, path):
            if "kernel" in tree or "table" in tree:
                plan = lay.leaf_cut(path, tree)
                if plan is not None:
                    self.marks[path] = plan[0]
                cut = None if plan is None or plan[0] == "gather" \
                    else plan[1:]
                for k, t in tree.items():
                    tp = cut if k != "bias" or (cut and cut[0] == -1) \
                        else None
                    self._add(path + (k,), t, tp)
                return
            for k, v in tree.items():
                if isinstance(v, Mapping):
                    visit(v, path + (k,))
                else:
                    self._add(path + (k,), v, lay.bare_cut(path + (k,)))

        visit(meta, ())
        # the KV heads held by a group of model ranks: each rank's
        # gradient is partial, summed over its group (the groups are made
        # here, on every rank at once; a spec-level stand-in mesh has none)
        self.groups = {s.tp[1]: None for s in self.leaves.values()
                       if s.tp is not None and s.tp[1] < lay.tp}
        if getattr(mesh, "mesh_dim_names", None) is not None:
            for parts in sorted(self.groups):
                self.groups[parts] = lay.part_group(parts)

    def _add(self, path, t, tp):
        dp = self.layout.dp
        dim = fsdp_dim(path, tuple(t.shape), dp) \
            if self.fsdp and dp > 1 else None
        self.leaves[path] = LeafShard(tuple(t.shape), tp, dim)

    # -- whole tree <-> shares ------------------------------------------------

    def _check(self, path, t):
        if isinstance(t, QuantizedTensor):
            raise TypeError(
                f"{'/'.join(path)} is a QuantizedTensor: a quantized tree "
                f"serves but never trains (train the dense tree, then "
                f"quantize_params)")
        if path not in self.leaves:
            raise KeyError(f"{'/'.join(path)} is not a leaf of "
                           f"{self.layout.cfg.name}'s parameters")
        return self.leaves[path]

    def cut(self, tree):
        """This rank's shares of a whole param-structured tree (the
        parameters, or AdamW's m or v)."""
        lay = self.layout

        def fn(path, t):
            s = self._check(path, t)
            if s.tp is not None:
                t = _take(t, *s.tp)
            if s.fsdp is not None:
                t = _take(t, s.fsdp, lay.dp, lay.dp_rank)
            return t
        return _map_paths(fn, tree)

    def gather_data(self, shares):
        """The TP slices, every FSDP share gathered over "data"."""
        lay = self.layout

        def fn(path, t):
            s = self.leaves[path]
            return t if s.fsdp is None else lay.gather_data(t, s.fsdp)
        return _map_paths(fn, shares)

    def marked(self, slices):
        """``slices`` with each cut linear's and embedding's ``"tp"`` mark
        set, as ``layers.linear`` / ``embed`` and the head read them."""
        def visit(tree, path):
            if not isinstance(tree, Mapping):
                return tree
            out = {k: visit(v, path + (k,)) for k, v in tree.items()}
            if path in self.marks:
                out["tp"] = self.marks[path]
            return out
        return visit(slices, ())

    def whole(self, shares):
        """The whole tree on mesh rank (0, 0), global rank 0, every rank
        joining the gathers; None on the others. FSDP shares are gathered
        over "data" to data rank 0, then TP slices over "model" to model
        rank 0 (one of each group holding a KV head)."""
        lay = self.layout

        def fn(path, t):
            s = self.leaves[path]
            if s.fsdp is not None:
                t = lay.gather_root(t, "data", s.fsdp)
            if lay.dp_rank or s.tp is None:
                return t
            dim, parts, _ = s.tp
            t = lay.gather_root(t, "model", dim)
            if t is None or parts == lay.tp:
                return t
            return torch.cat(t.chunk(lay.tp, dim)[::lay.tp // parts],
                             dim=dim)
        out = _map_paths(fn, shares)
        return out if lay.dp_rank == lay.tp_rank == 0 else None

    def _state(self, fn, tree):
        """``fn`` over the param-structured parts of a runner state
        ``{"params", "opt": {"m", "v", "count"}}``."""
        out = dict(tree, params=fn(tree["params"]))
        if "opt" in tree:
            out["opt"] = dict(tree["opt"], m=fn(tree["opt"]["m"]),
                              v=fn(tree["opt"]["v"]))
        return out

    def whole_state(self, tree):
        """:meth:`whole` of a runner state's parameters, m and v: the
        whole state on rank 0, None on the others."""
        out = self._state(self.whole, tree)
        return out if out["params"] is not None else None

    def cut_state(self, tree):
        """:meth:`cut` of a runner state's parameters, m and v."""
        return self._state(self.cut, tree)

    def whole_shapes(self, tree):
        """A runner state's (or a param tree's) leaves as ``meta`` tensors
        of the whole tree's shapes, in each leaf's dtype."""
        def fn(sub):
            return _map_paths(lambda path, t: torch.empty(
                self.leaves[path].shape, dtype=t.dtype, device="meta"), sub)
        return self._state(fn, tree) if "params" in tree else fn(tree)

    # -- gradients -----------------------------------------------------------

    def reduce_grads(self, grads, split: bool):
        """A microbatch's gradients of the TP slices (each rank's for its
        rows) → this rank's shares of their sum over the batch: a KV
        head's partial gradients summed over the ranks holding it; then,
        where the rows split over "data" (``split``), reduce-scattered onto
        the FSDP shares (JAX's per-microbatch ``with_sharding_constraint``
        onto ``fsdp_shardings``) or all-reduced over "data"; where every
        data rank ran every row, each keeps its share."""
        lay = self.layout

        def fn(path, g):
            s = self.leaves[path]
            if s.tp is not None and s.tp[1] < lay.tp:
                g = lay.all_reduce(g, self.groups[s.tp[1]])
            if not split:
                return g if s.fsdp is None \
                    else _take(g, s.fsdp, lay.dp, lay.dp_rank)
            if s.fsdp is None:
                return lay.reduce_data(g)
            return lay.reduce_scatter_data(g, s.fsdp)
        return _map_paths(fn, grads)

    def global_norm(self, grads) -> torch.Tensor:
        """sqrt of the sum of squares of every distinct element once: a
        share counted by each data rank, a TP part by one rank of the
        model ranks holding it, a replicated leaf by one rank; summed
        over the world in fp32."""
        lay = self.layout
        leaves = tree_flatten_with_keys(grads)
        total = torch.zeros((), dtype=torch.float32,
                            device=leaves[0][1].device)
        for path, g in leaves:
            s = self.leaves[path]
            held = lay.tp if s.tp is None else lay.tp // s.tp[1]
            if lay.tp_rank % held == 0 and (s.fsdp is not None
                                            or lay.dp_rank == 0):
                total = total + torch.sum(torch.square(g.to(torch.float32)))
        return torch.sqrt(lay.reduce_world(total))


def pool_spec(shape, layout: Layout) -> tuple:
    """Spec of a paged-pool leaf ((L, nb, ps, Hkv, D), (L, nb, ps, Hkv)
    scales or (L, nb, ps) tags): pages replicated over the DP axes, the
    KV-head dim over "model" when the rank holds its own heads."""
    spec = [None] * len(shape)
    if len(shape) >= 4 and layout.attn_sharded:
        spec[3] = "model"
    return tuple(spec)


def carry_spec(name: str, shape, layout: Layout) -> tuple:
    """Spec of a per-slot state leaf, stacked over L with the batch (the
    ``max_batch`` slots) on dim 1: the batch over the DP axes where
    ``batch_spec`` splits it (:meth:`Layout.rows`), and over "model"
    rwkv's ``wkv`` (L, B, H, hd, hd) by head, the SSM's ``ssm`` (L, B,
    d_inner, n) by channel and ``enc_kv``'s K and V (L, B, T, Hkv, D) by
    KV head, where the rank holds a slice of them. rwkv's token shifts
    (L, B, d) are whole on every model rank (their input is the
    replicated residual stream). JAX cuts ``enc_kv``'s frame dim T over
    "model" (GSPMD then gathers it for every cross-attention); a rank that
    runs its KV heads alone holds them for every frame."""
    spec = [None] * len(shape)
    spec[1] = batch_axis_entry(shape[1], layout.mesh)
    if name == "wkv" and layout.tm_sharded \
            or name == "ssm" and layout.ssm_sharded:
        spec[2] = "model"
    elif name == "enc_kv" and layout.attn_sharded:
        spec[3] = "model"
    return tuple(spec)


def decode_state_shardings(state, cfg, mesh):
    """Specs of a decode state of ``max_batch`` slots (JAX's
    ``decode_state_shardings``): every paged-pool leaf by
    :func:`pool_spec` (with the KV heads replicated over ``tp / Hkv``
    ranks the head dim is "model" too, each rank holding one head; JAX
    replicates such a pool whole), the recurrent carries and ``enc_kv`` by
    :func:`carry_spec`."""
    layout = Layout(cfg, mesh)
    cache = state["cache"]
    out = {"cache": {}}
    for name, leaf in cache.items():
        if name == "kv":
            out["cache"]["kv"] = PagedKVCache(*(
                None if t is None else pool_spec(tuple(t.shape), layout)
                for t in leaf))
        else:
            out["cache"][name] = carry_spec(name, tuple(leaf.shape), layout)
    if "enc_kv" in state:
        out["enc_kv"] = tuple(carry_spec("enc_kv", tuple(t.shape), layout)
                              for t in state["enc_kv"])
    return out
