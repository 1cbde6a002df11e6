"""Train and serving steps (port of ``repro/runtime/steps.py``).

The ``make_*`` steps are plain eager functions. The serving steps' greedy
argmax runs on the device; the engine syncs one (B,) int array per step.
On a mesh (``cfg.shard``) a step whose batch splits over "data" runs this
rank's rows and all-gathers their argmax over "data", so every rank's
host loop sees the whole step's tokens.

``jit_serve_step``, ``jit_prefill_chunk_step``, ``jit_verify_step`` and
``jit_prefill_step`` (and ``jit_encode_step``, JAX's engine's jitted
encoder) are the counterparts of JAX's ``jax.jit`` steps on one device: a
:class:`CompiledStep` keeps one CUDA graph per call signature, as
``jax.jit`` keeps one executable per abstract signature. The signature
is the inputs' tree structure, every tensor leaf's shape, dtype and
device, and every other leaf's value (the engine gives the chunk step's
``slot`` as a 0-d device tensor, so one graph serves every slot).
A new signature runs the step once eagerly on a side stream (the kernels
build and the plan caches fill there, outside any capture), then captures
it on static copies of the inputs; a later call copies each input tensor
into its static buffer, unless it is that buffer, and replays. The state
is donated, as JAX's ``donate_argnums`` donates it: its static buffers
are the caller's own tensors, a state leaf the step returns anew is copied
back into its input leaf inside the graph, and the call returns the input
state tree itself, so the paged pool is never copied. Every other output
is a static buffer that the next replay of the same graph overwrites: a
caller that keeps one across a replay clones it. The kernels' launch
counters count each replay (``kernels/build.py``), after the capture has
held the launches it counted against the kernel nodes of its graph (a
mismatch raises). A capture that fails
raises, naming the step and its signature; nothing falls back to the eager
step.

On a mesh the serving and train steps stay eager, a named departure
(``MESH_DEPARTURE``, ``TRAIN_MESH_DEPARTURE``): a rank's
collectives go through gloo and host memory, which a CUDA graph cannot
capture. JAX's sharded ``jit_*`` steps get their counterpart once NCCL
runs across cards.

``make_train_step`` casts the gradients to ``grad_dtype`` (bf16) at every
microbatch count, accumulates them across microbatches in that dtype and
divides by the count, then runs the AdamW update. On one device it
computes the plain step whatever the settings, as JAX's does when it is
given no sharding pytrees. With ``mesh`` it is the counterpart of JAX's
``jit_train_step``, SPMD by hand (:func:`_mesh_train_step`), and runs
eagerly. :func:`jit_train_step` is JAX's ``jit_train_step`` on one
device: the step under CUDA graphs, its autograd pass and microbatch
loop inside the one graph, ``params`` and the AdamW state donated (the
new leaves are written back into the caller's tensors inside the graph).
A step that is captured reads nothing from the host: its ``step`` is a
0-d int32 tensor on the card, and the schedule and AdamW's scalars stay
on the card (``optim/schedule.py``).

The serving steps take ``fsdp_serve`` as JAX's ``jit_*_step`` do: on a
mesh their ``params`` are then the rank's shares over "data" of its
serving slice (``runtime.sharding.serve_shares``), gathered a layer at a
time; without a mesh it changes nothing, as in JAX.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core.quant import true_div
from repro_torch.core.tree import tree_map
from repro_torch.kernels import build
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_update, cosine_schedule


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    """The JAX package's train settings, field for field. ``fsdp`` cuts
    every rank's TP slice of a leaf over "data" too (ZeRO-3: each layer
    gathered just before it runs in every microbatch's forward and again
    in its recompute, its gradient reduce-scattered in the backward);
    ``zero2`` (with ``fsdp``) gathers the whole slice once a step and
    reuses the gathered copy across microbatches. ``opt_dtype`` is the
    AdamW moments' dtype (``AdamWConfig.state_dtype`` of the caller's
    optimizer). ``fsdp_serve`` is the serving steps' flag (the serving
    weights cut over "data", gathered a layer at a time): the train step
    does not read it; the dry run passes it to the prefill and decode
    cells, and ``ServingEngine(fsdp_serve=)`` to its steps."""

    microbatches: int = 1
    fsdp: bool = False
    fsdp_serve: bool = False
    opt_dtype: Any = torch.float32
    grad_dtype: Any = torch.bfloat16    # gradient compression
    zero2: bool = False


def _split_micro(batch, n: int):
    """``n`` microbatches of ``batch`` (row i of microbatch j is row
    j·B/n + i, as JAX's reshape to (n, B/n, ...))."""
    return [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[j]
             for k, v in batch.items()} for j in range(n)]


def value_and_grad(params, cfg: ModelConfig, batch, *, mark=None,
                   **loss_kw):
    """``(loss, grads)`` of ``T.loss_fn`` at ``params``; the grads in each
    leaf's dtype, the loss detached. ``mark`` turns the leaves into the
    tree the forward reads (a mesh rank's ``"tp"`` marks,
    ``TrainShards.marked``); ``loss_kw`` go to the loss."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss = T.loss_fn(leaves if mark is None else mark(leaves), cfg, batch,
                     **loss_kw)
    loss.backward()
    return loss.detach(), tree_map(
        lambda t: torch.zeros_like(t) if t.grad is None else t.grad, leaves)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    settings: TrainSettings = TrainSettings(), *,
                    mesh=None):
    """train_step(params, opt_state, inputs) → (params, opt_state,
    metrics); inputs = {"batch": {tokens, labels, [vision_embeds],
    [audio_embeds]}, "step": int}; metrics = {"loss", "grad_norm"}. With
    ``mesh`` the trees are this rank's shares (:func:`_mesh_train_step`)."""
    if mesh is not None:
        return _mesh_train_step(cfg, opt_cfg, settings, mesh)
    gdt, n = settings.grad_dtype, settings.microbatches

    def train_step(params, opt_state, inputs):
        batch, step = inputs["batch"], inputs["step"]
        if n > 1:
            loss = None
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=gdt,
                                                   device=p.device), params)
            for mb in _split_micro(batch, n):
                l, g = value_and_grad(params, cfg, mb)
                loss = l if loss is None else loss + l
                grads = tree_map(lambda a, b: a + b.to(gdt), grads, g)
                del g
            loss = true_div(loss, n)
            grads = tree_map(lambda g: true_div(g, n), grads)
        else:
            loss, grads = value_and_grad(params, cfg, batch)
            grads = tree_map(lambda g: g.to(gdt), grads)
        new_params, opt_state, om = adamw_update(
            grads, opt_state, params, opt_cfg, cosine_schedule(step))
        return new_params, opt_state, {"loss": loss, **om}

    return train_step


def _mesh_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                     settings: TrainSettings, mesh):
    """JAX's ``jit_train_step`` on a (data, model) mesh, SPMD by hand:
    ``params`` and AdamW's m and v are this rank's shares
    (``runtime.sharding.TrainShards``, the step's ``shards``: cut a whole
    tree with ``shards.cut``, gather one with ``shards.whole``), and every
    rank gets the whole batch of B rows.

    Microbatch j is rows [j·B/n, (j+1)·B/n); data rank d runs its 1/dp of
    them, or, where the data axis does not divide B/n (``batch_spec``),
    every data rank runs every row and the data reduction is skipped, as
    JAX then replicates. The loss of a rank's rows is its masked sum over
    the microbatch's unmasked labels on every data rank, so the ranks'
    losses and gradients sum to the microbatch's. ZeRO-3 (``fsdp``
    without ``zero2``) holds the shares through the forward: each layer
    is gathered just before it runs and again in its remat recompute
    (``TrainShards.gather_layer``, set as the layout's ``held``), the
    leaves outside the layer stacks once a microbatch, and each gathered
    layer's gradient is reduce-scattered onto the shares in the backward.
    ZeRO-2 (``fsdp`` and ``zero2``) gathers the whole slice once a step.
    Each microbatch's gradients are cast to ``grad_dtype``, summed over
    the ranks holding a KV head, reduce-scattered over "data" onto the
    shares (all-reduced without ``fsdp``), accumulated there, divided by
    n, and the AdamW update runs on the shares with the norm of every
    distinct element. ``metrics`` are JAX's, equal on every rank."""
    from repro_torch.runtime.sharding import TrainShards

    shards = TrainShards(cfg, mesh, fsdp=settings.fsdp)
    lay = shards.layout
    local = lay.local_cfg()
    gdt, n = settings.grad_dtype, settings.microbatches
    zero2 = settings.zero2 and settings.fsdp
    zero3 = settings.fsdp and not settings.zero2

    def train_step(params, opt_state, inputs):
        batch, step = inputs["batch"], inputs["step"]
        B = next(iter(batch.values())).shape[0]
        rows = lay.rows(B // n)
        micro = _split_micro(batch, n)
        if rows is not None:
            micro = [{k: v[rows] for k, v in mb.items()} for mb in micro]
        # each microbatch's unmasked labels over every data rank's rows
        counts = torch.stack([(mb["labels"] >= 0).sum().to(torch.float32)
                              for mb in micro])
        if rows is not None:
            counts = lay.reduce_data(counts)
        if zero3:
            lay.held = functools.partial(shards.gather_layer,
                                         split=rows is not None, gdt=gdt)
        gathered = shards.gather_data(params) if zero2 else None
        loss, grads = None, None
        for j, mb in enumerate(micro):
            w = params if zero3 else gathered if zero2 \
                else shards.gather_data(params)
            l, g = value_and_grad(w, local, mb, mark=shards.marked,
                                  count=counts[j], split=rows is not None)
            del w
            g = tree_map(lambda t: t.to(gdt), g)
            if not zero3:       # ZeRO-3's arrive on the shares
                g = shards.reduce_grads(g, rows is not None)
            loss = l if loss is None else loss + l
            grads = g if grads is None else tree_map(torch.add, grads, g)
            del g
        del gathered
        if rows is not None:
            loss = lay.reduce_data(loss)
        if n > 1:
            loss = true_div(loss, n)
            grads = tree_map(lambda g: true_div(g, n), grads)
        new_params, opt_state, om = adamw_update(
            grads, opt_state, params, opt_cfg, cosine_schedule(step),
            gnorm=shards.global_norm(grads))
        return new_params, opt_state, {"loss": loss, **om}

    train_step.shards = shards
    return train_step


def serving_cfg(cfg: ModelConfig, fsdp_serve: bool) -> ModelConfig:
    """``cfg`` for a serving step under ``fsdp_serve``: on a mesh, a rank
    that holds its leaves as ``sharding.serve_shares`` cut them and
    gathers each layer before it runs (its layout's ``held``); without a
    mesh, or without the flag, ``cfg`` itself."""
    lay = cfg.shard
    if not fsdp_serve or lay is None or lay.held is not None:
        return cfg
    return dataclasses.replace(cfg, shard=lay.holding_shares())


def make_embed_step(cfg: ModelConfig, *, fsdp_serve: bool = False):
    """embed(params, tokens) — a prompt's token embeddings (the paged
    engine's chunked-prefill stream, JAX's engine's jitted ``embed``).
    ``fsdp_serve``: see :func:`serving_cfg`."""
    cfg = serving_cfg(cfg, fsdp_serve)

    def embed(params, tokens):
        table = T.gathered(cfg, {"embed": params["embed"]})["embed"]
        return layers.embed(table, tokens, cfg)
    return embed


def make_encode_step(cfg: ModelConfig, *, fsdp_serve: bool = False):
    """encode(params, audio_embeds) — the encoder and every decoder
    layer's cross K/V over a request's audio (``T.encode_cross_kv``; the
    paged engine's admit, JAX's engine's jitted encode). ``fsdp_serve``:
    see :func:`serving_cfg`."""
    cfg = serving_cfg(cfg, fsdp_serve)

    def encode(params, audio_embeds):
        return T.encode_cross_kv(params, cfg, audio_embeds)
    return encode


def make_prefill_step(cfg: ModelConfig, cache_len: int, *,
                      fsdp_serve: bool = False):
    """prefill_step(params, inputs={tokens, [prefix_embeds],
    [audio_embeds]}) — a whole prompt into a ring decode state (the draft
    model's admit); returns (logits, state). ``fsdp_serve``: see
    :func:`serving_cfg`."""
    cfg = serving_cfg(cfg, fsdp_serve)

    def prefill_step(params, inputs):
        return T.prefill(params, cfg, inputs["tokens"], cache_len=cache_len,
                         prefix_embeds=inputs.get("prefix_embeds"),
                         audio_embeds=inputs.get("audio_embeds"))
    return prefill_step


def _all_rows(cfg: ModelConfig, next_tok, B: int):
    """The step's tokens for every row: this rank's, gathered over "data"
    when the batch of B rows splits there."""
    if cfg.shard is None:
        return next_tok
    return cfg.shard.gather_rows(next_tok, cfg.shard.rows(B))


def make_serve_step(cfg: ModelConfig, *, cache_len: int = 0,
                    kv_format: str = "kv_fp16", attn_path: str = "gather",
                    kv_partitions=None, live_pages=None,
                    fsdp_serve: bool = False):
    """serve_step(params, inputs={state, tokens, pos, [tables], [active]})
    — one decode step, paged when ``inputs`` carries block tables, else on
    the ring (or rwkv's carry-only) state; ``active`` keeps the carries of
    rows that are not decoding. Returns {"next", "logits", "state"}.
    ``fsdp_serve``: see :func:`serving_cfg`."""
    cfg = serving_cfg(cfg, fsdp_serve)

    def serve_step(params, inputs):
        logits, state = T.decode_step(
            params, cfg, inputs["state"], inputs["tokens"], inputs["pos"],
            tables=inputs.get("tables"), cache_len=cache_len,
            kv_format=kv_format, attn_path=attn_path,
            kv_partitions=kv_partitions, live_pages=live_pages,
            active=inputs.get("active"))
        next_tok = _all_rows(cfg, torch.argmax(logits, dim=-1).to(
            torch.int32), inputs["tokens"].shape[0])
        return {"next": next_tok, "logits": logits, "state": state}
    return serve_step


def make_prefill_chunk_step(cfg: ModelConfig, cache_len: int, *,
                            kv_format: str = "kv_fp16",
                            attn_path: str = "gather", kv_partitions=None,
                            live_pages=None, fsdp_serve: bool = False):
    """chunk_step(params, state, inputs={h, positions, table, slot}) — one
    chunked-prefill step for one slot (``table`` None for rwkv); returns
    {"logits", "state"}. ``fsdp_serve``: see :func:`serving_cfg`."""
    cfg = serving_cfg(cfg, fsdp_serve)

    def chunk_step(params, state, inputs):
        logits, state = T.prefill_chunk_step(
            params, cfg, state, inputs["h"], inputs["positions"],
            inputs.get("table"), inputs.get("slot"), cache_len=cache_len,
            kv_format=kv_format,
            attn_path=attn_path, kv_partitions=kv_partitions,
            live_pages=live_pages)
        return {"logits": logits, "state": state}
    return chunk_step


def make_verify_step(cfg: ModelConfig, cache_len: int, *,
                     kv_format: str = "kv_fp16", attn_path: str = "gather",
                     kv_partitions=None, live_pages=None,
                     fsdp_serve: bool = False):
    """verify(params, state, inputs={tokens, positions, [tables]}) — one
    batched speculative-verify step (see ``T.verify_step``): the last
    emitted token plus up to C-1 drafts for every slot in one forward
    pass; ``next`` is the device-side argmax of every (slot, position)
    cell, so the host syncs one (B, C) int array per step. Returns
    {"next", "logits", "state", "carries"} (the carry checkpoints of the
    rwkv and hybrid families, else None). ``fsdp_serve``: see
    :func:`serving_cfg`."""
    cfg = serving_cfg(cfg, fsdp_serve)

    def verify(params, state, inputs):
        logits, state, carries = T.verify_step(
            params, cfg, state, inputs["tokens"], inputs["positions"],
            inputs.get("tables"), cache_len=cache_len, kv_format=kv_format,
            attn_path=attn_path, kv_partitions=kv_partitions,
            live_pages=live_pages)
        next_tok = _all_rows(cfg, torch.argmax(logits, dim=-1).to(
            torch.int32), inputs["tokens"].shape[0])
        return {"next": next_tok, "logits": logits, "state": state,
                "carries": carries}
    return verify


# ---------------------------------------------------------------------------
# compiled steps: the counterparts of JAX's jax.jit serving and train steps
# ---------------------------------------------------------------------------

MESH_DEPARTURE = (
    "on a mesh the serving steps stay eager: a rank's collectives go "
    "through gloo and host memory, which a CUDA graph cannot capture "
    "(JAX's sharded jit_* steps get their counterpart once NCCL runs "
    "across cards)")
TRAIN_MESH_DEPARTURE = (
    "on a mesh the train step stays eager: a rank's collectives go "
    "through gloo and host memory, which a CUDA graph cannot capture "
    "(JAX's sharded jit_train_step gets its counterpart once NCCL runs "
    "across cards)")


class CaptureFailed(RuntimeError):
    """A compiled step's capture failed (or its graph disagreed with the
    launches counted during it). Nothing falls back to the eager step, and
    the training runner does not retry it: the same capture fails again."""


class CudaGraphs:
    """How a :class:`CompiledStep` warms up and captures: CUDA graphs on
    the card. ``capture`` returns the captured run's outputs, the replay,
    the bytes the capture reserved and the function names of the graph's
    kernel nodes (None where the backend cannot read them)."""

    device_type = "cuda"

    def __init__(self):
        self._side: Dict[int, Any] = {}     # device → its one side stream

    def new_pool(self):
        return torch.cuda.graph_pool_handle()

    def warm_up(self, run: Callable):
        """``run()`` eagerly on a side stream (one a device, so the cache
        keeps one stream's blocks), ordered after and before the current
        stream's work."""
        cur = torch.cuda.current_stream()
        side = self._side.get(cur.device_index)
        if side is None:
            side = self._side[cur.device_index] = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = run()
        cur.wait_stream(side)
        return out

    def capture(self, run: Callable, statics: List, pool):
        # kept, so its kernel nodes can be read after the capture
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # what the capture reserves, not what the cache hands back first
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved()
        # no collection inside the capture: one could destroy another
        # graph (an engine dropped in a reference cycle), which is not
        # permitted while a stream captures and ends the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: the front door steps the engine in a worker
            # thread
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                out = run()
        finally:
            if collecting:
                gc.enable()
        graph.instantiate()
        return out, graph.replay, torch.cuda.memory_reserved() - before, \
            build.graph_kernel_names(graph.raw_cuda_graph())


# the capture backend; the CPU tests patch in a stand-in
GRAPHS = CudaGraphs()


def eager_reason(device, mesh=None) -> Optional[str]:
    """Why the serving steps on ``device`` (on ``mesh``) run eagerly, or
    None where they are compiled."""
    if mesh is not None:
        return MESH_DEPARTURE
    dev = torch.device(device)
    if dev.type != GRAPHS.device_type:
        return (f"CUDA graphs capture work on the card only; {dev.type} "
                f"steps run eagerly")
    return None


@dataclasses.dataclass
class GraphPool:
    """One memory pool that compiled steps share (an engine's), and what
    was captured into it: ``graphs``, the ``bytes`` the captures reserved,
    the seconds they took (``capture_s``, the eager warm-ups included),
    the kernel nodes of the counted kernels held against their counted
    launches (``nodes``) and every kernel node of the graphs
    (``kernels``)."""

    handle: Any = None
    graphs: int = 0
    bytes: int = 0
    capture_s: float = 0.0
    nodes: int = 0
    kernels: int = 0


def _flatten(tree, leaves: list):
    """The structure of ``tree`` (dicts, tuples, lists, named tuples) as a
    hashable key; its leaves, tensors or not, appended to ``leaves``."""
    if isinstance(tree, dict):
        return (dict, tuple((k, _flatten(tree[k], leaves))
                            for k in sorted(tree)))
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(t, leaves) for t in tree))
    leaves.append(tree)
    return None


def _leaf_key(leaf):
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), leaf.dtype, leaf.device)
    try:
        hash(leaf)
    except TypeError:
        raise TypeError(f"a compiled step's inputs take tensors and "
                        f"hashable values; got {type(leaf).__name__}") \
            from None
    return (type(leaf), leaf)


def _rebuild(tree, keep, leaf_fn):
    """``tree`` with each leaf through ``leaf_fn``, the subtree ``keep``
    (the donated state) kept as it is."""
    if tree is keep:
        return tree
    if isinstance(tree, dict):
        return {k: _rebuild(v, keep, leaf_fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [_rebuild(t, keep, leaf_fn) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return leaf_fn(tree)


def _shallow(out):
    """A fresh container around the static outputs (a caller may set its
    keys)."""
    if isinstance(out, dict):
        return dict(out)
    return out


class CompiledStep:
    """A step under CUDA graphs (module docstring): a serving step
    ``fn(params, *args)`` captured under ``torch.no_grad`` once per
    signature of ``args``, its ``params`` the tensors of the first call (a
    call on other weights raises); with ``train``, ``fn(*args)`` captured
    with autograd on (the backward inside the graph), every argument part
    of the signature (the train step, whose parameters are donated
    state). ``state`` picks the donated state out of ``args`` (None:
    nothing donated); the step returns it under the ``"state"`` key.
    ``fn`` stays the eager step. ``pool`` is the :class:`GraphPool`
    shared with other steps."""

    def __init__(self, fn: Callable, name: str, *,
                 state: Optional[Callable] = None,
                 pool: Optional[GraphPool] = None, train: bool = False):
        self.fn, self.name, self.state, self.train = fn, name, state, train
        self.pool = GraphPool() if pool is None else pool
        self.graphs: Dict[Any, "_Captured"] = {}
        self._params = None

    def __call__(self, *args):
        fn = self.fn
        if not self.train:
            params, args = args[0], args[1:]
            if self._params is None:
                self._params = params
            elif params is not self._params:
                raise ValueError(f"{self.name}: captured on other weights; "
                                 f"compile a new step for these")
            fn = functools.partial(fn, params)
        leaves: list = []
        shape = _flatten(args, leaves)
        sig = (shape, tuple(_leaf_key(leaf) for leaf in leaves))
        cap = self.graphs.get(sig)
        if cap is None:
            return self._first(sig, fn, args)
        return cap.replay(leaves)

    def _merge(self, out, state):
        """The step's outputs with its returned state written into the
        donated ``state`` (each leaf it returned anew is copied back into
        the input leaf) and returned as that tree."""
        if self.state is None:
            return out
        new: list = []
        old: list = []
        if _flatten(out["state"], new) != _flatten(state, old):
            raise ValueError(f"{self.name} returned a state of another "
                             f"structure than its input's")
        for dst, src in zip(old, new):
            if isinstance(src, torch.Tensor) and src is not dst:
                dst.copy_(src)
        return dict(out, state=state)

    def _first(self, sig, fn, args):
        """A new signature: run eagerly (the call's result), then capture
        on static inputs (the donated state is the caller's own)."""
        where = [leaf.device for leaf in flat_leaves(args)
                 if isinstance(leaf, torch.Tensor)]
        if where and where[0].type != GRAPHS.device_type:
            raise ValueError(f"{self.name}: {eager_reason(where[0])}")
        t0 = time.perf_counter()
        state = None if self.state is None else self.state(args)
        with torch.enable_grad() if self.train else torch.no_grad():
            out = GRAPHS.warm_up(lambda: self._merge(fn(*args), state))
            static_args = _rebuild(
                args, state,
                lambda x: x.clone() if isinstance(x, torch.Tensor) else x)
            statics = flat_leaves(static_args)
            if self.pool.handle is None:
                self.pool.handle = GRAPHS.new_pool()
            before = build.launch_counts()
            try:
                sout, replay, nbytes, names = GRAPHS.capture(
                    lambda: self._merge(fn(*static_args), state), statics,
                    self.pool.handle)
            except Exception as e:
                raise CaptureFailed(
                    f"capturing {self.name} failed at signature "
                    f"{_describe(sig)}: {e}") from e
            finally:
                after = build.launch_counts()
                delta = {k: n - before.get(k, 0) for k, n in after.items()
                         if n != before.get(k, 0)}
                # the capture launched nothing: its counts come per replay
                build.add_launches(delta, -1)
            if names is not None:
                bad = build.node_mismatch(delta, names)
                if bad:
                    raise CaptureFailed(
                        f"{self.name} at signature {_describe(sig)}: the "
                        f"graph's kernel nodes disagree with the launches "
                        f"counted during its capture: {'; '.join(bad)}")
                self.pool.nodes += sum(n for k, n in delta.items()
                                       if isinstance(k, build.CudaKernel))
                self.pool.kernels += len(names)
        self.graphs[sig] = _Captured(statics, sout, replay, delta)
        self.pool.graphs += 1
        self.pool.bytes += int(nbytes)
        self.pool.capture_s += time.perf_counter() - t0
        return out


def flat_leaves(tree) -> list:
    """Every leaf of ``tree`` (tensors, None and values), in the order of
    the compiled steps' signatures."""
    leaves: list = []
    _flatten(tree, leaves)
    return leaves


def refill(state, fresh):
    """``state`` with ``fresh``'s values copied in where the two trees
    match leaf for leaf in shape and device (a compiled step captured
    ``state``'s tensors, so they are kept from run to run); else
    ``fresh``."""
    if state is None:
        return fresh
    old, new = [], []
    if _flatten(state, old) != _flatten(fresh, new) or any(
            (a is None) != (b is None) or a is not None and (
                a.shape != b.shape or a.device != b.device)
            for a, b in zip(old, new)):
        return fresh
    for dst, src in zip(old, new):
        if dst is not None:
            dst.copy_(src)
    return state


def _describe(sig) -> str:
    """A signature's leaves, readable: shapes and dtypes, or values."""
    return ", ".join(f"{tuple(k[0])} {str(k[1]).replace('torch.', '')}"
                     if isinstance(k[1], torch.dtype) else repr(k[1])
                     for k in sig[1])


@dataclasses.dataclass
class _Captured:
    """One captured signature: its static input leaves, static outputs,
    replay and launches a replay."""

    statics: list
    out: Any
    run: Callable
    launches: Dict[object, int]

    def replay(self, leaves: list):
        for static, x in zip(self.statics, leaves):
            if isinstance(static, torch.Tensor) and x is not static:
                static.copy_(x)
        self.run()
        build.add_launches(self.launches)
        return _shallow(self.out)


def _no_mesh(cfg: ModelConfig, mesh, name: str) -> None:
    if mesh is not None or cfg.shard is not None:
        raise ValueError(f"{name}: {MESH_DEPARTURE}")


def jit_serve_step(cfg: ModelConfig, *, mesh=None,
                   pool: Optional[GraphPool] = None, **kw) -> CompiledStep:
    """JAX's ``jit_serve_step`` on one device: :func:`make_serve_step`
    (``kw``: its keywords) compiled, ``inputs["state"]`` donated.
    ``pool``: see :class:`CompiledStep`."""
    _no_mesh(cfg, mesh, "jit_serve_step")
    return CompiledStep(make_serve_step(cfg, **kw), "serve_step",
                        state=lambda args: args[0]["state"], pool=pool)


def jit_prefill_chunk_step(cfg: ModelConfig, cache_len: int, *, mesh=None,
                           pool: Optional[GraphPool] = None,
                           **kw) -> CompiledStep:
    """JAX's ``jit_prefill_chunk_step`` on one device:
    :func:`make_prefill_chunk_step` compiled, its ``state`` donated; the
    ``slot`` a carry or encdec family reads is best a 0-d device tensor
    (one graph for every slot; an int is part of the signature, a graph
    per slot)."""
    _no_mesh(cfg, mesh, "jit_prefill_chunk_step")
    return CompiledStep(make_prefill_chunk_step(cfg, cache_len, **kw),
                        "prefill_chunk_step", state=lambda args: args[0],
                        pool=pool)


def jit_verify_step(cfg: ModelConfig, cache_len: int, *, mesh=None,
                    pool: Optional[GraphPool] = None, **kw) -> CompiledStep:
    """JAX's ``jit_verify_step`` on one device: :func:`make_verify_step`
    compiled, its ``state`` donated; the carry checkpoints come back in
    static buffers."""
    _no_mesh(cfg, mesh, "jit_verify_step")
    return CompiledStep(make_verify_step(cfg, cache_len, **kw),
                        "verify_step", state=lambda args: args[0],
                        pool=pool)


def jit_prefill_step(cfg: ModelConfig, cache_len: int, *, mesh=None,
                     pool: Optional[GraphPool] = None,
                     **kw) -> CompiledStep:
    """JAX's ``jit_prefill_step`` on one device: :func:`make_prefill_step`
    compiled, a graph per prompt length; nothing donated (the state it
    returns is a static buffer)."""
    _no_mesh(cfg, mesh, "jit_prefill_step")
    return CompiledStep(make_prefill_step(cfg, cache_len, **kw),
                        "prefill_step", pool=pool)


def jit_encode_step(cfg: ModelConfig, *, mesh=None,
                    pool: Optional[GraphPool] = None, **kw) -> CompiledStep:
    """JAX's engine's jitted encoder on one device: :func:`make_encode_step`
    compiled (one signature: the config's frames)."""
    _no_mesh(cfg, mesh, "jit_encode_step")
    return CompiledStep(make_encode_step(cfg, **kw), "encode_step",
                        pool=pool)


class CompiledTrainStep:
    """:func:`make_train_step` under CUDA graphs: ``step(params,
    opt_state, inputs) → (params, opt_state, metrics)`` as the eager step,
    one graph per signature of its arguments (the parameters' and
    moments' shapes, the batch's, the 0-d int32 ``step``), the backward
    and every microbatch inside it. ``params`` and ``opt_state`` are
    donated: the graph writes the new leaves into the caller's tensors and
    the call returns the trees of the first call, whose every leaf keeps
    its ``data_ptr`` from the first step to the last (a call on other
    tensors copies them in first). ``metrics`` are static buffers that
    the next replay overwrites. ``fn`` is the eager step; ``donates``
    tells the training runner that a step it ran has written its state
    (``runtime/resilient.py``)."""

    donates = True

    def __init__(self, fn: Callable):
        self.fn = fn

        def train_step(state, inputs):
            params, opt_state, metrics = fn(state["params"], state["opt"],
                                            inputs)
            return {"state": {"params": params, "opt": opt_state},
                    "metrics": metrics}
        self.step = CompiledStep(train_step, "train_step",
                                 state=lambda args: args[0], train=True)

    @property
    def pool(self) -> GraphPool:
        return self.step.pool

    @property
    def graphs(self) -> Dict[Any, "_Captured"]:
        return self.step.graphs

    def __call__(self, params, opt_state, inputs):
        out = self.step({"params": params, "opt": opt_state}, inputs)
        state = out["state"]
        return state["params"], state["opt"], out["metrics"]


def jit_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                   settings: TrainSettings = TrainSettings(), *,
                   mesh=None) -> CompiledTrainStep:
    """JAX's ``jit_train_step`` (``donate_argnums=(0, 1)``) on one device:
    :func:`make_train_step` compiled, ``params`` and the AdamW state
    donated (:class:`CompiledTrainStep`). Feed ``step`` as a 0-d int32
    tensor on the card (an int is part of the signature: a graph per
    step). On a mesh it raises, a named departure
    (``TRAIN_MESH_DEPARTURE``): ``make_train_step(mesh=)`` runs eagerly.
    The step's graph has a :class:`GraphPool` of its own (``.pool``)."""
    if mesh is not None or cfg.shard is not None:
        raise ValueError(f"jit_train_step: {TRAIN_MESH_DEPARTURE}")
    return CompiledTrainStep(make_train_step(cfg, opt_cfg, settings))
