"""Train and serving steps as plain eager functions (port of
``repro/runtime/steps.py``). PyTorch runs eagerly: no ``torch.compile`` and
no CUDA graphs yet. The serving steps' greedy argmax runs on the device;
the engine syncs one (B,) int array per step. On a mesh (``cfg.shard``)
a step whose batch splits over "data" runs this rank's rows and
all-gathers their argmax over "data", so every rank's host loop sees the
whole step's tokens.

``make_train_step`` casts the gradients to ``grad_dtype`` (bf16) at every
microbatch count, accumulates them across microbatches in that dtype and
divides by the count, then runs the AdamW update. On one device it
computes the plain step whatever the settings, as JAX's does when it is
given no sharding pytrees. With ``mesh`` it is the counterpart of JAX's
``jit_train_step``, SPMD by hand (:func:`_mesh_train_step`).

The serving steps take ``fsdp_serve`` as JAX's ``jit_*_step`` do: on a
mesh their ``params`` are then the rank's shares over "data" of its
serving slice (``runtime.sharding.serve_shares``), gathered a layer at a
time; without a mesh it changes nothing, as in JAX.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch.core.quant import true_div
from repro_torch.core.tree import tree_map
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
