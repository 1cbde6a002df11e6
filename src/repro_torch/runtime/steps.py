"""Train and serving steps as plain eager functions (port of
``repro/runtime/steps.py``). PyTorch runs eagerly: no ``torch.compile`` and
no CUDA graphs yet. The serving steps' greedy argmax runs on the device;
the engine syncs one (B,) int array per step. On a mesh (``cfg.shard``)
a step whose batch splits over "data" runs this rank's rows and
all-gathers their argmax over "data", so every rank's host loop sees the
whole step's tokens.

``make_train_step`` runs on one device: the JAX package's FSDP and ZeRO-2
shardings are not ported. Gradients are cast to ``grad_dtype`` (bf16) at
every microbatch count, accumulated across microbatches in that dtype and
divided by the count, then the fp32 AdamW update runs.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.quant import true_div
from repro_torch.core.tree import tree_map
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_update, cosine_schedule


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    """``fsdp`` and ``zero2`` (the JAX package's sharded settings, which
    its presets use) are refused by :func:`make_train_step`."""

    microbatches: int = 1
    fsdp: bool = False
    grad_dtype: Any = torch.bfloat16    # gradient compression
    zero2: bool = False


def _split_micro(batch, n: int):
    """``n`` microbatches of ``batch`` (row i of microbatch j is row
    j·B/n + i, as JAX's reshape to (n, B/n, ...))."""
    return [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[j]
             for k, v in batch.items()} for j in range(n)]


def value_and_grad(params, cfg: ModelConfig, batch):
    """``(loss, grads)`` of ``T.loss_fn`` at ``params``; the grads in each
    leaf's dtype, the loss detached."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss = T.loss_fn(leaves, cfg, batch)
    loss.backward()
    return loss.detach(), tree_map(
        lambda t: torch.zeros_like(t) if t.grad is None else t.grad, leaves)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    settings: TrainSettings = TrainSettings()):
    """train_step(params, opt_state, inputs) → (params, opt_state,
    metrics); inputs = {"batch": {tokens, labels}, "step": int}."""
    if settings.fsdp or settings.zero2:
        raise NotImplementedError(
            "make_train_step runs on one device: FSDP / ZeRO-2 sharding is "
            "not ported")
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


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    """prefill_step(params, inputs={tokens, [prefix_embeds],
    [audio_embeds]}) — a whole prompt into a ring decode state (the draft
    model's admit); returns (logits, state)."""
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
                    kv_partitions=None, live_pages=None):
    """serve_step(params, inputs={state, tokens, pos, [tables], [active]})
    — one decode step, paged when ``inputs`` carries block tables, else on
    the ring (or rwkv's carry-only) state; ``active`` keeps the carries of
    rows that are not decoding. Returns {"next", "logits", "state"}."""
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
                            live_pages=None):
    """chunk_step(params, state, inputs={h, positions, table, slot}) — one
    chunked-prefill step for one slot (``table`` None for rwkv); returns
    {"logits", "state"}."""
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
                     kv_partitions=None, live_pages=None):
    """verify(params, state, inputs={tokens, positions, [tables]}) — one
    batched speculative-verify step (see ``T.verify_step``): the last
    emitted token plus up to C-1 drafts for every slot in one forward
    pass; ``next`` is the device-side argmax of every (slot, position)
    cell, so the host syncs one (B, C) int array per step. Returns
    {"next", "logits", "state", "carries"} (the carry checkpoints of the
    rwkv and hybrid families, else None)."""
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
