"""Serving steps as plain eager functions (port of the serve half of
``repro/runtime/steps.py``). PyTorch runs eagerly: no ``torch.compile`` and
no CUDA graphs yet. The greedy argmax runs on the device; the engine syncs
one (B,) int array per step."""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def make_serve_step(cfg: ModelConfig, *, cache_len: int,
                    kv_format: str = "kv_fp16", attn_path: str = "gather",
                    kv_partitions=None, live_pages=None):
    """serve_step(params, inputs={state, tokens, pos, tables}) — one paged
    decode step; returns {"next", "logits", "state"}."""
    def serve_step(params, inputs):
        logits, state = T.decode_step(
            params, cfg, inputs["state"], inputs["tokens"], inputs["pos"],
            tables=inputs["tables"], cache_len=cache_len,
            kv_format=kv_format, attn_path=attn_path,
            kv_partitions=kv_partitions, live_pages=live_pages)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return {"next": next_tok, "logits": logits, "state": state}
    return serve_step


def make_prefill_chunk_step(cfg: ModelConfig, cache_len: int, *,
                            kv_format: str = "kv_fp16",
                            attn_path: str = "gather", kv_partitions=None,
                            live_pages=None):
    """chunk_step(params, state, inputs={h, positions, table}) — one
    chunked-prefill step for one slot; returns {"logits", "state"}."""
    def chunk_step(params, state, inputs):
        logits, state = T.prefill_chunk_step(
            params, cfg, state, inputs["h"], inputs["positions"],
            inputs["table"], cache_len=cache_len, kv_format=kv_format,
            attn_path=attn_path, kv_partitions=kv_partitions,
            live_pages=live_pages)
        return {"logits": logits, "state": state}
    return chunk_step
