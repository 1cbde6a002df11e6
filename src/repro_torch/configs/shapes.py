"""Serving cache sizing (port of ``repro/configs/shapes.py``)."""
from __future__ import annotations

from typing import Optional

from repro_torch.models.config import ModelConfig


def serve_cache_len(cfg: ModelConfig, prompt_len: int, gen: int,
                    page_size: Optional[int] = None) -> int:
    """Per-slot KV window for ``prompt_len`` prompt + ``gen`` new tokens:
    bounded by the sliding window, rounded up to a page multiple."""
    total = prompt_len + (cfg.vision_prefix or 0) + gen
    if cfg.sliding_window > 0:
        total = min(total, cfg.sliding_window)
    if page_size:
        total = -(-total // page_size) * page_size
    return total


def serve_num_pages(cfg: ModelConfig, prompt_len: int, gen: int, *,
                    page_size: int, max_batch: int) -> int:
    """Physical block-pool size: pages per slot × max_batch, + 1 for the
    reserved null block (block 0)."""
    per_slot = serve_cache_len(cfg, prompt_len, gen, page_size) // page_size
    return 1 + per_slot * max_batch
