"""The assigned input shapes (seq_len × global_batch) with their skip
rule, and serving cache sizing (port of ``repro/configs/shapes.py``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """None if the (arch × shape) cell runs; otherwise why it is skipped."""
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return ("full quadratic attention: a 500k dense KV cache per step is "
                "the sub-quadratic gate — skipped per brief (see DESIGN.md)")
    return None


def cache_len_for(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """Decode KV-cache length: bounded by the sliding window when present."""
    if cfg.sliding_window > 0:
        return min(shape.seq_len, cfg.sliding_window)
    return shape.seq_len


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
