"""Architecture registry: the JAX package's ten archs, the assigned input
shapes, and meta-tensor input specs for every cell (port of
``repro/configs/__init__.py``).

``get_config(arch)`` / ``get_reduced(arch)`` resolve ``--arch`` ids to the
full published config and the small test config; ``input_specs(cfg,
shape)`` builds the allocation-free stand-ins (tensors on the ``meta``
device: shapes and dtypes, no storage) that the dry run
(``launch/dryrun.py``) traces against.
"""
from __future__ import annotations

import importlib
from typing import Dict

import torch

from repro_torch.configs.shapes import (SHAPES, ShapeSpec, cache_len_for,
                                        skip_reason)
from repro_torch.models.config import ModelConfig

ARCHS = (
    "granite-20b",
    "h2o-danube-1.8b",
    "starcoder2-7b",
    "llama3-405b",
    "internvl2-1b",
    "whisper-small",
    "rwkv6-7b",
    "mixtral-8x7b",
    "olmoe-1b-7b",
    "hymba-1.5b",
)

# the paper's own benchmark GEMM shapes (Figs. 2–3): (N, K) weight dims drawn
# from OpenPangu / DeepSeek-R1 / GLM-4.5 / LLaMA-3.2 projection layers
PAPER_GEMM_SHAPES = [
    (2048, 16384), (4096, 8192), (1024, 8192), (7168, 2048),
    (2048, 7168), (4096, 4096), (8192, 4096), (5120, 13824),
]
PAPER_BATCH_SIZES = [1, 4, 16, 64, 256]


def _module(arch: str):
    if arch not in ARCHS:
        raise ValueError(f"arch {arch!r} is not ported; ported: "
                         f"{list(ARCHS)}")
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).REDUCED


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Abstract inputs for the (arch × shape) cell, as meta tensors.

    train    → {"batch": {tokens, labels, [vision_embeds], [audio_embeds]}}
    prefill  → {"tokens", [prefix_embeds], [audio_embeds]}
    decode   → {"state", "tokens", "pos"}: the ring decode state of
               ``T.init_decode_state`` at ``cache_len_for(cfg, shape)``
    """
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    def text_len():
        return S - cfg.vision_prefix if cfg.vision_prefix else S

    if shape.kind == "train":
        batch = {"tokens": sds((B, text_len()), i32),
                 "labels": sds((B, text_len()), i32)}
        if cfg.vision_prefix:
            batch["vision_embeds"] = sds(
                (B, cfg.vision_prefix, cfg.d_model), cfg.dtype)
        if cfg.family == "encdec":
            batch["audio_embeds"] = sds(
                (B, cfg.encoder_seq, cfg.d_model), cfg.dtype)
        return {"batch": batch}

    if shape.kind == "prefill":
        out = {"tokens": sds((B, text_len()), i32)}
        if cfg.vision_prefix:
            out["prefix_embeds"] = sds(
                (B, cfg.vision_prefix, cfg.d_model), cfg.dtype)
        if cfg.family == "encdec":
            out["audio_embeds"] = sds(
                (B, cfg.encoder_seq, cfg.d_model), cfg.dtype)
        return out

    # decode: one new token against a seq_len-deep cache
    from repro_torch.models import transformer as T

    state = T.init_decode_state(cfg, B, cache_len_for(cfg, shape),
                                device="meta")
    return {"state": state, "tokens": sds((B,), i32), "pos": sds((B,), i32)}


__all__ = [
    "ARCHS", "SHAPES", "ShapeSpec", "PAPER_GEMM_SHAPES", "PAPER_BATCH_SIZES",
    "get_config", "get_reduced", "all_configs", "input_specs",
    "skip_reason", "cache_len_for",
]
