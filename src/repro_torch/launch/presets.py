"""Per-architecture run settings (port of ``repro/launch/presets.py``):
the training presets, field for field, and the page and chunk settings of
the serving presets.

``PRESETS`` are the JAX package's, and each flag does in the port what it
does there, on a mesh (``runtime.steps.make_train_step(..., mesh=)``; on
one device the step computes the plain step whatever they say, as JAX's
does):

- ``microbatches``: the step's batch in that many microbatches, their
  gradients accumulated in ``grad_dtype``;
- ``fsdp``: every rank holds only its share over "data" of its TP slice
  (ZeRO-3: each layer gathered just before it runs in the forward and
  again in its remat recompute, its gradient reduce-scattered onto the
  shares in the backward; llama3-405b and mixtral);
- ``zero2`` (with ``fsdp``): the whole slice gathered once a step instead,
  where that copy fits;
- ``opt_dtype``: AdamW's moments' dtype (bf16 for llama3-405b);
- ``fsdp_serve`` (llama3-405b): the serving steps take the rank's shares
  over "data" of its W4A16 slice and gather a layer at a time (the dry
  run's prefill and decode cells; ``ServingEngine(fsdp_serve=)``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.runtime.steps import TrainSettings

PRESETS = {
    "granite-20b": TrainSettings(microbatches=16, fsdp=True, zero2=True),
    "h2o-danube-1.8b": TrainSettings(microbatches=4, fsdp=True, zero2=True),
    "starcoder2-7b": TrainSettings(microbatches=4, fsdp=True, zero2=True),
    # the ZeRO-2 copy would be too large: ZeRO-3
    "llama3-405b": TrainSettings(
        microbatches=16, fsdp=True, fsdp_serve=True,
        opt_dtype=torch.bfloat16),
    "internvl2-1b": TrainSettings(microbatches=4, fsdp=True, zero2=True),
    "whisper-small": TrainSettings(microbatches=4, fsdp=True, zero2=True),
    "rwkv6-7b": TrainSettings(microbatches=4, fsdp=True, zero2=True),
    "mixtral-8x7b": TrainSettings(microbatches=8, fsdp=True),
    "olmoe-1b-7b": TrainSettings(microbatches=4, fsdp=True, zero2=True),
    "hymba-1.5b": TrainSettings(microbatches=8, fsdp=True, zero2=True),
}


def settings_for(arch: str) -> TrainSettings:
    return PRESETS.get(arch, TrainSettings())


@dataclasses.dataclass(frozen=True)
class ServeSettings:
    """``page_size`` trades table length against fragmentation;
    ``prefill_chunk`` bounds the prompt tokens one engine step spends per
    slot (None = the engine default of 32); ``kv_format`` names a
    registered KV-cache format; ``attn_path`` is ``auto`` or a forced
    paged-attention path."""

    page_size: int = 16
    prefill_chunk: Optional[int] = 32
    kv_format: str = "kv_fp16"
    attn_path: str = "auto"


SERVE_PRESETS = {
    # SWA: window-bounded windows are short — small pages
    "h2o-danube-1.8b": ServeSettings(page_size=8, prefill_chunk=32),
    # vision prefix: chunks cover patch embeds + tokens uniformly
    "internvl2-1b": ServeSettings(page_size=8, prefill_chunk=32),
    # recurrent carries (and whisper's cross-attention) thread through the
    # chunk step; 32-token chunks bound a chunk's sequential recurrence
    "rwkv6-7b": ServeSettings(prefill_chunk=32),
    "whisper-small": ServeSettings(prefill_chunk=32),
    "hymba-1.5b": ServeSettings(prefill_chunk=32),
    # 405B-class: big pages keep the block tables short
    "llama3-405b": ServeSettings(page_size=64, prefill_chunk=256),
}


def serve_settings_for(arch: str) -> ServeSettings:
    return SERVE_PRESETS.get(arch, ServeSettings())
