"""Per-architecture paged-serving defaults (port of the page and chunk
settings of the serving presets of ``repro/launch/presets.py``)."""
from __future__ import annotations

import dataclasses
from typing import Optional


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
