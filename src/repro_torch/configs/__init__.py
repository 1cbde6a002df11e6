"""Architecture registry: the JAX package's ten archs.

``get_config(arch)`` / ``get_reduced(arch)`` resolve ``--arch`` ids to the
full published config and the small test config.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = ("h2o-danube-1.8b", "olmoe-1b-7b", "mixtral-8x7b", "rwkv6-7b",
         "hymba-1.5b", "whisper-small", "internvl2-1b", "starcoder2-7b",
         "granite-20b", "llama3-405b")


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
