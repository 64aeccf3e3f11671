"""Architecture registry: ``--arch <id>`` resolution for the launchers (the
port of ``repro/configs/registry.py``)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "gemma-7b": "gemma_7b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "qwen2-0.5b": "qwen2_0_5b",
    "minicpm3-4b": "minicpm3_4b",
    "whisper-base": "whisper_base",
    "zamba2-1.2b": "zamba2_1_2b",
    "internvl2-76b": "internvl2_76b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "mamba2-780m": "mamba2_780m",
}

ARCHS = tuple(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _mod(arch).smoke_config()
