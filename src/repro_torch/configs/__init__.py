"""Architecture config registry: ``get_config("qwen3-14b")`` etc."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                      ModelConfig, PREFILL_32K,
                                      SHAPES_BY_NAME, ShapeConfig, TRAIN_4K,
                                      reduced, shapes_for)

_MODULES = {
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "qwen3-14b": "qwen3_14b",
    "qwen1.5-110b": "qwen1_5_110b",
    "qwen3-1.7b": "qwen3_1_7b",
    "internvl2-1b": "internvl2_1b",
    "rwkv6-3b": "rwkv6_3b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "musicgen-large": "musicgen_large",
}

ARCH_NAMES = tuple(_MODULES)
_cache: Dict[str, ModelConfig] = {}


def get_config(name: str) -> ModelConfig:
    if name not in _cache:
        if name not in _MODULES:
            raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
        mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
        _cache[name] = mod.CONFIG
    return _cache[name]


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}


__all__ = [
    "ALL_SHAPES", "ARCH_NAMES", "DECODE_32K", "LONG_500K", "ModelConfig",
    "PREFILL_32K", "SHAPES_BY_NAME", "ShapeConfig", "TRAIN_4K",
    "all_configs", "get_config", "reduced", "shapes_for",
]
