"""Config registry: ``get_config("<arch-id>")`` / ``--arch <id>``.

One module per assigned architecture; each cites its source in the config's
``citation`` field. ``list_archs()`` enumerates the pool.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, ModelConfig, ShapeConfig,
                                shape_applicable)

ARCH_MODULES = {
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "hubert-xlarge": "hubert_xlarge",
    "yi-6b": "yi_6b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "qwen2-7b": "qwen2_7b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "deepseek-67b": "deepseek_67b",
    "pixtral-12b": "pixtral_12b",
    "zamba2-7b": "zamba2_7b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch]}")
    return mod.CONFIG


def list_archs() -> list[str]:
    return sorted(ARCH_MODULES)


__all__ = ["get_config", "list_archs", "ModelConfig", "ShapeConfig",
           "INPUT_SHAPES", "shape_applicable", "ARCH_MODULES"]
