"""Config registry: one module per assigned architecture (+ smoke variants).

Counterpart of ``repro/configs/base.py``; each arch module is copied.

Each arch module defines ``FULL`` (the exact assigned config) and ``SMOKE``
(a reduced same-family config for CPU tests).  ``long_500k`` applicability
follows DESIGN.md §Arch-applicability (SSM/hybrid only).
"""
from __future__ import annotations

import importlib

from ..models.config import SHAPES, ModelConfig, Shape

ARCH_NAMES = [
    "moonshot-v1-16b-a3b",
    "granite-moe-3b-a800m",
    "qwen1.5-32b",
    "qwen3-1.7b",
    "granite-8b",
    "qwen2.5-3b",
    "whisper-base",
    "mamba2-130m",
    "pixtral-12b",
    "zamba2-2.7b",
]


def _module(name: str):
    mod = name.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in ARCH_NAMES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    m = _module(name)
    return m.SMOKE if smoke else m.FULL


def shape_applicable(cfg: ModelConfig, shape: Shape) -> bool:
    """long_500k needs sub-quadratic context state: SSM/hybrid only."""
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True


def cells(smoke: bool = False):
    """All (arch, shape) dry-run cells, with applicability flags."""
    out = []
    for name in ARCH_NAMES:
        cfg = get_config(name, smoke=smoke)
        for shape in SHAPES.values():
            out.append((name, cfg, shape, shape_applicable(cfg, shape)))
    return out
