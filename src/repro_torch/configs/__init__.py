"""Architecture registry of the port: ``--arch <id>`` selects one of these.

Only the archs the port serves are registered; the reference package
(``src/repro/configs``) lists the rest, which later slices bring over.
"""
from __future__ import annotations

import importlib
from typing import Tuple

from repro_torch.configs.base import InputShape, ModelConfig, MoEConfig, WGKVConfig

_ARCH_MODULES = {
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
}

ARCH_NAMES: Tuple[str, ...] = tuple(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name]).CONFIG


def get_reduced_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name]).reduced()


__all__ = [
    "ARCH_NAMES",
    "InputShape",
    "ModelConfig",
    "MoEConfig",
    "WGKVConfig",
    "get_config",
    "get_reduced_config",
]
