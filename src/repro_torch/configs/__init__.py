"""Architecture registry of the port: ``--arch <id>`` selects one of these.

All ten of the reference's archs are registered: the dense qwen3-0.6b,
smollm-360m, phi4-mini-3.8b and phi3-medium-14b (plain ``("attn",)``
decoders), the hybrid recurrentgemma-9b, the MoE archs
granite-moe-3b-a800m and qwen3-moe-235b-a22b (``("attn_moe",)``
decoders), xlstm-350m (``("mlstm", "slstm")`` blocks, no KV cache),
whisper-medium (an encoder of ``("enc_attn",)`` blocks and a decoder of
``("attn_cross",)`` blocks) and qwen2-vl-7b (an ``("attn",)`` decoder
with M-RoPE). ``SHAPES``, ``all_configs`` and ``shape_applicable``
mirror the reference's registry (held to it by
``tests/test_torch_archs.py``); no launcher of the port reads them yet,
a benchmark of the port will.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import InputShape, ModelConfig, MoEConfig, WGKVConfig
from repro_torch.configs.shapes import SHAPES, get_shape

_ARCH_MODULES = {
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
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


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Is (arch x shape) a runnable pair? Returns (ok, reason-if-not)."""
    if shape.name == "long_500k":
        if cfg.arch_type == "audio":
            return False, (
                "long_500k skipped for whisper-medium: 500k mel frames is far "
                "beyond the enc-dec design (DESIGN.md §4)"
            )
        if cfg.arch_type in ("ssm", "hybrid"):
            return True, ""  # native sub-quadratic state
        # attention archs: runnable only via the WG-KV budgeted cache
        if cfg.wgkv.enabled:
            return True, ""
        return False, "long_500k needs sub-quadratic attention (enable WG-KV)"
    return True, ""


__all__ = [
    "ARCH_NAMES",
    "InputShape",
    "ModelConfig",
    "MoEConfig",
    "SHAPES",
    "WGKVConfig",
    "all_configs",
    "get_config",
    "get_reduced_config",
    "get_shape",
    "shape_applicable",
]
