"""Architecture registry of the port: ``--arch <id>`` -> ModelConfig.

The port's copy of ``repro/configs/registry.py`` without the per-cell
``input_specs`` (those come with the cells, ROADMAP Queue 1 #11 step 6).
It registers the JAX package's ten archs, of all six families.
"""
from __future__ import annotations

from typing import Dict

from .base import ModelConfig, reduced
from . import (zamba2_2_7b, command_r_plus_104b, yi_9b, qwen2_5_3b,
               gemma2_9b, mamba2_2_7b, deepseek_v3_671b, arctic_480b,
               chameleon_34b, whisper_small)

__all__ = ["ARCHS", "get_arch", "reduced_arch"]

#: the families ``repro_torch.models`` runs: every family of the JAX package
PORTED_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in [
        zamba2_2_7b.CONFIG,
        command_r_plus_104b.CONFIG,
        yi_9b.CONFIG,
        qwen2_5_3b.CONFIG,
        gemma2_9b.CONFIG,
        mamba2_2_7b.CONFIG,
        deepseek_v3_671b.CONFIG,
        arctic_480b.CONFIG,
        chameleon_34b.CONFIG,
        whisper_small.CONFIG,
    ]
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_arch(name: str, **overrides) -> ModelConfig:
    return reduced(get_arch(name), **overrides)
