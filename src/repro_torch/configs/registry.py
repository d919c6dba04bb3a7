"""Architecture registry of the port: ``--arch <id>`` -> ModelConfig.

The port's copy of ``repro/configs/registry.py`` without the per-cell
``input_specs`` (those come with the cells, ROADMAP Queue 1 #11 step 6).
It registers the archs whose family the port runs: dense, vlm and moe
(Arctic, DeepSeek-V3).  The JAX package's other archs are known by
name, and asking for one raises ``NotImplementedError`` naming the
ROADMAP item that ports its family.
"""
from __future__ import annotations

from typing import Dict

from .base import ModelConfig, reduced
from . import (command_r_plus_104b, yi_9b, qwen2_5_3b, gemma2_9b,
               chameleon_34b, arctic_480b, deepseek_v3_671b)

__all__ = ["ARCHS", "get_arch", "reduced_arch"]

#: the families ``repro_torch.models`` runs
PORTED_FAMILIES = ("dense", "vlm", "moe")

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in [
        command_r_plus_104b.CONFIG,
        yi_9b.CONFIG,
        qwen2_5_3b.CONFIG,
        gemma2_9b.CONFIG,
        chameleon_34b.CONFIG,
        arctic_480b.CONFIG,
        deepseek_v3_671b.CONFIG,
    ]
}

# the JAX package's other archs, by family
NOT_PORTED = {
    "zamba2-2.7b": "hybrid",
    "mamba2-2.7b": "ssm",
    "whisper-small": "audio",
}


def not_ported(family: str) -> NotImplementedError:
    return NotImplementedError(
        f"the {family} family is not ported yet: ROADMAP.md Queue 1 #11 "
        f"(training and model side); the port runs {PORTED_FAMILIES}")


def get_arch(name: str) -> ModelConfig:
    if name in NOT_PORTED:
        raise not_ported(NOT_PORTED[name])
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_arch(name: str, **overrides) -> ModelConfig:
    return reduced(get_arch(name), **overrides)
