"""Learning-rate schedules (callables of the integer step).

The port of ``repro/optim/schedules.py``: each returns a 0-d fp32 CPU
tensor computed in fp32, as ``jnp`` computes it from an int32 step.
"""
from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).detach().to("cpu", _F32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=_F32)


def warmup_linear(lr: float, warmup: int, total: int, floor: float = 0.0):
    def fn(step):
        s = _step(step)
        warm = lr * torch.clamp((s + 1) / max(warmup, 1), max=1.0)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return torch.where(s < warmup, warm, lr + (floor - lr) * frac)
    return fn


def warmup_cosine(lr: float, warmup: int, total: int, floor_ratio=0.1):
    floor = lr * floor_ratio

    def fn(step):
        s = _step(step)
        warm = lr * torch.clamp((s + 1) / max(warmup, 1), max=1.0)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (lr - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(s < warmup, warm, cos)
    return fn
