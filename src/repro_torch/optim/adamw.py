"""AdamW (decoupled weight decay), functional, tree-generic.

The port of ``repro/optim/adamw.py``, with its API:

    opt = adamw(lr)
    state = opt.init(params)
    updates, state, metrics = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)

Moments are stored in fp32 regardless of the parameters' type (bf16
moments lose too many bits at lr ~ 1e-4); ``moment_dtype`` trades
precision for memory.  The bias corrections are computed in fp32 from
the step, as ``jnp`` computes them (``b1 ** t`` in Python's float64
differs in the last bits).

Where the JAX trainer donates its state to the jitted step, ``update``
writes the new moments into the state's tensors in place (the same
numbers) and returns that state: a full-depth model cannot hold a
second copy of its moments beside the first.  The gradients are cast
to fp32 and clipped one leaf at a time, never as a whole second tree.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .tree import leaves, tree_map, unflatten

_F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable
    update: Callable    # (grads, state, params, step) -> (updates, state, metrics)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32."""
    return torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor ``clip_by_global_norm`` multiplies every leaf by."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm):
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


def apply_updates(params, updates, *, in_place: bool = False):
    """``(p.float() + u).to(p.dtype)`` for every leaf; ``in_place``
    writes it into the parameters' tensors (a donated state)."""
    def one(p, u):
        new = (p.detach().float() + u).to(p.dtype)
        if not in_place:
            return new
        with torch.no_grad():
            p.copy_(new)
        return p
    return tree_map(one, params, updates)


def bias_corrections(b1: float, b2: float, step):
    """(1 - b1^t, 1 - b2^t) for t = step + 1, in fp32 (0-d CPU tensors)."""
    t = torch.tensor(int(step) + 1, dtype=_F32)
    return (1.0 - torch.tensor(b1, dtype=_F32) ** t,
            1.0 - torch.tensor(b2, dtype=_F32) ** t)


def fp32_grads(grads, grad_clip: Optional[float]):
    """(a function giving leaf i's fp32, clipped gradient, the global
    norm): ``clip_by_global_norm``'s numbers, one leaf at a time."""
    flat = leaves(grads)
    norm = global_norm(flat)
    if not grad_clip:
        return (lambda i: flat[i].float()), norm
    scale = clip_scale(norm, grad_clip)
    return (lambda i: flat[i].float() * scale), norm


def adam_moments(m, v, g, b1, b2, moment_dtype=_F32):
    """The new moments, written into ``m`` and ``v``:
    ``b1 m + (1 - b1) g`` and ``b2 v + (1 - b2) g^2``."""
    m.copy_((b1 * m.float() + (1 - b1) * g).to(moment_dtype))
    v.copy_((b2 * v.float() + (1 - b2) * g * g).to(moment_dtype))
    return m, v


def adamw(lr: Callable | float, *, b1=0.9, b2=0.95, eps=1e-8,
          weight_decay=0.1, grad_clip: Optional[float] = 1.0,
          moment_dtype=_F32) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                      device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        grad, gnorm = fp32_grads(grads, grad_clip)
        bc1, bc2 = (float(x) for x in bias_corrections(b1, b2, step))
        lr_t = float(lr_fn(step))
        flat_m, flat_v = leaves(state["m"]), leaves(state["v"])

        def upd(i, p):
            m, v = adam_moments(flat_m[i], flat_v[i], grad(i), b1, b2,
                                moment_dtype)
            mh = m.float() / bc1
            vh = v.float() / bc2
            u = mh / (torch.sqrt(vh) + eps)
            u = u + weight_decay * p.detach().float()
            return -lr_t * u

        updates = unflatten(params, [upd(i, p) for i, p in
                                     enumerate(leaves(params))])
        return updates, state, {"grad_norm": gnorm}

    return Optimizer(init, update)

