"""Carry the JAX package's parameters over to the port.

``params_from_jax(cfg, tree)`` takes the JAX parameter tree with numpy
arrays at its leaves (``jax.tree.map(np.asarray, params)``) and returns
the port's parameters: the same dicts, with each layer stack (each leaf
of ``tree["blocks"]``, of DeepSeek-V3's ``mla_dense`` and ``mla_moe``
and of Whisper's ``enc_blocks``, stacked on a leading L axis) split into
a list of per-layer dicts; a MoE layer's expert weights stay one (E, d,
f) tensor, and a block with no layer axis (the ``mtp`` head, Zamba2's
``shared_attn``) comes over as it is.  Each leaf keeps its dtype: the
SSD's fp32 ``a_log``, ``d_skip`` and ``dt_bias`` stay fp32 in a bf16
model, as there.  Both
then compute the same thing, which is how the tests hold the port to
the reference.  Every leaf of the tree is mapped
and none is left over: a missing leaf, an extra one or a shape that
differs raises ``ValueError``.  bf16 arrays (numpy's ``bfloat16`` from
ml_dtypes) are carried bit for bit.

``train_state_from_jax(cfg, state)`` carries a JAX train state over the
same way (``{"step", "params", "opt_state"}``, numpy at the leaves): the
step, the parameters, AdamW's or Shampoo's moments ``m`` and ``v`` (laid
out as the parameters) and Shampoo's statistics ``gram`` (l, r, pl, pr
a parameter path), which the port keeps in the JAX package's stacked
layout: they come over one to one.  Both packages then step on from the
same state.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..kernels.ops import resolve_device
from .model import param_spec

__all__ = ["params_from_jax", "train_state_from_jax"]


def _tensor(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def params_from_jax(cfg: ModelConfig, tree: Dict[str, Any], *,
                    device=None) -> Dict[str, Any]:
    """The port's parameters from the JAX tree, on ``device`` (the card
    unless ``device="cpu"``)."""
    dev = resolve_device(device)
    flat = dict(_leaves(tree))
    used = set()

    def build(spec, path, layer=None, layers=None):
        """``spec``'s subtree from the leaves under ``path``: a list is a
        layer stack, whose JAX leaves carry a leading axis of its
        ``layers``, and ``layer`` picks one of them."""
        if isinstance(spec, list):
            return [build(sub, path, li, len(spec))
                    for li, sub in enumerate(spec)]
        if isinstance(spec, dict):
            return {k: build(v, path + (k,), layer, layers)
                    for k, v in spec.items()}
        name = "/".join(path)
        if path not in flat:
            raise ValueError(f"the JAX tree has no leaf {name}")
        used.add(path)
        arr = flat[path]
        shape = tuple(spec) if layer is None else (layers, *spec)
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(arr.shape)}, the port "
                             f"expects {shape}")
        return _tensor(arr if layer is None else arr[layer], dev)

    out = build(param_spec(cfg), ())
    left = sorted("/".join(p) for p in set(flat) - used)
    if left:
        raise ValueError(f"leaves of the JAX tree the port does not map: "
                         f"{left}")
    return out


_STATS = ("l", "r", "pl", "pr")


def train_state_from_jax(cfg: ModelConfig, state: Dict[str, Any], *,
                         device=None) -> Dict[str, Any]:
    """The port's train state from the JAX package's, on ``device`` (the
    card unless ``device="cpu"``); the step stays a 0-d int32 CPU
    tensor, as the port's trainer keeps it."""
    from ..optim.tree import layer_groups
    dev = resolve_device(device)
    opt = state["opt_state"]
    out_opt = {k: params_from_jax(cfg, opt[k], device=dev)
               for k in ("m", "v")}
    left = sorted(set(opt) - {"m", "v", "gram"})
    if left:
        raise ValueError(f"optimizer state entries the port does not map: "
                         f"{left}")
    if "gram" in opt:
        flat = dict(_leaves(opt["gram"]))
        gram: Dict[str, Any] = {}
        want = {path + (k,) for path, _ in layer_groups(param_spec(cfg))
                for k in _STATS}
        if set(flat) != want:
            diff = sorted("/".join(p) for p in set(flat) ^ want)
            raise ValueError(f"the JAX Shampoo statistics do not match the "
                             f"port's parameters at {diff}")
        for path, arr in flat.items():
            node = gram
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = _tensor(arr, dev)
        out_opt["gram"] = gram
    step = torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32)
    return {"step": step,
            "params": params_from_jax(cfg, state["params"], device=dev),
            "opt_state": out_opt}
