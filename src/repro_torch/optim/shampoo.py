"""Blocked Shampoo with ATA-powered gram statistics.

The port of ``repro/optim/shampoo.py``: the preconditioner statistics of
every 2-D gradient block are the paper's operation,

    L = G G^t = ATA(G^t),    R = G^t G = ATA(G),

computed through the port's Gram service path
(:func:`repro_torch.gram.batched_gram`): on the card one batched launch
of ``csrc/leaf_products.cuh`` over the whole stack of blocks (the port of
``jax.vmap`` over the fused kernel), on the CPU the reference recursion
block by block, as the JAX package runs it off the TPU; ``ata_mode=``
forces either.

Structure (after Anil et al.'s distributed Shampoo), as in the JAX
package:
  * large dims are partitioned into blocks of <= block_size; each
    sub-block is preconditioned independently (block-diagonal Shampoo);
  * the layer stack is a batch dimension: where the JAX package stacks
    each layer's weights on a leading L axis, the port keeps a list of
    per-layer dicts, and the optimizer groups one path's tensor in every
    layer (``tree.layer_groups``) into one stack of K = L * nbm * nbn
    blocks, layer outermost.  So a statistics step makes two batched
    launches a preconditioned path, not 2 L, and the state holds the
    JAX package's stacked layout (``state["gram"]``), which converts one
    to one.  As there, a per-layer vector (a norm scale, a bias) stacks
    into an (L, d) matrix, which is preconditioned when L >= 2;
  * inverse 4th roots by ``torch.linalg.eigh``, recomputed every
    ``precond_interval`` steps, the statistics every ``stat_interval``
    (Python branches on the step where the JAX package uses
    ``lax.cond``);
  * Adam grafting: the Shampoo direction is rescaled to the Adam
    update's norm over the whole stacked leaf; 1-D parameters and
    leaves with more than ``max_blocks`` blocks a side fall back to
    AdamW.

The moments and the statistics are updated in place (the trainer
donates its state, as ``adamw`` explains).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.strassen import ieee_fp32
from ..gram.engine import batched_gram
from .adamw import (Optimizer, adam_moments, bias_corrections, fp32_grads)
from .tree import layer_groups, leaves, unflatten

_F32 = torch.float32


def _plan(shape, block_size, max_blocks):
    """Static per-leaf plan: (nbm, bsm, nbn, bsn) for a preconditioned
    trailing 2-D, or None for Adam."""
    if len(shape) < 2 or shape[-1] < 2 or shape[-2] < 2:
        return None
    m, n = shape[-2], shape[-1]
    bsm, bsn = min(block_size, m), min(block_size, n)
    nbm, nbn = -(-m // bsm), -(-n // bsn)
    if nbm > max_blocks or nbn > max_blocks:
        return None
    return (nbm, bsm, nbn, bsn)


def _to_blocks(g, plan):
    """(..., M, N) -> (K, bsm, bsn) with K = prod(batch)*nbm*nbn."""
    nbm, bsm, nbn, bsn = plan
    batch = g.shape[:-2]
    m, n = g.shape[-2:]
    g = F.pad(g, (0, nbn * bsn - n, 0, nbm * bsm - m))
    g = g.reshape(*batch, nbm, bsm, nbn, bsn)
    g = g.movedim(-2, -3)                          # (..., nbm, nbn, bsm, bsn)
    return g.reshape(-1, bsm, bsn)


def _from_blocks(blocks, plan, shape):
    nbm, bsm, nbn, bsn = plan
    batch = shape[:-2]
    m, n = shape[-2:]
    g = blocks.reshape(*batch, nbm, nbn, bsm, bsn)
    g = g.movedim(-2, -3).reshape(*batch, nbm * bsm, nbn * bsn)
    return g[..., :m, :n]


def _inv_4th_root(s, eps):
    """(K, bs, bs) symmetric PSD -> (s/trace_norm + eps I)^{-1/4} via
    eigh, block by block."""
    bs = s.shape[-1]
    with ieee_fp32():
        # normalize for conditioning; the grafting rescale absorbs it
        tr = torch.diagonal(s, dim1=-2, dim2=-1).sum(-1) / bs
        s = s / torch.clamp(tr, min=1e-30)[..., None, None]
        eye = torch.eye(bs, dtype=s.dtype, device=s.device)
        w, u = torch.linalg.eigh(s + eps * eye)
        w = torch.clamp(w, min=eps)
        return (u * (w ** -0.25)[..., None, :]) @ u.mT


def _stacked_shape(group):
    """A group of :func:`~repro_torch.optim.tree.layer_groups` as the JAX
    package's stacked array's shape: a layer list on a leading L axis."""
    if isinstance(group, list):
        return (len(group), *group[0].shape)
    return tuple(group.shape)


def _set_path(tree: dict, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _get_path(tree: dict, path):
    for key in path:
        tree = tree[key]
    return tree


def shampoo(lr, *, block_size: int = 1024, stat_interval: int = 1,
            precond_interval: int = 20, beta2_stat: float = 1.0,
            b1=0.9, b2=0.95, eps=1e-8, matrix_eps=1e-6,
            weight_decay=0.1, grad_clip: Optional[float] = 1.0,
            ata_levels: int = 1, ata_leaf: int = 128,
            max_blocks: int = 64,
            ata_variant: str = "strassen",
            ata_mode: str = "auto",
            ata_block: Optional[int] = None) -> Optimizer:
    """ATA-powered blocked Shampoo with Adam grafting.

    ``ata_mode`` ("auto" | "fused" | "reference") and ``ata_block`` are
    threaded to the batched Gram path: "auto" runs one batched launch of
    the fused kernel on the card and the reference recursion on the CPU;
    ``ata_block=None`` consults the gram autotune cache for the tile
    size.  ``ata_leaf`` (128) is passed through: the port's own default
    leaf is 256.
    """
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def gram(blocks):
        return batched_gram(blocks, levels=ata_levels, leaf=ata_leaf,
                            variant=ata_variant, mode=ata_mode,
                            block=ata_block, out_dtype=_F32,
                            device=blocks.device)

    def init(params):
        f32 = lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device)
        gram_state: dict = {}
        for path, group in layer_groups(params):
            dev = (group[0] if isinstance(group, list) else group).device
            shape = _stacked_shape(group)
            plan = _plan(shape, block_size, max_blocks)
            if plan is None:
                empty = lambda: torch.zeros((0,), dtype=_F32, device=dev)
                st = {"l": empty(), "r": empty(), "pl": empty(),
                      "pr": empty()}
            else:
                nbm, bsm, nbn, bsn = plan
                k = math.prod(shape[:-2] or (1,)) * nbm * nbn
                eye = lambda bs: torch.eye(bs, dtype=_F32, device=dev) \
                    .expand(k, bs, bs).clone()
                st = {"l": torch.zeros((k, bsm, bsm), dtype=_F32, device=dev),
                      "r": torch.zeros((k, bsn, bsn), dtype=_F32, device=dev),
                      "pl": eye(bsm), "pr": eye(bsn)}
            _set_path(gram_state, path, st)
        zeros = [f32(p) for p in leaves(params)]
        return {"m": unflatten(params, zeros),
                "v": unflatten(params, [f32(p) for p in leaves(params)]),
                "gram": gram_state}

    @torch.no_grad()
    def update(grads, state, params, step):
        step = int(step)
        grad, gnorm = fp32_grads(grads, grad_clip)
        bc1, bc2 = (float(x) for x in bias_corrections(b1, b2, step))
        lr_t = float(lr_fn(step))
        do_stat = step % stat_interval == 0
        do_precond = step % precond_interval == 0

        flat_p = leaves(params)
        flat_m, flat_v = leaves(state["m"]), leaves(state["v"])
        index = {id(p): i for i, p in enumerate(flat_p)}
        updates = [None] * len(flat_p)
        for path, group in layer_groups(params):
            ps = group if isinstance(group, list) else [group]
            idx = [index[id(p)] for p in ps]
            gs = [grad(i) for i in idx]
            for i, g in zip(idx, gs):
                adam_moments(flat_m[i], flat_v[i], g, b1, b2)
            # Adam (the grafting reference and the fallback)
            u_adam = [flat_m[i] / bc1 / (torch.sqrt(flat_v[i] / bc2) + eps)
                      for i in idx]
            shape = _stacked_shape(group)
            plan = _plan(shape, block_size, max_blocks)
            if plan is None:
                us = u_adam
            else:
                gr = _get_path(state["gram"], path)
                us = _precondition(gr, plan, shape, gs, [
                    flat_m[i] / bc1 for i in idx], u_adam,
                    layered=isinstance(group, list), do_stat=do_stat,
                    do_precond=do_precond)
            for i, p, u in zip(idx, ps, us):
                u = u + weight_decay * p.detach().float()
                updates[i] = -lr_t * u
        return unflatten(params, updates), state, {"grad_norm": gnorm}

    def _precondition(gr, plan, shape, gs, mhs, u_adam, *, layered,
                      do_stat, do_precond):
        """The grafted Shampoo direction of one stacked leaf, a tensor a
        layer (``layered``) or one; its statistics (and, on a
        precondition step, their roots) updated in ``gr`` in place."""
        stack = (lambda xs: torch.stack(xs)) if layered else \
            (lambda xs: xs[0])
        if do_stat:
            # THE paper's operation: the blocks' grams through the batched
            # Strassen-ATA service path, one launch a side
            blk = _to_blocks(stack(gs), plan)
            l_new = gram(blk.mT)
            r_new = gram(blk)
            del blk
            if beta2_stat >= 1.0:
                gr["l"].add_(l_new)
                gr["r"].add_(r_new)
            else:
                gr["l"].copy_(beta2_stat * gr["l"] + (1 - beta2_stat) * l_new)
                gr["r"].copy_(beta2_stat * gr["r"] + (1 - beta2_stat) * r_new)
        if do_precond:
            gr["pl"].copy_(_inv_4th_root(gr["l"], matrix_eps))
            gr["pr"].copy_(_inv_4th_root(gr["r"], matrix_eps))
        # precondition blocks of the *momentum* (common practice)
        with ieee_fp32():
            ublk = gr["pl"] @ _to_blocks(stack(mhs), plan) @ gr["pr"]
        u_sh = _from_blocks(ublk, plan, shape)
        del ublk
        # Adam grafting: the Shampoo direction at the Adam update's norm,
        # over the whole stacked leaf
        norm_adam = torch.sqrt(sum(u.square().sum() for u in u_adam))
        ratio = norm_adam / torch.clamp(torch.linalg.vector_norm(u_sh),
                                        min=1e-16)
        u = u_sh * ratio
        return list(u.unbind(0)) if layered else [u]

    return Optimizer(init, update)
