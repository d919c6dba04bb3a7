"""Error-feedback gradient compression for a cross-group all-reduce.

The port of ``repro/optim/grad_compress.py`` on ``torch.distributed``.
Two schemes, both Seide-et-al.-style error feedback (the compression
residual is kept locally and added back before the next compression, so
the *accumulated* error stays bounded):

* ``compressed_psum`` — int8: each leaf is quantized to int8 with a
  per-leaf fp32 scale, and the int8 tensors and scales are all-gathered
  (4x fewer bytes than fp32) and summed, dequantized, on every rank.
* ``lowrank_psum`` — Gram-powered low-rank (PowerSGD-flavored): for tall
  2-D leaves the ranks agree on a shared top-``rank`` right-singular
  basis Q by all-reducing the *Gram* of the gradient, ``sum_i G_i^t
  G_i``, which is ``core.distributed.gram_allreduce`` over the axis,
  then reduce only the rank-sized projection ``G_i Q``.  Leaves where
  low-rank does not pay take the int8 path.

Where the JAX functions run inside ``shard_map`` and name a mesh axis,
these take the ``DeviceMesh`` and the axis name, as the port's
distributed schemes do (``core.distributed``): NCCL for tensors on the
card, gloo for CPU ones, never staged through the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..core.ata import ata_full
from ..core.distributed import _group, gram_allreduce
from ..core.strassen import ieee_fp32
from .tree import leaves, tree_map, unflatten

_F32 = torch.float32


class ErrorFeedback(NamedTuple):
    residual: object            # tree matching grads, fp32

    @staticmethod
    def init(grads_like):
        return ErrorFeedback(tree_map(
            lambda g: torch.zeros(g.shape, dtype=_F32, device=g.device),
            grads_like))


def int8_quantize(x: torch.Tensor):
    """fp -> (int8 values, fp32 scale).  Symmetric per-tensor
    quantization; ``torch.round`` rounds half to even, as ``jnp.round``."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax() / 127.0, min=1e-30)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` along the group, in group-rank
    order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


def _int8_leaf(g, r, group, n):
    """One leaf of the int8 error-feedback reduction: (mean grad,
    residual).  The wire carries the int8 tensor and one fp32 scale a
    rank, summed dequantized (scales differ per rank, so a plain sum of
    int8 would be wrong)."""
    gf = g.float() + r
    q, scale = int8_quantize(gf)
    new_r = gf - int8_dequantize(q, scale)           # residual stays local
    qg = _all_gather(q, group)                       # (n, ...) int8
    sg = _all_gather(scale.reshape(1), group)[:, 0]  # (n,) fp32
    total = torch.einsum("n,n...->...", sg, qg.float())
    return total / n, new_r


def compressed_psum(grads, mesh, ef: ErrorFeedback, *, axis: str = "data"):
    """Error-feedback int8 all-reduce over the mesh's ``axis``.  Returns
    (mean-reduced fp32 grads, new ErrorFeedback)."""
    flat_g, flat_r = leaves(grads), leaves(ef.residual)
    outs = []
    for g, r in zip(flat_g, flat_r):
        group = _group(mesh, axis, g)
        outs.append(_int8_leaf(g, r, group, dist.get_world_size(group)))
    return (unflatten(grads, [o[0] for o in outs]),
            ErrorFeedback(unflatten(grads, [o[1] for o in outs])))


def lowrank_basis(g2d: torch.Tensor, rank: int, *, levels=1,
                  leaf: int = 256, mode: str = "auto", mesh=None,
                  axis: str = "data") -> torch.Tensor:
    """Shared top-``rank`` right-singular basis of a (stacked) gradient.

    The basis is the top eigenvectors of the Gram ``sum_i G_i^t G_i`` —
    THE paper's operation, computed through the ATA pipeline: locally via
    ``core.ata.ata_full`` (no ``mesh``), or via
    ``core.distributed.gram_allreduce`` over the mesh's ``axis`` so every
    rank derives the *same* basis from the stacked-gradient Gram.
    """
    g = g2d.float()
    if mesh is None:
        c = ata_full(g, levels=levels, leaf=leaf, mode=mode, out_dtype=_F32,
                     device=g.device)
    else:
        c = gram_allreduce(g, mesh, axis, levels=levels, leaf=leaf,
                           mode=mode, out_dtype=_F32)
    _, v = torch.linalg.eigh(c)                # ascending eigenvalues
    return v[:, -rank:]                        # (n, rank), orthonormal


def lowrank_psum(grads, mesh, ef: ErrorFeedback, *, axis: str = "data",
                 rank: int = 8, levels=1, leaf: int = 256,
                 mode: str = "auto", min_rows: int = 0):
    """Gram-powered low-rank error-feedback all-reduce (module docstring).

    2-D leaves with ``m > max(min_rows, n + rank)`` (where low-rank beats
    shipping the leaf) are reduced as ``mean(G) Q Q^t`` with the shared
    basis Q from :func:`lowrank_basis`; everything else takes the int8
    path.  Returns (mean-reduced fp32 grads, new ErrorFeedback).
    """
    def leaf_fn(g, r):
        group = _group(mesh, axis, g)
        n_dev = dist.get_world_size(group)
        m_n = g.shape
        if len(m_n) != 2 or m_n[0] <= max(min_rows, m_n[1] + rank) \
                or m_n[1] <= rank:
            return _int8_leaf(g, r, group, n_dev)
        gf = g.float() + r
        q = lowrank_basis(gf, rank, levels=levels, leaf=leaf, mode=mode,
                          mesh=mesh, axis=axis)
        with ieee_fp32():
            proj = gf @ q
            p = proj.clone()
            dist.all_reduce(p, group=group)        # (m, rank) on the wire
            approx = (p / n_dev) @ q.T             # mean(G) projected on Q
            new_r = gf - proj @ q.T                # local reconstruction err
        return approx, new_r

    outs = [leaf_fn(g, r) for g, r in zip(leaves(grads),
                                          leaves(ef.residual))]
    return (unflatten(grads, [o[0] for o in outs]),
            ErrorFeedback(unflatten(grads, [o[1] for o in outs])))
