"""Packed lower-triangular storage, in torch.

The port of ``repro/core/symmetry.py``.  The layout is the JAX
package's, unchanged: a stack of ``T(T+1)/2`` blocks of shape
``(bn, bn)``, row-major over the lower triangle ((i, j) with i >= j, i
major), tile ``t`` at rows ``[t*bn, (t+1)*bn)``.  Every function also
accepts a numpy array, so a stack written by the JAX package loads
as it is.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["tri_count", "tri_index", "tri_coords", "pack_tril_blocks",
           "unpack_tril_blocks", "tril_vector_from_blocks",
           "symmetrize_from_lower"]


def _as_tensor(x) -> torch.Tensor:
    """torch.Tensor as it is; a numpy array (including the bfloat16
    arrays JAX hands out, which torch cannot read directly) as a tensor."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.array(x)            # a copy: arrays from JAX are read-only
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def tri_count(t: int) -> int:
    return t * (t + 1) // 2


def tri_index(i: int, j: int) -> int:
    """Linear index of lower-triangular block (i, j), i >= j."""
    if j > i:
        raise ValueError(f"upper-triangular block ({i},{j}) is never stored")
    return i * (i + 1) // 2 + j


def tri_coords(t: int) -> torch.Tensor:
    """(tri_count(t), 2) int32 tensor of (i, j) for linear indices 0.. ."""
    rows, cols = torch.tril_indices(t, t)
    return torch.stack([rows, cols], dim=1).to(torch.int32)


def pack_tril_blocks(c, bn: int) -> torch.Tensor:
    """Dense (n, n) with n % bn == 0 -> (tri_count(t)*bn, bn) block stack."""
    c = _as_tensor(c)
    n = c.shape[0]
    if n % bn:
        raise ValueError(f"n={n} not divisible by block {bn}")
    t = n // bn
    ij = tri_coords(t).long()
    tiles = c.reshape(t, bn, t, bn).permute(0, 2, 1, 3)
    return tiles[ij[:, 0], ij[:, 1]].reshape(-1, bn)


def unpack_tril_blocks(packed, n: int, bn: int,
                       *, symmetrize: bool = True) -> torch.Tensor:
    """Inverse of :func:`pack_tril_blocks`."""
    packed = _as_tensor(packed)
    t = n // bn
    ij = tri_coords(t).long().to(packed.device)
    tiles = torch.zeros((t, t, bn, bn), dtype=packed.dtype,
                        device=packed.device)
    tiles[ij[:, 0], ij[:, 1]] = packed.reshape(-1, bn, bn)
    c = tiles.permute(0, 2, 1, 3).reshape(n, n)
    if symmetrize:
        # Diagonal blocks carry their own (symmetric) upper halves — drop
        # them before mirroring so they are not double-counted.
        c = torch.tril(c)
        c = c + torch.tril(c, -1).T
    return c


def tril_vector_from_blocks(packed, bn: int, n: int) -> torch.Tensor:
    """Element-packed tril vector (n(n+1)/2,) straight from a packed
    lower-triangular *block* stack ((tri_count(T)*bn, bn) over a padded
    T*bn >= n grid) — one gather, the dense (n, n) never materializes."""
    packed = _as_tensor(packed)
    rows, cols = np.tril_indices(n)
    bi, bj = rows // bn, cols // bn
    blk = bi * (bi + 1) // 2 + bj
    gr = torch.from_numpy(blk * bn + rows % bn).to(packed.device)
    gc = torch.from_numpy(cols % bn).to(packed.device)
    return packed[gr, gc]


def symmetrize_from_lower(c_lower) -> torch.Tensor:
    """Mirror the strict lower triangle to the upper half (C12 = C21^t)."""
    c_lower = _as_tensor(c_lower)
    return torch.tril(c_lower) + torch.tril(c_lower, -1).T
