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

__all__ = ["tri_count", "tri_index", "tri_coords", "pack_tril",
           "unpack_tril", "pack_tril_blocks", "unpack_tril_blocks",
           "tril_vector_from_blocks", "symmetrize_from_lower"]


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


def _tril_mask(n: int, device) -> torch.Tensor:
    """(n, n) bool, True on and below the diagonal.  Boolean indexing
    walks it row-major, so its True elements come in the order of
    ``jnp.tril_indices(n)``: row i's columns 0..i, rows in turn.  n^2
    bytes, made per call (100 MB at n = 10000) where the index pair of
    ``tril_indices`` would hold n(n+1) int64 (800 MB)."""
    return torch.ones((n, n), dtype=torch.bool, device=device).tril_()


def pack_tril(c) -> torch.Tensor:
    """Dense symmetric/lower (n, n) -> packed vector of n(n+1)/2 entries,
    in ``jnp.tril_indices`` order (row-major over the lower triangle)."""
    c = _as_tensor(c)
    return c[_tril_mask(c.shape[0], c.device)]


def unpack_tril(packed, n: int, *, symmetrize: bool = True) -> torch.Tensor:
    """Packed n(n+1)/2 vector -> dense (n, n); mirrors to the upper half when
    ``symmetrize`` (C12 = C21^t, per the paper), as the JAX package's
    ``c + c.T - diag(diag(c))``.  ``packed`` is broadcast to n(n+1)/2
    entries as the JAX package's ``.at[].set`` broadcasts it: a 0-d or
    length-1 tensor fills the triangle with its value; any other shape
    but (n(n+1)/2,) raises ``ValueError``."""
    packed = _as_tensor(packed)
    count = n * (n + 1) // 2
    if packed.ndim > 1 or packed.numel() not in (1, count):
        raise ValueError(f"unpack_tril: a packed tensor of shape "
                         f"{tuple(packed.shape)} does not broadcast to "
                         f"({count},) for n={n}")
    packed = packed.reshape(-1).expand(count)
    mask = _tril_mask(n, packed.device)
    c = torch.zeros((n, n), dtype=packed.dtype,
                    device=packed.device).masked_scatter(mask, packed)
    if symmetrize:
        c = c + c.T - torch.diag(torch.diagonal(c))
    return c


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
    """Inverse of :func:`pack_tril_blocks`; leading dimensions of
    ``packed`` (a stack of packed grams) carry over to the result.

    Each tile is written once into its place in the dense result.  With
    ``symmetrize`` the result has the bits of the JAX package's mirror
    ``tril(c) + tril(c, -1).T``, tile by tile: a lower tile x + 0, its
    mirror (x + 0)^t (the mirror's 0 + x), a diagonal tile tril(x) +
    tril(x, -1)^t (the diagonal blocks' stored upper halves dropped, not
    double-counted).  The + 0 turns -0 into +0 as the mirror's adds do."""
    packed = _as_tensor(packed)
    t, lead = n // bn, packed.shape[:-2]
    # the tile coordinates made on the device: a host copy of them would
    # wait for the stream
    i, j = torch.tril_indices(t, t, device=packed.device)
    # tiles[k] is packed tile k, (i[k], j[k]), over the leading dimensions
    tiles = packed.reshape(*lead, -1, bn, bn).movedim(-3, 0)
    c = (packed.new_empty if symmetrize else packed.new_zeros)(
        (*lead, n, n))
    grid = c.view(*lead, t, bn, t, bn)   # [..., I, r, J, s]: tile (I, J)
    if symmetrize:
        tiles = tiles + 0
        grid[..., j, :, i, :] = tiles.mT
    grid[..., i, :, j, :] = tiles
    if symmetrize:
        d = torch.arange(t, device=packed.device)
        diag = tiles[d * (d + 3) // 2]   # tile (d, d) is packed tile d(d+3)/2
        grid[..., d, :, d, :] = torch.tril(diag) + torch.tril(diag, -1).mT
    return c


def _tril_gather_index(bn: int, n: int, device) -> torch.Tensor:
    """The flat offsets into a (tri_count(T)*bn, bn) stack of the lower
    triangle's elements, in ``pack_tril`` order: element (r, c), r >= c,
    lies in tile (r // bn, c // bn) at (r % bn, c % bn).  Closed form on
    ``device``: row r holds r + 1 elements, so each element's row comes
    from ``repeat_interleave`` given its output size and its column from
    the row's start (no host sync, no n^2 intermediate).  int32 where the
    offsets fit (4 bytes an element, 200 MB at n = 10000), made per call
    and freed with its result."""
    t = -(-n // bn)
    size = tri_count(n)
    itype = (torch.int32 if max(tri_count(t) * bn * bn, n * (n + 1)) < 2 ** 31
             else torch.int64)
    r = torch.repeat_interleave(
        torch.arange(1, n + 1, dtype=itype, device=device), output_size=size)
    c = torch.arange(size, dtype=itype, device=device).sub_(r * (r + 1) // 2)
    # ((tile row's first tile + tile column) * bn + r % bn) * bn + c % bn
    idx = tri_count(r // bn).add_(c // bn).mul_(bn).add_(r % bn).mul_(bn)
    return idx.add_(c % bn)


def tril_vector_from_blocks(packed, bn: int, n: int) -> torch.Tensor:
    """Element-packed tril vector (n(n+1)/2,) straight from a packed
    lower-triangular *block* stack ((tri_count(T)*bn, bn) over a padded
    T*bn >= n grid) — one gather (:func:`_tril_gather_index`), the dense
    (n, n) never materializes; its backward scatters into the stack, so
    a packed cotangent stays packed."""
    packed = _as_tensor(packed)
    idx = _tril_gather_index(bn, n, packed.device)
    return packed.reshape(-1).index_select(0, idx)


def symmetrize_from_lower(c_lower) -> torch.Tensor:
    """Mirror the strict lower triangle to the upper half (C12 = C21^t)."""
    c_lower = _as_tensor(c_lower)
    return torch.tril(c_lower) + torch.tril(c_lower, -1).T
