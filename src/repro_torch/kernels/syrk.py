"""SYRK of the port: the packed lower-triangular tiles of ``A^t A``.

The port of ``repro/kernels/syrk.py``.  :func:`syrk_packed` returns the
stack of the ``T(T+1)/2`` lower-triangular ``(bn, bn)`` tiles, row-major
over the triangle (the layout of ``core/symmetry.pack_tril_blocks``),
diagonal tiles stored whole; upper tiles are never computed.  On a CUDA
tensor it launches ``csrc/syrk.cu`` or raises: a bf16 or fp16 A on the
tensor cores (wgmma, an fp32 accumulator over K), an fp32 A by fp32 FMA
on the CUDA cores (no TF32), as ``_launch.product_core`` says; on a CPU
tensor it runs :func:`_syrk_packed_plain`, which walks the kernel's grid
in torch.
Forward-only, as the JAX kernel: an input that requires grad is refused.
The kernel's block tile (128 or 64) is chosen per launch by
:func:`syrk_launch_shape`.
"""
from __future__ import annotations

import functools

import torch

from ..core.strassen import ieee_fp32
from . import _launch
from ._launch import INT, LONG, PTR

__all__ = ["syrk_packed", "syrk_launch_shape"]

_ARGTYPES = (PTR, PTR, LONG, LONG) + (INT,) * 5


@functools.cache
def _blocks_per_sm(a_dtype, out_dtype, tile: int) -> int:
    codes = _launch.DTYPE_CODES
    got = _launch.entry("syrk", "syrk_blocks_per_sm", (INT,) * 3)(
        codes[a_dtype], codes[out_dtype], tile)
    if got < 0:
        raise RuntimeError(f"syrk: occupancy query failed at tile {tile}")
    return got


def _grid(n: int, bn: int, blocks_per_sm: dict, sms: int,
          tile: int | None = None, *, core: str) -> dict:
    """The launch's grid on an (M, n) A on ``core`` for given blocks an
    SM: the pure arithmetic of :func:`syrk_launch_shape`, over the
    T(T+1)/2 packed tiles, T = n / bn."""
    t_blocks = n // bn
    return _launch.product_grid(t_blocks * (t_blocks + 1) // 2, bn, bn,
                                blocks_per_sm, sms, tile, core=core)


def syrk_launch_shape(n: int, *, bn: int, a_dtype, out_dtype,
                      tile: int | None = None, device=None) -> dict:
    """How a ``csrc/syrk.cu`` launch on an (M, n) A fills the card: the
    core A's type runs on (``_launch.product_core``), its block tile (by
    default the one the wrapper picks), sub-tiles a packed tile, packed
    tiles (T(T+1)/2, T = n / bn), thread blocks, blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), waves on the
    card's SMs and shared memory a block (``_launch.product_grid``)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    core = _launch.product_core(a_dtype, a_dtype)
    per_sm = {t: _blocks_per_sm(a_dtype, out_dtype, t)
              for t in _launch.PRODUCT_TILES}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    shape = _grid(n, bn, per_sm, sms, tile, core=core)
    smem = _launch.entry("syrk", "syrk_smem_bytes", (INT,) * 2)
    return {**shape, "smem_bytes": smem(_launch.DTYPE_CODES[a_dtype],
                                        shape["tile"])}


def _tri_decode(t):
    """Linear lower-triangular index -> (i, j), i >= j, row-major.

    A float64 root estimate with the integer correction of the JAX
    package's ``syrk._tri_decode`` (at most one step either way), on an
    int or an integer tensor; the kernel decodes its grid index alike.
    """
    t = torch.as_tensor(t, dtype=torch.int64)
    i = ((torch.sqrt(8.0 * t.double() + 1.0) - 1.0) * 0.5).long()
    i = torch.where((i + 1) * (i + 2) // 2 <= t, i + 1, i)
    i = torch.where(i * (i + 1) // 2 > t, i - 1, i)
    return i, t - i * (i + 1) // 2


def _grouped_packed_tile(index: int, t_blocks: int, bn: int, tile: int):
    """Block ``index`` (in launch order) of a tensor-core syrk launch over
    T = ``t_blocks`` tile rows, as ``grouped_packed_tile`` in
    ``csrc/syrk.cu`` decodes it: its packed tile (i, j), i >= j, and the
    index of its sub-tile (``_launch.sub_tile``).  A packed tile's
    sub-tiles run together, and the packed tiles are walked
    ``max(1, RASTER // ceil(bn / tile))`` tile rows at a time, column by
    column."""
    n_sub = -(-bn // tile)
    p, sub = divmod(index, n_sub * n_sub)
    g = max(1, _launch.RASTER // n_sub)
    row = int(_tri_decode(p)[0])
    first = row // g * g
    rows = min(g, t_blocks - first)
    w = p - first * (first + 1) // 2
    if w < first * rows:
        return first + w % rows, w // rows, sub
    w -= first * rows
    c = 0
    while w >= rows - c:
        w -= rows - c
        c += 1
    return first + c + w, first + c, sub


def _syrk_packed_plain(a: torch.Tensor, bn: int,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel's grid walked in torch: tile t = (i, j) of the stack is
    ``A[:, i-block]^t A[:, j-block]`` in fp32."""
    m, n = a.shape
    t_blocks = n // bn
    cols = a.float().reshape(m, t_blocks, bn)
    ii, jj = _tri_decode(torch.arange(t_blocks * (t_blocks + 1) // 2))
    with ieee_fp32():
        tiles = [cols[:, i].T @ cols[:, j]
                 for i, j in zip(ii.tolist(), jj.tolist())]
    return torch.cat(tiles).to(out_dtype)


def syrk_packed(a: torch.Tensor, *, bk: int = 256, bn: int = 256,
                out_dtype=None, tile: int | None = None) -> torch.Tensor:
    """Packed lower-triangular block stack of ``a.T @ a``.

    ``a``: (M, N) with M % bk == 0, N % bn == 0 (``ops.syrk`` pads), fp32,
    bf16 or fp16.  Returns (T(T+1)/2 * bn, bn) with T = N // bn, in
    ``out_dtype`` (default ``a.dtype``).  ``tile``: the kernel's block
    tile, one of ``_launch.PRODUCT_TILES``, by default
    :func:`syrk_launch_shape`'s; no tile changes a bit.
    """
    _launch.refuse_grad("syrk", a)
    _launch.check_blocks("syrk", bk=bk, bn=bn)
    _launch.check_tile("syrk", tile)
    _launch.check_dtype("syrk", "a", a.dtype)
    out_dtype = a.dtype if out_dtype is None else out_dtype
    _launch.check_dtype("syrk", "the output", out_dtype)
    if a.ndim != 2 or min(a.shape) < 1 or a.shape[0] % bk or a.shape[1] % bn:
        raise ValueError(f"syrk_packed takes a non-empty (M, N) padded to "
                         f"the blocks, got {tuple(a.shape)} with bk={bk}, "
                         f"bn={bn} (ops.syrk pads)")
    m, n = a.shape
    device = _launch.device_of("syrk", a)
    if device.type == "cpu":
        return _syrk_packed_plain(a, bn, out_dtype)
    _launch.check_pointer("syrk", "a", a)
    tile = syrk_launch_shape(n, bn=bn, a_dtype=a.dtype, out_dtype=out_dtype,
                             tile=tile, device=device)["tile"]
    t_blocks = n // bn
    out = torch.empty((t_blocks * (t_blocks + 1) // 2 * bn, bn),
                      dtype=out_dtype, device=device)
    codes = _launch.DTYPE_CODES
    _launch.launch("syrk", _ARGTYPES, a.data_ptr(), out.data_ptr(), m, n, bk,
                   bn, codes[a.dtype], codes[out_dtype], tile, device=device)
    return out
