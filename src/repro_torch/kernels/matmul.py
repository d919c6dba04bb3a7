"""The tiled matrix product of the port, and its plain version.

The port of ``repro/kernels/matmul.py``.  :func:`matmul_padded` takes
shapes already padded to block multiples (``ops.matmul`` pads).  On a
CUDA tensor it launches ``csrc/matmul.cu`` or raises: A and B of one
16-bit type on the tensor cores (wgmma, an fp32 accumulator over K),
any other pair by fp32 FMA on the CUDA cores (no TF32; a bf16 or fp16
side widened to fp32 exactly), as ``_launch.product_core`` says; on a
CPU tensor it runs :func:`_matmul_padded_plain`.  Forward-only, as the
JAX kernel: an input that requires grad is refused.  The kernel's block
tile (128 or 64) is chosen per launch by :func:`matmul_launch_shape`.
"""
from __future__ import annotations

import functools

import torch

from ..core.strassen import ieee_fp32
from . import _launch
from ._launch import INT, LONG, PTR

__all__ = ["matmul_padded", "matmul_launch_shape"]

_ARGTYPES = (PTR, PTR, PTR, LONG, LONG, LONG) + (INT,) * 7


@functools.cache
def _blocks_per_sm(a_dtype, b_dtype, out_dtype, tile: int) -> int:
    codes = _launch.DTYPE_CODES
    got = _launch.entry("matmul", "matmul_blocks_per_sm", (INT,) * 4)(
        codes[a_dtype], codes[b_dtype], codes[out_dtype], tile)
    if got < 0:
        raise RuntimeError(f"matmul: occupancy query failed at tile {tile}")
    return got


def _grid(m: int, n: int, bm: int, bn: int, blocks_per_sm: dict, sms: int,
          tile: int | None = None, *, core: str) -> dict:
    """The launch's grid on (m, k) @ (k, n) on ``core`` for given blocks
    an SM: the pure arithmetic of :func:`matmul_launch_shape`."""
    return _launch.product_grid((m // bm) * (n // bn), bm, bn,
                                blocks_per_sm, sms, tile, core=core)


def matmul_launch_shape(m: int, n: int, *, bm: int, bn: int, a_dtype,
                        b_dtype, out_dtype, tile: int | None = None,
                        device=None) -> dict:
    """How a ``csrc/matmul.cu`` launch on (m, k) @ (k, n) fills the card:
    the core the operand types run on (``_launch.product_core``), its
    block tile (by default the one the wrapper picks), sub-tiles an output
    tile, output tiles, thread blocks, blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), waves on the
    card's SMs and shared memory a block (``_launch.product_grid``)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    core = _launch.product_core(a_dtype, b_dtype)
    per_sm = {t: _blocks_per_sm(a_dtype, b_dtype, out_dtype, t)
              for t in _launch.PRODUCT_TILES}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    shape = _grid(m, n, bm, bn, per_sm, sms, tile, core=core)
    codes = _launch.DTYPE_CODES
    smem = _launch.entry("matmul", "matmul_smem_bytes", (INT,) * 3)
    return {**shape, "smem_bytes": smem(codes[a_dtype], codes[b_dtype],
                                        shape["tile"])}


def _matmul_padded_plain(a: torch.Tensor, b: torch.Tensor,
                         out_dtype: torch.dtype) -> torch.Tensor:
    with ieee_fp32():
        return (a.float() @ b.float()).to(out_dtype)


def matmul_padded(a: torch.Tensor, b: torch.Tensor, *, bm: int = 256,
                  bk: int = 256, bn: int = 256, out_dtype=None,
                  tile: int | None = None) -> torch.Tensor:
    """``a @ b`` for shapes already padded to (bm, bk) / (bk, bn)
    multiples; fp32, bf16 or fp16 operands, each alone, the result in
    ``out_dtype`` (default ``torch.promote_types(a.dtype, b.dtype)``, as
    ``jnp.promote_types``: fp16 with bf16 gives fp32), rounded once.
    ``tile``: the kernel's block tile, one of ``_launch.PRODUCT_TILES``,
    by default :func:`matmul_launch_shape`'s; no tile changes a bit."""
    _launch.refuse_grad("matmul", a, b)
    _launch.check_blocks("matmul", bm=bm, bk=bk, bn=bn)
    _launch.check_tile("matmul", tile)
    _launch.check_dtype("matmul", "a", a.dtype)
    _launch.check_dtype("matmul", "b", b.dtype)
    out_dtype = torch.promote_types(a.dtype, b.dtype) if out_dtype is None \
        else out_dtype
    _launch.check_dtype("matmul", "the output", out_dtype)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0] \
            or min(*a.shape, b.shape[1]) < 1:
        raise ValueError(f"matmul_padded takes non-empty (m, k) and (k, n), "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    (m, k), n = a.shape, b.shape[1]
    if m % bm or k % bk or n % bn:
        raise ValueError(f"matmul_padded takes shapes padded to the blocks: "
                         f"{tuple(a.shape)} @ {tuple(b.shape)} with bm={bm}, "
                         f"bk={bk}, bn={bn} (ops.matmul pads)")
    device = _launch.device_of("matmul", a, b)
    if device.type == "cpu":
        return _matmul_padded_plain(a, b, out_dtype)
    _launch.check_pointer("matmul", "a", a)
    _launch.check_pointer("matmul", "b", b)
    tile = matmul_launch_shape(m, n, bm=bm, bn=bn, a_dtype=a.dtype,
                               b_dtype=b.dtype, out_dtype=out_dtype,
                               tile=tile, device=device)["tile"]
    out = torch.empty((m, n), dtype=out_dtype, device=device)
    codes = _launch.DTYPE_CODES
    _launch.launch("matmul", _ARGTYPES, a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), m, k, n, bm, bk, bn, codes[a.dtype],
                   codes[b.dtype], codes[out_dtype], tile, device=device)
    return out
