"""SYRK of the port: the packed lower-triangular tiles of ``A^t A``.

The port of ``repro/kernels/syrk.py``.  :func:`syrk_packed` returns the
stack of the ``T(T+1)/2`` lower-triangular ``(bn, bn)`` tiles, row-major
over the triangle (the layout of ``core/symmetry.pack_tril_blocks``),
diagonal tiles stored whole; upper tiles are never computed.  On a CUDA
tensor it launches ``csrc/syrk.cu`` (fp32 FMA, an fp32 accumulator over
the K blocks, no TF32) or raises; on a CPU tensor it runs
:func:`_syrk_packed_plain`, which walks the kernel's grid in torch.
Forward-only, as the JAX kernel: an input that requires grad is refused.
"""
from __future__ import annotations

import torch

from ..core.strassen import ieee_fp32
from . import _launch
from ._launch import INT, LONG, PTR

__all__ = ["syrk_packed"]

_ARGTYPES = (PTR, PTR, LONG, LONG, INT, INT, INT, INT)


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
                out_dtype=None) -> torch.Tensor:
    """Packed lower-triangular block stack of ``a.T @ a``.

    ``a``: (M, N) with M % bk == 0, N % bn == 0 (``ops.syrk`` pads), fp32
    or bf16.  Returns (T(T+1)/2 * bn, bn) with T = N // bn, in
    ``out_dtype`` (default ``a.dtype``).
    """
    _launch.refuse_grad("syrk", a)
    _launch.check_blocks("syrk", bk=bk, bn=bn)
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
    t_blocks = n // bn
    out = torch.empty((t_blocks * (t_blocks + 1) // 2 * bn, bn),
                      dtype=out_dtype, device=device)
    codes = _launch.DTYPE_CODES
    _launch.launch("syrk", _ARGTYPES, a.data_ptr(), out.data_ptr(), m, n, bk,
                   bn, codes[a.dtype], codes[out_dtype], device=device)
    return out
