"""The tiled matrix product of the port, and its plain version.

The port of ``repro/kernels/matmul.py``.  :func:`matmul_padded` takes
shapes already padded to block multiples (``ops.matmul`` pads).  On a
CUDA tensor it launches ``csrc/matmul.cu`` (fp32 FMA on the CUDA cores,
an fp32 accumulator over the K blocks, no TF32) or raises; on a CPU
tensor it runs :func:`_matmul_padded_plain`.  Forward-only, as the JAX
kernel: an input that requires grad is refused.
"""
from __future__ import annotations

import torch

from ..core.strassen import ieee_fp32
from . import _launch
from ._launch import INT, LONG, PTR

__all__ = ["matmul_padded"]

_ARGTYPES = (PTR, PTR, PTR, LONG, LONG, LONG) + (INT,) * 6


def _matmul_padded_plain(a: torch.Tensor, b: torch.Tensor,
                         out_dtype: torch.dtype) -> torch.Tensor:
    with ieee_fp32():
        return (a.float() @ b.float()).to(out_dtype)


def matmul_padded(a: torch.Tensor, b: torch.Tensor, *, bm: int = 256,
                  bk: int = 256, bn: int = 256,
                  out_dtype=None) -> torch.Tensor:
    """``a @ b`` for shapes already padded to (bm, bk) / (bk, bn)
    multiples; fp32 or bf16 operands, the result in ``out_dtype``
    (default ``torch.promote_types(a.dtype, b.dtype)``)."""
    _launch.refuse_grad("matmul", a, b)
    _launch.check_blocks("matmul", bm=bm, bk=bk, bn=bn)
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
    out = torch.empty((m, n), dtype=out_dtype, device=device)
    codes = _launch.DTYPE_CODES
    _launch.launch("matmul", _ARGTYPES, a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), m, k, n, bm, bk, bn, codes[a.dtype],
                   codes[b.dtype], codes[out_dtype], device=device)
    return out
