"""The tiled matrix transpose of the port, and its plain version.

The port of ``repro/kernels/transpose.py``: ``out (n, m) = a (m, n)^t``
for shapes already padded to block multiples (``ops.transpose`` pads).
On a CUDA tensor it launches ``csrc/transpose.cu``, a bit-for-bit copy
for any 2- or 4-byte element type (bf16, fp16, fp32, int32, ...), or
raises; on a CPU tensor it runs :func:`_transpose_padded_plain`.
Forward-only: an input that requires grad is refused.
"""
from __future__ import annotations

import torch

from . import _launch
from ._launch import INT, LONG, PTR

__all__ = ["transpose_padded"]

_ARGTYPES = (PTR, PTR, LONG, LONG, INT)


def _transpose_padded_plain(a: torch.Tensor) -> torch.Tensor:
    return a.T.contiguous()


def transpose_padded(a: torch.Tensor, *, bm: int = 256,
                     bn: int = 256) -> torch.Tensor:
    """``a.T`` for ``a`` (m, n) padded to (bm, bn) multiples."""
    _launch.refuse_grad("transpose", a)
    _launch.check_blocks("transpose", bm=bm, bn=bn)
    if a.element_size() not in (2, 4):
        raise TypeError(f"the transpose kernel moves 2- or 4-byte elements, "
                        f"got {a.dtype}")
    if a.ndim != 2 or min(a.shape) < 1 or a.shape[0] % bm or a.shape[1] % bn:
        raise ValueError(f"transpose_padded takes a non-empty (m, n) padded "
                         f"to (bm, bn) = ({bm}, {bn}), got {tuple(a.shape)} "
                         f"(ops.transpose pads)")
    device = _launch.device_of("transpose", a)
    if device.type == "cpu":
        return _transpose_padded_plain(a)
    _launch.check_pointer("transpose", "a", a)
    m, n = a.shape
    out = torch.empty((n, m), dtype=a.dtype, device=device)
    _launch.launch("transpose", _ARGTYPES, a.data_ptr(), out.data_ptr(), m, n,
                   a.element_size(), device=device)
    return out
