"""Strassen's recombination of the port in one pass, and its plain
version.

The port of ``repro/kernels/combine.py``: from the seven products of one
Strassen level, ``c11 = m1 + m4 - m5 + m7``, ``c12 = m3 + m5``,
``c21 = m2 + m4``, ``c22 = m1 - m2 + m3 + m6``, reading each product once
and writing each quadrant once.  On a CUDA tensor it launches
``csrc/combine.cu`` or raises; on a CPU tensor it runs
:func:`_strassen_combine_plain`.  Both round after each add, in that
order, so the kernel is bit-equal to the plain version on the card, bf16
and fp16 included (each add rounded in the input dtype, as ``jnp``
rounds each operation).  Forward-only: an input that requires grad is
refused.
"""
from __future__ import annotations

import torch

from . import _launch
from ._launch import INT, LONG, PTR

__all__ = ["strassen_combine"]

_ARGTYPES = (PTR,) * 11 + (LONG, INT)


def _strassen_combine_plain(m1, m2, m3, m4, m5, m6, m7):
    t1 = m1 + m4
    return t1 - m5 + m7, m3 + m5, m2 + m4, m1 - m2 + m3 + m6


def strassen_combine(m1: torch.Tensor, m2: torch.Tensor, m3: torch.Tensor,
                     m4: torch.Tensor, m5: torch.Tensor, m6: torch.Tensor,
                     m7: torch.Tensor, *, bm: int = 256, bn: int = 256):
    """``(c11, c12, c21, c22)`` from the seven Strassen products.

    All seven share one shape (m, n) with m % bm == 0 and n % bn == 0
    (``ops.strassen_combine`` pads) and one dtype, fp32, bf16 or fp16; the
    quadrants come out in that dtype.
    """
    ms = (m1, m2, m3, m4, m5, m6, m7)
    _launch.refuse_grad("combine", *ms)
    _launch.check_blocks("combine", bm=bm, bn=bn)
    for p, x in enumerate(ms, 1):
        _launch.check_dtype("combine", f"m{p}", x.dtype)
    if len({x.dtype for x in ms}) > 1:
        raise TypeError(f"strassen_combine takes seven products of one "
                        f"dtype, got {[str(x.dtype) for x in ms]}")
    shape = tuple(m1.shape)
    if len(shape) != 2 or min(shape) < 1 or shape[0] % bm \
            or shape[1] % bn or any(tuple(x.shape) != shape for x in ms):
        raise ValueError(f"strassen_combine takes seven non-empty (m, n) "
                         f"padded to (bm, bn) = ({bm}, {bn}), got "
                         f"{[tuple(x.shape) for x in ms]} (ops."
                         f"strassen_combine pads)")
    device = _launch.device_of("combine", *ms)
    if device.type == "cpu":
        return _strassen_combine_plain(*ms)
    for p, x in enumerate(ms, 1):
        _launch.check_pointer("combine", f"m{p}", x)
    outs = tuple(torch.empty(shape, dtype=m1.dtype, device=device)
                 for _ in range(4))
    _launch.launch("combine", _ARGTYPES, *(x.data_ptr() for x in ms),
                   *(c.data_ptr() for c in outs), m1.numel(),
                   _launch.DTYPE_CODES[m1.dtype], device=device)
    return outs
