"""Plain torch oracles for the port's kernels (the correctness contracts).

The port of ``matmul_ref``, ``syrk_packed_ref``,
``strassen_combine_ref`` and ``transpose_ref`` of
``repro/kernels/ref.py``: products in at least fp32, on the device the
operands lie on.  ``flash_attention_ref`` comes with the flash-attention
kernel.
"""
from __future__ import annotations

import torch

from ..core.strassen import _acc_dtype, ieee_fp32
from ..core.symmetry import pack_tril_blocks

__all__ = ["matmul_ref", "syrk_packed_ref", "strassen_combine_ref",
           "transpose_ref"]


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype=None) -> torch.Tensor:
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    acc = _acc_dtype(a.dtype, b.dtype)
    with ieee_fp32():
        return (a.to(acc) @ b.to(acc)).to(out_dtype)


def syrk_packed_ref(a: torch.Tensor, bn: int,
                    out_dtype=None) -> torch.Tensor:
    """Packed lower-triangular block stack of a.T @ a (row-major tri order)."""
    out_dtype = out_dtype or a.dtype
    af = a.to(_acc_dtype(a.dtype))
    with ieee_fp32():
        c = (af.T @ af).to(out_dtype)
    return pack_tril_blocks(c, bn)


def strassen_combine_ref(m1, m2, m3, m4, m5, m6, m7):
    c11 = m1 + m4 - m5 + m7
    c12 = m3 + m5
    c21 = m2 + m4
    c22 = m1 - m2 + m3 + m6
    return c11, c12, c21, c22


def transpose_ref(a: torch.Tensor) -> torch.Tensor:
    return a.T
