"""Plain torch oracles for the port's kernels (the correctness contracts).

The port of ``repro/kernels/ref.py``: products in at least fp32, on the
device the operands lie on.
"""
from __future__ import annotations

import torch

from ..core.strassen import _acc_dtype, ieee_fp32
from ..core.symmetry import pack_tril_blocks

__all__ = ["matmul_ref", "syrk_packed_ref", "strassen_combine_ref",
           "transpose_ref", "flash_attention_ref"]


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


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None,
                        softcap=0.0):
    """Plain softmax attention in fp32; q (B,H,Sq,D), k/v (B,Hkv,Skv,D)."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = h // hkv
    kf = torch.repeat_interleave(k, g, dim=1).float()
    vf = torch.repeat_interleave(v, g, dim=1).float()
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    with ieee_fp32():
        s = (q.float() @ kf.transpose(-1, -2)) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        qp = torch.arange(sq, device=q.device)[:, None]
        kp = torch.arange(skv, device=q.device)[None, :]
        mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qp >= kp
        if window:
            mask &= (qp - kp) < window
        s = torch.where(mask, s, -1e30)
        w = torch.softmax(s, dim=-1)
        return (w @ vf).to(q.dtype)
