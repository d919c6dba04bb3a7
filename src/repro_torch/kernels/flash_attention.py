"""Flash attention of the port: online-softmax GQA attention, and its
plain version.

The port of ``repro/kernels/flash_attention.py``.  Layout q (B, H, Sq,
D), k and v (B, Hkv, Skv, D), H % Hkv == 0; query row i sits at position
i and kv column j at position j (aligned at the top left, also when Skv
> Sq).  Causal, sliding-window and softcap masking with the TPU kernel's
finite mask value -1e30; fp32 accumulators; the output in q's dtype.
On a CUDA tensor :func:`flash_attention` launches
``csrc/flash_attention.cu`` (bf16 and fp16 on the tensor cores, fp32 on
the CUDA cores) or raises; on a CPU tensor it runs
:func:`_flash_attention_plain`, which repeats the kernel's arithmetic
(the online softmax over the kernel's kv tiles, :func:`kv_tile`, ``p``
cast to v's dtype before ``P V``).  Forward-only, as the JAX kernel: an
input that requires grad is refused.
"""
from __future__ import annotations

import collections
import ctypes
import math

import torch

from ..core.strassen import ieee_fp32
from . import _launch
from ._launch import INT, PTR

__all__ = ["flash_attention", "HEAD_DIMS", "NEG_INF", "q_tile", "kv_tile",
           "LAUNCH_SHAPES"]

NEG_INF = -1e30
#: head dims the kernel takes (bf16 runs 16 and 32 as 64, and 80 as 128)
HEAD_DIMS = (16, 32, 64, 80, 128, 256)


#: Launches of the kernel by shape, (B, H, Hkv, Sq, Skv, D, causal,
#: dtype name), bumped where ``_launch.KERNEL_LAUNCHES["flash_attention"]``
#: is, so its counts sum to that count when both are zeroed together.
LAUNCH_SHAPES: collections.Counter = collections.Counter()

#: the dtypes the tensor-core kernel runs
TENSOR_CORE_DTYPES = (torch.bfloat16, torch.float16)


def q_tile(dtype: torch.dtype, d: int) -> int:
    """The kernel's q tile: 128 rows in bf16 and fp16 (two warpgroups of
    64); in fp32 128 (16 row groups of 8), or 64 at head_dim 256.  The
    fp32 body halves it where 128-row blocks would not give every SM one
    (it changes no result: each row's arithmetic is its own)."""
    return 64 if dtype not in TENSOR_CORE_DTYPES and d > 128 else 128


def kv_tile(dtype: torch.dtype, d: int) -> int:
    """The kernel's kv tile, which the plain version's online softmax
    follows: in bf16 and fp16 128 rows, or 64 at head_dim 256; in fp32
    64."""
    return 64 if dtype not in TENSOR_CORE_DTYPES or d > 128 else 128

_ARGTYPES = (PTR,) * 4 + (INT,) * 6 + (ctypes.c_float,) * 2 \
    + (INT,) * 3


def _flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool, window: int, scale: float,
                           softcap: float) -> torch.Tensor:
    """The kernel's arithmetic in torch: scores in fp32, scaled after the
    dot, softcapped before the mask, an online softmax over the kernel's
    kv tiles (:func:`kv_tile`) with ``p`` rounded to v's dtype before
    ``P V``.  The kernel skips tiles that no row of its q tile needs; here
    every tile is visited, which changes nothing (a wholly masked tile
    adds ``exp(-1e30 - m) = 0`` to a row that has seen a score, and a
    row's junk from a masked first tile is wiped by its first score, as in
    the kernel)."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = h // hkv
    bk = kv_tile(q.dtype, d)
    dev = q.device
    qg = q.float().reshape(b, hkv, g, sq, d)
    q_pos = torch.arange(sq, device=dev).view(sq, 1)
    m = torch.full((b, hkv, g, sq, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32, device=dev)
    with ieee_fp32():
        for k0 in range(0, skv, bk):
            kb = k[:, :, None, k0:k0 + bk].float()
            vb = v[:, :, None, k0:k0 + bk].float()
            s = (qg @ kb.transpose(-1, -2)) * scale
            if softcap > 0:
                s = softcap * torch.tanh(s / softcap)
            kv_pos = torch.arange(k0, k0 + kb.shape[3], device=dev).view(1, -1)
            valid = torch.ones((sq, kb.shape[3]), dtype=torch.bool,
                               device=dev)
            if causal:
                valid &= q_pos >= kv_pos
            if window > 0:
                valid &= (q_pos - kv_pos) < window
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p.to(v.dtype).float() @ vb
            m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.reshape(b, h, sq, d).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None, softcap: float = 0.0,
                    block_q: int = 512, block_kv: int = 512) -> torch.Tensor:
    """q (B, H, Sq, D); k, v (B, Hkv, Skv, D); H % Hkv == 0; any Sq and
    Skv.  Returns (B, H, Sq, D) in q's dtype.  ``block_q`` and
    ``block_kv`` are the JAX signature's and are ignored: the kernel tiles
    by :func:`q_tile` and :func:`kv_tile` and masks the ragged edges
    itself."""
    _launch.refuse_grad("flash_attention", q, k, v)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _launch.check_dtype("flash_attention", name, x.dtype)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"the flash_attention kernel takes q, k and v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or k.shape[1] < 1 or q.shape[1] % k.shape[1] \
            or min(q.shape) < 1 or k.shape[2] < 1:
        raise ValueError(f"flash_attention takes q (B, H, Sq, D) and k, v "
                         f"(B, Hkv, Skv, D) with H % Hkv == 0, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if not isinstance(window, int) or window < 0:
        raise ValueError(f"window is a non-negative int, got {window!r}")
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    softcap = float(softcap or 0.0)
    device = _launch.device_of("flash_attention", q, k, v)
    if device.type == "cpu":
        return _flash_attention_plain(q, k, v, causal=causal, window=window,
                                      scale=scale, softcap=softcap)
    if b * h > 65535:
        raise ValueError(f"flash_attention takes B * H <= 65535, got {b * h}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _launch.check_pointer("flash_attention", name, x)
    out = torch.empty_like(q)
    _launch.launch("flash_attention", _ARGTYPES, q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), out.data_ptr(), b, h, hkv, sq, skv, d,
                   scale, softcap, int(bool(causal)), window,
                   _launch.DTYPE_CODES[q.dtype], device=device)
    LAUNCH_SHAPES[(b, h, hkv, sq, skv, d, bool(causal),
                   str(q.dtype).removeprefix("torch."))] += 1
    return out
