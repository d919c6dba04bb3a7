"""HASA: Strassen's algorithm generalized to rectangular / odd-size
matrices — the reference recursion, in torch.

The port of ``repro/core/strassen.py`` for ``mode="reference"``: the
recursion runs eagerly over the operands' quadrants, capped at
``levels``, and below the cap a base matmul takes over: ``torch.matmul``
in at least fp32 by default, as the JAX package leaves its leaves to
XLA, or a hook such as ``ops.kernel_base_matmul()`` (the matmul kernel).
Odd dimensions are zero-padded to even (exact) and sliced away.

``resolve_mode`` gives ``"fused"`` for a CUDA tensor and
``"reference"`` for a CPU tensor: ``strassen_matmul(mode="auto")`` runs
the matmul kind of the leaf-program kernel (``ops.matmul_fused``) on the
card and this recursion on the CPU, as the JAX package does on its TPU.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F

__all__ = ["DEFAULT_LEAF", "DEFAULT_LEVELS", "AUTO_MAX_LEVELS",
           "resolve_mode", "strassen_matmul", "strassen_levels_for",
           "ieee_fp32"]

# Base-case threshold: the recursion stops when any dim is <= this.  The
# paper uses 32 on a CPU; the reference package stops at 256, and the
# port keeps its value so both recurse identically.
DEFAULT_LEAF = 256
DEFAULT_LEVELS = 2

# Cap for levels="auto": each level saves 12.5% of the multiplications
# but costs one more bit of accumulated error and doubles the operand
# fan-in of the fused kernel.
AUTO_MAX_LEVELS = 3


@contextlib.contextmanager
def ieee_fp32():
    """Run fp32 matmuls in full fp32 on the card: both TF32 flags off for
    the duration, restored after.  TF32 keeps about three decimal digits,
    which the 1e-5 parity bar of the reference cannot absorb."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def resolve_mode(mode: str, *leaf_hooks, device: torch.device) -> str:
    """Resolve mode="auto" -> "fused" | "reference".

    Fused is the default for a CUDA tensor, reference for a CPU tensor.
    Custom leaf hooks (base_syrk/base_matmul) force the reference
    recursion, because the flattened schedule has no per-leaf call-out.
    """
    if mode == "auto":
        if any(h is not None for h in leaf_hooks):
            return "reference"
        return "fused" if torch.device(device).type == "cuda" \
            else "reference"
    if mode not in ("fused", "reference"):
        raise ValueError(f"unknown mode {mode!r} "
                         "(want 'auto' | 'fused' | 'reference')")
    if mode == "fused" and any(h is not None for h in leaf_hooks):
        raise ValueError(
            "mode='fused' cannot honor base_syrk/base_matmul leaf hooks "
            "(the flattened schedule has no per-leaf call-out) — use "
            "mode='reference' or drop the hooks")
    return mode


def _acc_dtype(*dtypes) -> torch.dtype:
    out = torch.float32
    for dt in dtypes:
        out = torch.promote_types(out, dt)
    return out


def _default_base_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Classical base-case matmul with >=fp32 accumulation."""
    acc = _acc_dtype(a.dtype, b.dtype)
    return torch.matmul(a.to(acc), b.to(acc))


def _pad_to_even(x: torch.Tensor) -> torch.Tensor:
    m, n = x.shape
    pm, pn = m % 2, n % 2
    if pm or pn:
        x = F.pad(x, (0, pn, 0, pm))
    return x


def _quadrants(x: torch.Tensor):
    m, n = x.shape
    m2, n2 = m // 2, n // 2
    return (x[:m2, :n2], x[:m2, n2:], x[m2:, :n2], x[m2:, n2:])


def strassen_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    levels: Union[int, str] = DEFAULT_LEVELS,
    leaf: int = DEFAULT_LEAF,
    variant: str = "strassen",
    base_matmul: Optional[Callable] = None,
    mode: str = "auto",
    bwd: str = "fused",
    trans_a: bool = False,
    trans_b: bool = False,
    out_dtype=None,
    block: Optional[int] = None,
    device=None,
) -> torch.Tensor:
    """Compute ``op(a) @ op(b)`` via (level-capped) Strassen recursion,
    ``op`` = transpose where the flag is set.

    Args:
      a: (m, k) tensor — or (k, m) with ``trans_a``.
      b: (k, n) tensor — or (n, k) with ``trans_b``.
      levels: max recursion depth (0 => classical), or ``"auto"`` to
        recurse until a dim hits ``leaf`` (capped at AUTO_MAX_LEVELS).
      leaf: stop recursing when min(m, k, n) <= leaf.
      variant: "strassen" | "winograd" | "classical".
      base_matmul: leaf matmul; defaults to ``torch.matmul`` in >= fp32.
        ``kernels.ops.kernel_base_matmul()`` runs every leaf through the
        matmul kernel (forward-only: it refuses operands that require
        grad).  Forces reference mode under ``mode="auto"``.
      mode: "auto" | "fused" | "reference".  "auto" is "fused" (the
        matmul kind of the leaf-program kernel) for operands placed on
        the card and "reference" (the recursion) on the CPU.
      bwd: the backward of the fused path — ``"fused"`` (both VJP
        products through the matmul kind, the transposes folded) or
        ``"dense"`` (the classical products in torch).  Reference mode
        differentiates through the recursion and ignores it.
      out_dtype: result dtype; defaults to the promoted accumulation
        dtype (fp32 for bf16/fp32 inputs).
      block: tile edge of the fused path (bm = bk = bn = block; None =
        256).
      device: where to run; None means ``"cuda"``.  CPU tensors are
        moved to the card unless ``device="cpu"``.  Without a card and
        without ``device="cpu"`` this raises ``RuntimeError``.

    Returns (m, n) tensor in ``out_dtype``.
    """
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"bad shapes for matmul: {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    m, k_a = a.shape[::-1] if trans_a else a.shape
    k_b, n = b.shape[::-1] if trans_b else b.shape
    if k_a != k_b:
        raise ValueError(
            f"bad shapes for matmul: {tuple(a.shape)} x {tuple(b.shape)} "
            f"(trans_a={trans_a}, trans_b={trans_b})")
    if levels == "auto":
        levels = min(strassen_levels_for(m, k_a, n, leaf), AUTO_MAX_LEVELS)
    out_dtype = _acc_dtype(a.dtype, b.dtype) if out_dtype is None \
        else out_dtype
    from ..kernels import ops
    a, b = ops._place(a, device), ops._place(b, device)
    mode = resolve_mode(mode, base_matmul, device=a.device)
    if mode == "fused":
        return ops.matmul_fused(a, b, levels=levels, variant=variant,
                                bm=block, bk=block, bn=block,
                                trans_a=trans_a, trans_b=trans_b,
                                out_dtype=out_dtype, bwd=bwd,
                                device=a.device)
    base = base_matmul or _default_base_matmul
    with ieee_fp32():
        res = _strassen_rec(a.T if trans_a else a, b.T if trans_b else b,
                            levels, leaf, variant, base)
    return res.to(out_dtype)


def _strassen_rec(a, b, levels, leaf, variant, base):
    m, k = a.shape
    _, n = b.shape
    if variant == "classical" or levels <= 0 or min(m, k, n) <= leaf:
        return base(a, b)

    ap, bp = _pad_to_even(a), _pad_to_even(b)
    a11, a12, a21, a22 = _quadrants(ap)
    b11, b12, b21, b22 = _quadrants(bp)

    rec = functools.partial(
        _strassen_rec, levels=levels - 1, leaf=leaf, variant=variant, base=base
    )

    if variant == "strassen":
        # M7's second operand is (B21 + B22): the paper's listing has a
        # sign erratum (DESIGN.md §9).
        m1 = rec(a11 + a22, b11 + b22)
        m2 = rec(a21 + a22, b11)
        m3 = rec(a11, b12 - b22)
        m4 = rec(a22, b21 - b11)
        m5 = rec(a11 + a12, b22)
        m6 = rec(a21 - a11, b11 + b12)
        m7 = rec(a12 - a22, b21 + b22)
        c11 = m1 + m4 - m5 + m7
        c12 = m3 + m5
        c21 = m2 + m4
        c22 = m1 - m2 + m3 + m6
    elif variant == "winograd":
        s1 = a21 + a22
        s2 = s1 - a11
        s3 = a11 - a21
        s4 = a12 - s2
        t1 = b12 - b11
        t2 = b22 - t1
        t3 = b22 - b12
        t4 = t2 - b21
        m1 = rec(a11, b11)
        m2 = rec(a12, b21)
        m3 = rec(s4, b22)
        m4 = rec(a22, t4)
        m5 = rec(s1, t1)
        m6 = rec(s2, t2)
        m7 = rec(s3, t3)
        u1 = m1 + m6
        u2 = u1 + m7
        u3 = u1 + m5
        c11 = m1 + m2
        c12 = u3 + m3
        c21 = u2 - m4
        c22 = u2 + m5
    else:
        raise ValueError(f"unknown variant {variant!r}")

    c = torch.cat([torch.cat([c11, c12], dim=1),
                   torch.cat([c21, c22], dim=1)], dim=0)
    return c[:m, :n]


def strassen_levels_for(m: int, k: int, n: int, leaf: int = DEFAULT_LEAF) -> int:
    """Natural number of Strassen levels for a problem."""
    leaf = max(leaf, 1)        # (1+1)//2 == 1: leaf=0 would never terminate
    lv = 0
    while min(m, k, n) > leaf:
        m, k, n = (m + 1) // 2, (k + 1) // 2, (n + 1) // 2
        lv += 1
    return lv
