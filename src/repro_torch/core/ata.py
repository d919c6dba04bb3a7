"""ATA: the paper's Strassen-based algorithm for C = A^t A, in torch.

The port of ``repro/core/ata.py``.  Algorithm 1 of the paper:

    split A into quadrants A11 A12 / A21 A22, then
      C11 = ATA(A11) + ATA(A21)                  (recursive, symmetric)
      C22 = ATA(A12) + ATA(A22)                  (recursive, symmetric)
      C21 = HASA(A12^t, A11) + HASA(A22^t, A21)  (rectangular Strassen)
      C12 = C21^t                                (never computed)

Two execution modes:

* ``mode="fused"`` — the hot path.  The recursion is flattened into a
  leaf program (``core/leaf_ir.py``) and run by one hand-written CUDA
  kernel (``kernels/strassen_fused.py``); each packed lower-triangular
  output tile is written once.  Differentiable: the backward runs the
  same kernel as the symm kind (``bwd="fused"``).
* ``mode="reference"`` — the recursion itself, capped at ``levels``;
  the numerical oracle, differentiable through autograd, and the only
  mode that honours custom ``base_syrk`` / ``base_matmul`` hooks, such
  as the kernel leaves ``ops.kernel_base_syrk`` / ``kernel_base_matmul``
  (the syrk and matmul CUDA kernels; forward-only).

``mode="auto"`` picks fused for a CUDA tensor and reference for a CPU
tensor.  The entry points run on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F

from .strassen import (
    strassen_matmul, resolve_mode, ieee_fp32, AUTO_MAX_LEVELS, DEFAULT_LEAF,
    DEFAULT_LEVELS,
)
from .symmetry import symmetrize_from_lower

__all__ = ["ata", "ata_full", "ata_levels_for"]


def _default_base_syrk(a: torch.Tensor) -> torch.Tensor:
    """Classical leaf gram with >=fp32 accumulation (lower triangle kept)."""
    acc = torch.promote_types(a.dtype, torch.float32)
    a = a.to(acc)
    return torch.tril(a.T @ a)


def ata(
    a: torch.Tensor,
    *,
    gram_of: str = "cols",
    levels: Union[int, str] = DEFAULT_LEVELS,
    leaf: int = DEFAULT_LEAF,
    variant: str = "strassen",
    gram: str = "strassen",
    base_syrk: Optional[Callable] = None,
    base_matmul: Optional[Callable] = None,
    mode: str = "auto",
    bwd: str = "fused",
    out_dtype=None,
    block: Optional[int] = None,
    pipeline_depth: Optional[int] = None,
    operand_dtype=None,
    acc_dtype=None,
    sr_seed: Optional[int] = None,
    device=None,
) -> torch.Tensor:
    """Lower triangle of ``a.T @ a`` via the paper's ATA recursion.

    Args:
      a: (m, n) tensor: fp32, bf16, fp16 or fp64.
      gram_of: ``"cols"`` (default, ``tril(a.T @ a)``, (n, n)) or
        ``"rows"`` (``tril(a @ a.T)``, (m, m)).  The row gram runs the aat
        kind of the kernel on the fused path (bm = bk = ``block``) and
        ``ATA(a.T)`` on the reference path.
      levels: recursion depth cap (0 => classical SYRK), or ``"auto"``
        to recurse until a dimension reaches ``leaf`` (capped at
        ``AUTO_MAX_LEVELS``).
      leaf: stop recursing when m or n <= leaf (reference mode; also sets
        the ``levels="auto"`` depth for both modes).
      variant: registered algebra for the off-diagonal products.
      gram: registered gram algebra for the fused path's symmetric
        decomposition; the reference recursion ignores it.
      base_syrk / base_matmul: leaf hooks of the reference recursion,
        e.g. ``kernels.ops.kernel_base_syrk()`` /
        ``kernels.ops.kernel_base_matmul()``, which run every leaf
        through the syrk and matmul kernels (forward-only: they refuse
        an ``a`` that requires grad).  They force reference mode under
        ``mode="auto"``.
      mode: "auto" | "fused" | "reference".
      bwd: the backward of the fused path — ``"fused"`` (default: the
        packed cotangent through the symm kind of the leaf-program
        kernel) or ``"dense"`` (the classical ``A (S + S^t)`` in torch).
        Reference mode differentiates through the recursion and ignores
        it, as does ``gram_of="rows"``, whose fused backward is the dense
        ``(S + S^t) A``.
      out_dtype: result dtype; defaults to
        ``torch.promote_types(a.dtype, torch.float32)``.
      block: tile edge of the fused path (bk = bn = block; None = 256).
      pipeline_depth: ``cp.async`` ring depth of the fused kernel, 1-4;
        None = 2 on the card, 1 on the CPU.  Every depth gives the same
        bits.
      operand_dtype: quantize A once to this dtype (fp8 e4m3fn or e5m2,
        bf16, fp16, fp32, fp64), as ``jnp.astype`` rounds; the fused
        kernel stores its tiles so and upcasts them to fp32 before the
        signed sums (an fp64 tile is fp32 arithmetic, so it is stored as
        fp32).  ``None`` keeps A's own dtype (fp64 stored as fp32).  The
        reference path quantizes, then recurses in the promoted dtype.
      acc_dtype: the fused kernel's accumulator: fp32 (default), bf16 or
        fp64, rounded where the JAX package's VMEM accumulator is (each
        K block's product).  The reference path ignores it.
      sr_seed: with a bf16 ``out_dtype``, the fused path computes in fp32
        and rounds the result stochastically under this seed
        (deterministic per seed and device, unbiased; the bits differ
        from the JAX package's threefry ones).  The reference path
        ignores it.
      device: where to run; None means ``"cuda"``.  A CPU tensor is
        moved to the card unless ``device="cpu"``.  Without a card and
        without ``device="cpu"`` this raises ``RuntimeError``.

    Returns:
      (n, n) tensor — (m, m) for ``gram_of="rows"`` — strictly upper
      triangle zeroed, dtype ``out_dtype``.
    """
    from ..kernels import ops, strassen_fused as sf

    if a.ndim != 2:
        raise ValueError(f"ata expects a matrix, got shape {tuple(a.shape)}")
    if gram_of not in ("cols", "rows"):
        raise ValueError(f"gram_of must be 'cols' or 'rows', got "
                         f"{gram_of!r}")
    a = ops._place(a, device)
    m, n = a.shape
    if levels == "auto":
        levels = min(ata_levels_for(m, n, leaf), AUTO_MAX_LEVELS)
    out_dtype = sf._promoted(a.dtype) if out_dtype is None else out_dtype
    op_dt = sf._resolve_operand_dtype(operand_dtype)
    mode = resolve_mode(mode, base_syrk, base_matmul, device=a.device)
    if mode != "fused" and op_dt is not None:
        # Reference oracle for quantized operands: quantize once, then
        # recurse in the promoted compute dtype (the fused kernel upcasts
        # quantized tiles to fp32 before every signed sum / product).
        a = sf._quantize(a, op_dt).to(sf._promoted(a.dtype))
    if gram_of == "rows":
        if mode == "fused":
            return ops.aat_fused(a, levels=levels, variant=variant,
                                 gram=gram, bm=block, bk=block,
                                 out_dtype=out_dtype,
                                 pipeline_depth=pipeline_depth,
                                 operand_dtype=operand_dtype,
                                 acc_dtype=acc_dtype, sr_seed=sr_seed,
                                 device=a.device)
        # reference oracle: AAT(A) = ATA(A^t) — the 2021 paper's identity
        a = a.T
    elif mode == "fused":
        return ops.ata_fused(a, levels=levels, variant=variant, gram=gram,
                             bk=block, bn=block, out_dtype=out_dtype,
                             bwd=bwd, pipeline_depth=pipeline_depth,
                             operand_dtype=operand_dtype,
                             acc_dtype=acc_dtype, sr_seed=sr_seed,
                             device=a.device)
    syrk = base_syrk or _default_base_syrk
    with ieee_fp32():
        out = _ata_rec(a, levels, leaf, variant, syrk, base_matmul)
    return out.to(out_dtype)


def _ata_rec(a, levels, leaf, variant, syrk, base_matmul):
    m, n = a.shape
    # Base case (paper: m or n <= 32; the reference package uses 256).
    if levels <= 0 or m <= leaf or n <= leaf:
        return syrk(a)

    # Pad odd dims (exact: zero rows of A add nothing to A^tA; zero cols add
    # zero rows+cols to C, sliced away below).
    pm, pn = m % 2, n % 2
    ap = F.pad(a, (0, pn, 0, pm)) if (pm or pn) else a
    mp, np_ = ap.shape
    m2, n2 = mp // 2, np_ // 2

    a11 = ap[:m2, :n2]
    a12 = ap[:m2, n2:]
    a21 = ap[m2:, :n2]
    a22 = ap[m2:, n2:]

    def rec(x):
        return _ata_rec(x, levels - 1, leaf, variant, syrk, base_matmul)

    # C11, C22: sums of two symmetric recursive grams (lines 7-10, Alg. 1).
    c11 = rec(a11) + rec(a21)
    c22 = rec(a12) + rec(a22)

    # C21: two generalized-Strassen rectangular products (lines 11-12).
    c21 = strassen_matmul(
        a12.T, a11, levels=levels - 1, leaf=leaf, variant=variant,
        base_matmul=base_matmul, mode="reference", device=a.device,
    ) + strassen_matmul(
        a22.T, a21, levels=levels - 1, leaf=leaf, variant=variant,
        base_matmul=base_matmul, mode="reference", device=a.device,
    )

    top = torch.cat([c11, c11.new_zeros((n2, np_ - n2))], dim=1)
    bot = torch.cat([c21.to(c11.dtype), c22], dim=1)
    c = torch.cat([top, bot], dim=0)
    return c[:n, :n]


def ata_full(a: torch.Tensor, **kw) -> torch.Tensor:
    """Full symmetric ``a.T @ a`` (mirrors C21 into C12, per the paper)."""
    return symmetrize_from_lower(ata(a, **kw))


def ata_levels_for(m: int, n: int, leaf: int = DEFAULT_LEAF) -> int:
    """Natural recursion depth: recurse until a dim hits the leaf size."""
    leaf = max(leaf, 1)        # (1+1)//2 == 1: leaf=0 would never terminate
    lv = 0
    while m > leaf and n > leaf:
        m, n = (m + 1) // 2, (n + 1) // 2
        lv += 1
    return lv
