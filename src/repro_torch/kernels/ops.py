"""Public entry points of the port's kernels, and where they run.

The port of the leaf-program parts of ``repro/kernels/ops.py``: the
column gram (``ata_fused[_packed]``), its backward's ``symm_matmul``, the
row gram (``aat_fused[_packed]``), the streamed update
(``rank_k_update``) and the Strassen product (``matmul_fused``).  Where
the JAX package decides per backend whether a Pallas kernel runs
compiled or in interpret mode (``_auto_interpret``), the port decides by
device: the entry points run on the card unless the caller passes
``device="cpu"`` (:func:`_place`), and a CUDA tensor always reaches the
CUDA kernel.

Block sizes default to 256, the JAX package's untuned default; the
autotune cache is ROADMAP Queue 1 #8.
"""
from __future__ import annotations

import torch

__all__ = ["ata_fused", "ata_fused_packed", "symm_matmul", "aat_fused",
           "aat_fused_packed", "rank_k_update", "matmul_fused"]

DEFAULT_BLOCK = 256


def _place(a, device) -> torch.Tensor:
    """Move ``a`` to the device an entry point runs on: ``None`` means
    the card.  Without a card, only an explicit ``device="cpu"`` runs."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on cuda or cpu, not {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' "
            "to run the plain executor on the CPU")
    return torch.as_tensor(a).to(dev)


def _block(b):
    return DEFAULT_BLOCK if b is None else b


def ata_fused(a, *, levels=2, variant="strassen", gram="strassen", bk=None,
              bn=None, out_dtype=None, bwd="fused", pipeline_depth=None,
              operand_dtype=None, acc_dtype=None, sr_seed=None, device=None):
    """Dense ``tril(a.T @ a)`` via the fused leaf program.  ``gram`` picks
    the registered symmetric decomposition (``"strassen"`` | ``"dps"``);
    ``bwd`` the backward (``"fused"``: the symm kind on the packed
    cotangent; ``"dense"``: ``a @ (s + s.T)``); the other knobs are
    ``strassen_fused.fused_ata_packed``'s."""
    from . import strassen_fused as _sf
    return _sf.fused_ata(
        a, levels=levels, variant=variant, gram=gram, bk=_block(bk),
        bn=_block(bn), out_dtype=out_dtype, bwd=bwd,
        pipeline_depth=pipeline_depth, operand_dtype=operand_dtype,
        acc_dtype=acc_dtype, sr_seed=sr_seed, device=device)


def ata_fused_packed(a, *, levels=2, variant="strassen", gram="strassen",
                     bk=None, bn=None, out_dtype=None, bwd="fused",
                     pipeline_depth=None, operand_dtype=None, acc_dtype=None,
                     sr_seed=None, device=None):
    """Packed lower-tri block stack of ``a.T @ a`` via the fused leaf
    program (upper-triangular blocks are never computed or written).
    Differentiable: the packed cotangent goes straight to the symm kind
    (``bwd="fused"``) — no dense n^2 buffer in the backward."""
    from . import strassen_fused as _sf
    packed, _ = _sf.fused_ata_packed(
        a, levels=levels, variant=variant, gram=gram, bk=_block(bk),
        bn=_block(bn), out_dtype=out_dtype, bwd=bwd,
        pipeline_depth=pipeline_depth, operand_dtype=operand_dtype,
        acc_dtype=acc_dtype, sr_seed=sr_seed, device=device)
    return packed


def symm_matmul(x, s_packed, *, levels=2, variant="strassen", bm=None,
                diag_sym=False, out_dtype=None, pipeline_depth=None,
                operand_dtype=None, acc_dtype=None, device=None):
    """``x @ Sym`` where Sym is given only as its packed lower-triangular
    tile stack (``ata_fused_packed`` layout; the tile edge is read off
    the stack) — the symm kind that powers the fused Gram backward.
    ``diag_sym=True`` computes ``x @ (S + S^t)`` instead (the VJP
    operand).  The knobs are ``strassen_fused.fused_symm_matmul``'s."""
    from . import strassen_fused as _sf
    return _sf.fused_symm_matmul(
        x, s_packed, levels=levels, variant=variant, bm=_block(bm),
        diag_sym=diag_sym, out_dtype=out_dtype, pipeline_depth=pipeline_depth,
        operand_dtype=operand_dtype, acc_dtype=acc_dtype, device=device)


def matmul_fused(a, b, *, levels=2, variant="strassen", bm=None, bk=None,
                 bn=None, trans_a=False, trans_b=False, out_dtype=None,
                 bwd="fused", pipeline_depth=None, operand_dtype=None,
                 acc_dtype=None, device=None):
    """``op(a) @ op(b)`` via the fused Strassen program;
    ``trans_a``/``trans_b`` transpose an operand through how the kernel
    reads it — no transposed copy (the distributed ring / 2.5D block
    tasks route here).  ``bwd="fused"`` (default) runs both VJP products
    through the same kind with the transposes likewise folded; the knobs
    are ``strassen_fused.fused_matmul``'s."""
    from . import strassen_fused as _sf
    return _sf.fused_matmul(
        a, b, levels=levels, variant=variant, bm=_block(bm), bk=_block(bk),
        bn=_block(bn), trans_a=trans_a, trans_b=trans_b, out_dtype=out_dtype,
        bwd=bwd, pipeline_depth=pipeline_depth, operand_dtype=operand_dtype,
        acc_dtype=acc_dtype, device=device)


def aat_fused(a, *, levels=2, variant="strassen", gram="strassen", bm=None,
              bk=None, out_dtype=None, pipeline_depth=None,
              operand_dtype=None, acc_dtype=None, sr_seed=None, device=None):
    """Dense ``tril(a @ a.T)`` — the Arrigoni-Massini row gram
    (``ata(x, gram_of="rows")``) via the same leaf-program kernel; the
    transpose of ``a`` never exists.  Differentiable through the dense
    ``(S + S^t) A``; the knobs are ``strassen_fused.fused_aat``'s."""
    from . import strassen_fused as _sf
    return _sf.fused_aat(
        a, levels=levels, variant=variant, gram=gram, bm=_block(bm),
        bk=_block(bk), out_dtype=out_dtype, pipeline_depth=pipeline_depth,
        operand_dtype=operand_dtype, acc_dtype=acc_dtype, sr_seed=sr_seed,
        device=device)


def aat_fused_packed(a, *, levels=2, variant="strassen", gram="strassen",
                     bm=None, bk=None, out_dtype=None, pipeline_depth=None,
                     operand_dtype=None, acc_dtype=None, sr_seed=None,
                     device=None):
    """Packed lower-tri block stack of ``a @ a.T`` (the row-gram dual of
    :func:`ata_fused_packed`)."""
    from . import strassen_fused as _sf
    packed, _ = _sf.fused_aat_packed(
        a, levels=levels, variant=variant, gram=gram, bm=_block(bm),
        bk=_block(bk), out_dtype=out_dtype, pipeline_depth=pipeline_depth,
        operand_dtype=operand_dtype, acc_dtype=acc_dtype, sr_seed=sr_seed,
        device=device)
    return packed


def rank_k_update(c_stack, a, *, levels=2, variant="strassen",
                  gram="strassen", bk=None, out_dtype=None, donate=True,
                  pipeline_depth=None, operand_dtype=None, acc_dtype=None,
                  device=None):
    """``C += tril(a.T @ a)`` on a packed tile stack in one kernel — the
    accumulating (rank-k) program: the stack seeds the kernel's
    accumulator, so a streamed Gram chunk makes no delta stack.  With
    ``donate`` (default) the new stack is written over ``c_stack`` in
    place, the counterpart of the JAX package's buffer donation; a stack
    that requires grad is refused then (pass ``donate=False``).  The
    knobs are ``strassen_fused.fused_rank_k_update``'s."""
    from . import strassen_fused as _sf
    return _sf.fused_rank_k_update(
        c_stack, a, levels=levels, variant=variant, gram=gram,
        bk=_block(bk), out_dtype=out_dtype, pipeline_depth=pipeline_depth,
        operand_dtype=operand_dtype, acc_dtype=acc_dtype, donate=donate,
        device=device)
