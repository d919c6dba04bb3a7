"""Public entry points of the port's kernels, and where they run.

The port of the ata and symm parts of ``repro/kernels/ops.py``.  Where
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

__all__ = ["ata_fused", "ata_fused_packed", "symm_matmul"]

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
        a, levels=levels, variant=variant, gram=gram,
        bk=DEFAULT_BLOCK if bk is None else bk,
        bn=DEFAULT_BLOCK if bn is None else bn, out_dtype=out_dtype,
        bwd=bwd, pipeline_depth=pipeline_depth, operand_dtype=operand_dtype,
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
        a, levels=levels, variant=variant, gram=gram,
        bk=DEFAULT_BLOCK if bk is None else bk,
        bn=DEFAULT_BLOCK if bn is None else bn, out_dtype=out_dtype,
        bwd=bwd, pipeline_depth=pipeline_depth, operand_dtype=operand_dtype,
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
        x, s_packed, levels=levels, variant=variant,
        bm=DEFAULT_BLOCK if bm is None else bm, diag_sym=diag_sym,
        out_dtype=out_dtype, pipeline_depth=pipeline_depth,
        operand_dtype=operand_dtype, acc_dtype=acc_dtype, device=device)
