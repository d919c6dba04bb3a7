"""Public entry points of the port's kernels, and where they run.

The port of ``repro/kernels/ops.py``: flash attention
(``flash_mha``), the tiled product (``matmul``), the packed gram
(``syrk[_packed]``), Strassen's recombination (``strassen_combine``),
the transpose (``transpose``) and the leaf hooks of the reference
recursion built on the first two (``kernel_base_matmul``,
``kernel_base_syrk``); and, through the
leaf-program kernel, the column gram (``ata_fused[_packed]``), its
backward's ``symm_matmul``, the row gram (``aat_fused[_packed]``), the
streamed update (``rank_k_update``) and the Strassen product
(``matmul_fused``).  Arbitrary shapes are zero-padded to block multiples
(exact for all four single-purpose kernels) and sliced back.  Where
the JAX package decides per backend whether a Pallas kernel runs
compiled or in interpret mode (``_auto_interpret``), the port decides by
device: the entry points run on the card unless the caller passes
``device="cpu"`` (:func:`_place`), and a CUDA tensor always reaches the
CUDA kernel.

Block sizes default to ``None`` = "consult the gram autotune cache"
(``gram/autotune.py``: winners persisted per shape bucket, dtype and
backend), as in the JAX package, falling back to 256 when the cache has
no entry for the bucket or cannot be read.  Explicit block arguments
bypass the cache.  The single-purpose kernels are
forward-only, as the JAX package's are: with grad mode on they refuse an
input that requires grad.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.symmetry import unpack_tril_blocks
from . import _launch
from . import combine as _combine
from . import flash_attention as _fa
from . import matmul as _matmul
from . import syrk as _syrk
from . import transpose as _transpose

__all__ = ["matmul", "syrk_packed", "syrk", "strassen_combine", "transpose",
           "kernel_base_matmul", "kernel_base_syrk", "ata_fused",
           "ata_fused_packed", "symm_matmul", "aat_fused", "aat_fused_packed",
           "rank_k_update", "matmul_fused", "flash_mha"]

DEFAULT_BLOCK = 256


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``None`` means the card.
    Without a card, only an explicit ``device="cpu"`` runs."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on cuda or cpu, not {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' "
            "to run the plain executor on the CPU")
    return dev


def _place(a, device) -> torch.Tensor:
    """Move ``a`` to the device an entry point runs on
    (:func:`resolve_device`)."""
    return torch.as_tensor(a).to(resolve_device(device))


def _resolve_blocks(kind, m, n, dtype, device, **blocks) -> dict:
    """Fill ``None`` block edges from the gram autotune cache for the
    (m, n) bucket of ``kind`` on ``device``'s backend
    (``autotune.resolve_block_defaults``).  Explicit values win; an empty
    or unreadable cache gives ``DEFAULT_BLOCK``."""
    if all(v is not None for v in blocks.values()):
        return blocks
    from ..gram.autotune import resolve_block_defaults
    return resolve_block_defaults(kind, m, n, dtype,
                                  backend=resolve_device(device).type,
                                  **blocks)


def _pad_to(x: torch.Tensor, mults) -> torch.Tensor:
    """``x`` zero-padded at the end of each axis to a multiple of
    ``mults``, as a contiguous, 16-byte aligned tensor (a kernel reads
    it by pointer: a view is copied, never passed)."""
    if x.ndim != len(mults):
        raise ValueError(f"expected a {len(mults)}-d tensor, got shape "
                         f"{tuple(x.shape)}")
    pads = [(-d) % m for d, m in zip(x.shape, mults)]
    if any(pads):
        x = F.pad(x, [p for pad in reversed(pads) for p in (0, pad)])
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    return x


def matmul(a, b, *, bm=None, bk=None, bn=None, device=None):
    """``a @ b`` via the tiled matmul kernel (``kernels/matmul.py``); any
    shapes, fp32, bf16 or fp16, the result in ``promote_types(a, b)``."""
    a, b = _place(a, device), _place(b, device)
    bs = _resolve_blocks("matmul", a.shape[0], b.shape[-1], a.dtype,
                         a.device, bm=bm, bk=bk, bn=bn)
    bm, bk, bn = bs["bm"], bs["bk"], bs["bn"]
    _launch.check_blocks("matmul", bm=bm, bk=bk, bn=bn)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        # checked before padding, which would hide a mismatched k
        raise ValueError(f"matmul takes (m, k) and (k, n), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    m, n = a.shape[0], b.shape[1]
    out = _matmul.matmul_padded(_pad_to(a, (bm, bk)), _pad_to(b, (bk, bn)),
                                bm=bm, bk=bk, bn=bn)
    return out[:m, :n]


def _syrk_blocks(a: torch.Tensor, bk, bn):
    if a.ndim != 2:
        raise ValueError(f"expected a 2-d tensor, got shape {tuple(a.shape)}")
    bs = _resolve_blocks("ata", a.shape[0], a.shape[1], a.dtype, a.device,
                         bk=bk, bn=bn)
    _launch.check_blocks("syrk", **bs)
    return bs["bk"], bs["bn"]


def syrk_packed(a, *, bk=None, bn=None, device=None):
    """Packed lower-tri block stack of ``a.T @ a`` via the syrk kernel
    (``kernels/syrk.py``), N padded to a multiple of ``bn`` (the caller
    keeps the block layout; :func:`syrk` gives the dense result)."""
    a = _place(a, device)
    bk, bn = _syrk_blocks(a, bk, bn)
    return _syrk.syrk_packed(_pad_to(a, (bk, bn)), bk=bk, bn=bn)


def syrk(a, *, bk=None, bn=None, symmetrize=False, device=None):
    """Dense ``tril(a.T @ a)`` (or the full symmetric product) via the
    packed syrk kernel, in ``a.dtype``."""
    a = _place(a, device)
    bk, bn = _syrk_blocks(a, bk, bn)
    ap = _pad_to(a, (bk, bn))
    n = a.shape[1]
    packed = _syrk.syrk_packed(ap, bk=bk, bn=bn)
    dense = unpack_tril_blocks(packed, ap.shape[1], bn, symmetrize=symmetrize)
    if not symmetrize:
        # diagonal tiles are computed whole: drop their upper halves
        dense = torch.tril(dense)
    return dense[:n, :n]


def strassen_combine(m1, m2, m3, m4, m5, m6, m7, *, bm=256, bn=256,
                     device=None):
    """Fused Strassen recombination -> ``(c11, c12, c21, c22)`` via the
    combine kernel (``kernels/combine.py``)."""
    ms = [_place(x, device) for x in (m1, m2, m3, m4, m5, m6, m7)]
    _launch.check_blocks("combine", bm=bm, bn=bn)
    padded = [_pad_to(x, (bm, bn)) for x in ms]
    m, n = ms[0].shape
    outs = _combine.strassen_combine(*padded, bm=bm, bn=bn)
    return tuple(c[:m, :n] for c in outs)


def transpose(a, *, bm=256, bn=256, device=None):
    """``a.T`` via the tiled transpose kernel (``kernels/transpose.py``);
    any 2- or 4-byte dtype."""
    a = _place(a, device)
    _launch.check_blocks("transpose", bm=bm, bn=bn)
    ap = _pad_to(a, (bm, bn))
    m, n = a.shape
    return _transpose.transpose_padded(ap, bm=bm, bn=bn)[:n, :m]


# ---------------------------------------------------------------------------
# Kernel-backed base cases for the reference recursion.
# ---------------------------------------------------------------------------

def kernel_base_matmul(bm=None, bk=None, bn=None):
    """``base_matmul`` hook for ``core.strassen_matmul`` and ``core.ata``:
    every leaf product through :func:`matmul`, on the device its operands
    lie on.  The counterpart of the JAX package's ``pallas_base_matmul``;
    forward-only.  A hook reads the block defaults of each leaf shape
    once (the JAX package reads them once a trace): a recursion calls it
    once a leaf, and a cache lookup costs host time on each call."""
    chosen = {}

    def base(a, b):
        key = (a.shape, b.shape, a.dtype, a.device)
        if key not in chosen:
            chosen[key] = _resolve_blocks("matmul", a.shape[0],
                                          b.shape[-1], a.dtype, a.device,
                                          bm=bm, bk=bk, bn=bn)
        return matmul(a, b, **chosen[key], device=a.device)
    return base


def kernel_base_syrk(bk=None, bn=None):
    """``base_syrk`` hook for ``core.ata`` (the lower-triangular leaf
    gram): every leaf through :func:`syrk`, on the device its operand
    lies on.  The counterpart of the JAX package's ``pallas_base_syrk``;
    forward-only.  Like :func:`kernel_base_matmul`, it reads each leaf
    shape's block defaults once."""
    chosen = {}

    def base(a):
        key = (a.shape, a.dtype, a.device)
        if key not in chosen:
            chosen[key] = _resolve_blocks("ata", a.shape[0], a.shape[1],
                                          a.dtype, a.device, bk=bk, bn=bn)
        return syrk(a, **chosen[key], symmetrize=False, device=a.device)
    return base


def _gram_blocks(kind, a, device, **blocks) -> tuple:
    """The block edges a fused entry point runs ``a`` at: explicit ones,
    else the autotune cache's for ``a``'s (m, n) bucket and dtype."""
    if all(v is not None for v in blocks.values()):
        return tuple(blocks.values())
    a = torch.as_tensor(a)
    if a.ndim != 2:
        raise ValueError(f"expected a 2-d tensor, got shape {tuple(a.shape)}")
    return tuple(_resolve_blocks(kind, a.shape[0], a.shape[1], a.dtype,
                                 device, **blocks).values())


def ata_fused(a, *, levels=2, variant="strassen", gram="strassen", bk=None,
              bn=None, out_dtype=None, bwd="fused", pipeline_depth=None,
              operand_dtype=None, acc_dtype=None, sr_seed=None, device=None):
    """Dense ``tril(a.T @ a)`` via the fused leaf program.  ``gram`` picks
    the registered symmetric decomposition (``"strassen"`` | ``"dps"``);
    ``bwd`` the backward (``"fused"``: the symm kind on the packed
    cotangent; ``"dense"``: ``a @ (s + s.T)``); the other knobs are
    ``strassen_fused.fused_ata_packed``'s."""
    from . import strassen_fused as _sf
    bk, bn = _gram_blocks("ata", a, device, bk=bk, bn=bn)
    return _sf.fused_ata(
        a, levels=levels, variant=variant, gram=gram, bk=bk,
        bn=bn, out_dtype=out_dtype, bwd=bwd,
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
    bk, bn = _gram_blocks("ata", a, device, bk=bk, bn=bn)
    packed, _ = _sf.fused_ata_packed(
        a, levels=levels, variant=variant, gram=gram, bk=bk,
        bn=bn, out_dtype=out_dtype, bwd=bwd,
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
    (bm,) = _gram_blocks("ata", x, device, bm=bm)
    return _sf.fused_symm_matmul(
        x, s_packed, levels=levels, variant=variant, bm=bm,
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
    if None in (bm, bk, bn):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        m = a.shape[-1] if trans_a else a.shape[0]
        n = b.shape[0] if trans_b else b.shape[-1]
        bs = _resolve_blocks("matmul", m, n, a.dtype, device, bm=bm, bk=bk,
                             bn=bn)
        bm, bk, bn = bs["bm"], bs["bk"], bs["bn"]
    return _sf.fused_matmul(
        a, b, levels=levels, variant=variant, bm=bm, bk=bk,
        bn=bn, trans_a=trans_a, trans_b=trans_b, out_dtype=out_dtype,
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
    bm, bk = _gram_blocks("aat", a, device, bm=bm, bk=bk)
    return _sf.fused_aat(
        a, levels=levels, variant=variant, gram=gram, bm=bm,
        bk=bk, out_dtype=out_dtype, pipeline_depth=pipeline_depth,
        operand_dtype=operand_dtype, acc_dtype=acc_dtype, sr_seed=sr_seed,
        device=device)


def aat_fused_packed(a, *, levels=2, variant="strassen", gram="strassen",
                     bm=None, bk=None, out_dtype=None, pipeline_depth=None,
                     operand_dtype=None, acc_dtype=None, sr_seed=None,
                     device=None):
    """Packed lower-tri block stack of ``a @ a.T`` (the row-gram dual of
    :func:`ata_fused_packed`)."""
    from . import strassen_fused as _sf
    bm, bk = _gram_blocks("aat", a, device, bm=bm, bk=bk)
    packed, _ = _sf.fused_aat_packed(
        a, levels=levels, variant=variant, gram=gram, bm=bm,
        bk=bk, out_dtype=out_dtype, pipeline_depth=pipeline_depth,
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
    (bk,) = _gram_blocks("rank_k", a, device, bk=bk)
    return _sf.fused_rank_k_update(
        c_stack, a, levels=levels, variant=variant, gram=gram,
        bk=bk, out_dtype=out_dtype, pipeline_depth=pipeline_depth,
        operand_dtype=operand_dtype, acc_dtype=acc_dtype, donate=donate,
        device=device)


def flash_mha(q, k, v, *, causal=True, window=0, softcap=0.0, block_q=512,
              block_kv=512, device=None):
    """Flash attention with the (B, S, H, D) layout and any sequence
    lengths, via the flash-attention kernel (``kernels/flash_attention.py``),
    which tiles by ``q_tile`` and ``kv_tile`` and masks the ragged edges
    itself, so nothing is padded for it.  ``block_q`` changes nothing;
    ``block_kv`` (clamped to Skv, at least 16) only decides what the JAX
    package's zero-padding of kv to a block multiple changes: its padded
    kv columns lie past every real query of a causal call with Sq <= Skv,
    but the rows past Skv see them, so kv is padded there as in the JAX
    package; non-causal attention with ragged kv is refused, as there."""
    q, k, v = (_place(x, device) for x in (q, k, v))
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash_mha takes (B, S, H, D) q, k and v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    sq, skv = q.shape[1], k.shape[1]
    bk = min(block_kv, max(skv, 16))
    pk = (-skv) % bk
    if pk and not causal:
        raise NotImplementedError(
            "non-causal flash with ragged kv: pad kv to block multiple at "
            "the call site")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if pk and sq > skv:
        kt, vt = (F.pad(x, (0, 0, 0, pk)) for x in (kt, vt))
    o = _fa.flash_attention(qt, kt, vt, causal=causal, window=window,
                            softcap=softcap)
    return o.transpose(1, 2)
