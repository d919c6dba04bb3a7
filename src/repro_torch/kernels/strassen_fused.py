"""The fused leaf-program executor of the PyTorch port: all five kinds.

The port of the host side of ``repro/kernels/strassen_fused.py``.  A
``LeafProgram`` (``core/leaf_ir.py``) is bound to tile sizes
(:class:`_Spec`) and run by :func:`leaf_program`.  Every program — symm,
matmul and the gram kinds (ata, aat, rank_k) of every gram — is lowered
to twelve op-indexed tables (:func:`_op_tables`) and runs:

* on a CUDA tensor, the hand-written kernel ``csrc/leaf_products.cuh``:
  one thread block per output position, the ops looping inside it, each
  leaf product computed once and added into each of its destinations.
  A program with transposed destinations (the ``dps`` gram's) runs it
  in pair mode: a block owns a position and its mirror, and adds each
  product straight into one and transposed into the other.  Three
  libraries build it (:data:`PRODUCT_LIBRARIES`): fp32 and bf16 operand
  tiles with an fp32 accumulator (``leaf_products.cu``, the main path),
  fp16 and fp8 tiles (``leaf_products_lowp.cu``), and a bf16 or fp64
  accumulator (``leaf_products_acc.cu``);
* on a CPU tensor, the plain torch walk over the same tables
  (:func:`_leaf_products_plain`) — the counterpart of Pallas interpret
  mode, and the plain version the kernel is held against on the card.

The TPU kernel's own walk, destination by destination over the
destination-indexed tables (:func:`_program_tables`), stays as a CPU
oracle (:func:`_leaf_program_plain`).

The program kinds, each with its entry point and its autograd:

* ``ata`` — ``tril(A^t A)`` into the packed lower-triangular tile stack
  (:func:`fused_ata_packed`, :func:`fused_ata`); backward through symm;
* ``symm`` — ``X @ Sym`` with Sym given only as a packed stack, the
  engine of the Gram backward ``dA = A (S + S^t)``
  (:func:`fused_symm_matmul`);
* ``aat`` — the row gram ``tril(A A^t)``, the same A read mirrored on
  the right (:func:`fused_aat_packed`, :func:`fused_aat`); its backward
  is the dense ``(S + S^t) A``, as in the JAX package;
* ``rank_k`` — ``C += tril(A^t A)`` on a packed stack, the incoming
  stack seeding the accumulator (:func:`fused_rank_k_update`); backward
  through symm;
* ``matmul`` — ``op(A) op(B)``, the transposes folded into how each side
  is read (:func:`fused_matmul`); its backward is two more matmul
  launches.

The precision axes are the JAX package's: ``operand_dtype`` stores the
padded operands quantized once (:func:`_quantize`, ``jnp.astype``'s
rounding bit for bit; an fp64 operand is stored as fp32, the type the
TPU kernel computes in), every tile is widened to fp32 before the signed
sums, ``acc_dtype`` picks the accumulator (fp32, or bf16 / fp64 rounded
at the TPU kernel's points), and ``sr_seed`` rounds a bf16 output
stochastically after the fact (:func:`stochastic_round_bf16`).

The analytic traffic models share the executor's geometry, so they
cannot drift from the padding and clamping it runs.
"""
from __future__ import annotations

import ctypes
import functools
import heapq
import math
import warnings
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..core import leaf_ir
from ..core.ata import ata_levels_for
from ..core.leaf_ir import LeafProgram, compile_program
from ..core.strassen import ieee_fp32
from ..core.symmetry import tri_coords, unpack_tril_blocks
from . import _build
from ._launch import ACC_CODES, LEAF_DTYPE_CODES
from .ops import _place

__all__ = ["fused_ata", "fused_ata_packed", "fused_symm_matmul",
           "fused_aat", "fused_aat_packed", "fused_rank_k_update",
           "fused_matmul", "ata_traffic_model", "ata_bwd_traffic_model",
           "aat_traffic_model", "rank_k_traffic_model", "leaf_program",
           "product_flops", "stochastic_round_bf16", "KERNEL_LAUNCHES",
           "LIBRARY_LAUNCHES", "BATCHED_LAUNCHES", "MAX_OPERAND_TERMS",
           "PRODUCT_LIBRARIES", "MAX_PIPELINE_DEPTH", "PRODUCT_TILES",
           "BoundGram"]


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


# Operand fan-in cap: the kernel gathers up to 2 * max_terms operand
# chunks per step into shared memory, so deep programs are clamped.
MAX_OPERAND_TERMS = 8

# Ring depth cap: each slot holds another 2 * max_terms raw chunks (a
# dense right side) or 3 * max_terms (a tri right side: a term may need
# its tile and the mirror).
MAX_PIPELINE_DEPTH = 4

# Shared memory one thread block may use on Hopper (227 KB).
SMEM_LIMIT_BYTES = 232_448

# Operand-tile storage dtypes the JAX executor takes, all of them run by
# the kernel (fp64 stored as fp32)
_SUPPORTED_OPERAND_DTYPES = ("float8_e4m3fn", "float8_e5m2", "bfloat16",
                             "float16", "float32", "float64")

# Accumulators, by name, and the bytes of one value of each
_ACC_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "float64": torch.float64}
_ACC_BYTES = {"float32": 4, "bfloat16": 2, "float64": 8}

# What jnp.astype stores for a NaN, by type: the quiet NaN with the
# input's sign (torch keeps other payloads)
_NAN_BITS = {torch.float8_e4m3fn: 0x7F, torch.float8_e5m2: 0x7E,
             torch.float16: 0x7E00, torch.bfloat16: 0x7FC0}
# The same-width integer type of each, to write those bits
_BITS_OF = {1: torch.uint8, 2: torch.int16}
# e4m3fn has no inf: jnp.astype gives NaN where the nearest-even value
# passes 448 (the largest finite one), i.e. beyond the tie at 464
_E4M3_TIE = 464.0

_KINDS = ("ata", "symm", "aat", "rank_k", "matmul")
# the kinds with a dense output; the gram kinds write a packed stack
_PRODUCT_KINDS = ("symm", "matmul")
_GRAM_KINDS = ("ata", "aat", "rank_k")

# right-side layouts of the C interface: dense K x j, dense j x K (a
# transposed right side), the packed tri stack (symm)
_RIGHT_KJ, _RIGHT_JK, _RIGHT_TRI = 0, 1, 2

# destination flags of the op tables: the op's slot is the first / the
# last to feed that leaf destination, for an element on or below its leaf
# block's diagonal; shifted left by _UPPER, for an element above it
_FIRST, _LAST = 1, 2
_UPPER = 2

#: Block tiles of ``csrc/leaf_products.cu`` (a thread block's TILE x TILE
#: sub-tile of an output tile), in the order the launch prefers them: the
#: first that divides both output tile edges and fits in shared memory.
PRODUCT_TILES = (128, 64)

#: Launches of each CUDA kernel, one count per program kind, bumped where
#: the kernel is launched and nowhere else — a run reads it to show the
#: main path went through it.
KERNEL_LAUNCHES = {f"leaf_program/{kind}": 0 for kind in _KINDS}

#: The libraries of ``csrc/leaf_products.cuh``: fp32 and bf16 operand
#: tiles with an fp32 accumulator, fp16 and fp8 tiles, and a bf16 or fp64
#: accumulator (:func:`_products_library` picks one).
PRODUCT_LIBRARIES = ("leaf_products", "leaf_products_lowp",
                     "leaf_products_acc")

#: The same launches by the library that ran them.
LIBRARY_LAUNCHES = {f"{lib}.cu/{kind}": 0 for lib in PRODUCT_LIBRARIES
                    for kind in _KINDS}

#: The batched launches among them (one launch over a stack of slots, the
#: port of ``jax.vmap`` over the TPU kernel), by program kind.
BATCHED_LAUNCHES = {f"leaf_program/{kind}": 0 for kind in _KINDS}

# (kind, variant, gram, requested, clamped) combinations already warned
# about: the clamp warns exactly once per distinct clamp.
_CLAMP_WARNED: set = set()


def _dtype_name(dt):
    if dt is None:
        return None
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    if isinstance(dt, str):
        return dt
    return np.dtype(dt).name


def _resolve_operand_dtype(operand_dtype):
    name = _dtype_name(operand_dtype)
    if name is None:
        return None
    if name not in _SUPPORTED_OPERAND_DTYPES:
        raise ValueError(
            f"operand_dtype={name!r} is not a supported operand-tile "
            f"storage dtype; pick one of {_SUPPORTED_OPERAND_DTYPES}")
    return getattr(torch, name)


def _resolve_acc_dtype(acc_dtype):
    name = "float32" if acc_dtype is None else _dtype_name(acc_dtype)
    if name not in _ACC_DTYPES:
        raise ValueError(f"acc_dtype={name!r}: the accumulator must be "
                         "float32 (default), bfloat16 or float64")
    return name


def _resolve_sr_seed(sr_seed, out_dtype):
    """Validate the stochastic-rounding knob: SR only targets bf16
    outputs (the accumulator is rounded once, on store)."""
    if sr_seed is None:
        return None
    if out_dtype != torch.bfloat16:
        raise ValueError(
            "sr_seed (stochastic rounding) requires out_dtype=bfloat16, "
            f"got {_dtype_name(out_dtype)}")
    return int(sr_seed)


def _promoted(*dtypes) -> torch.dtype:
    """The JAX package's default output type, ``promote_types(..., f32)``:
    fp64 stays, anything narrower (fp8 included, which torch does not
    promote) gives fp32."""
    return torch.float64 if torch.float64 in dtypes else torch.float32


def _quantize(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` stored as ``dtype``, as ``jnp.astype`` rounds it, bit for bit:
    to nearest even, a NaN stored as JAX stores it, and for e4m3fn (no
    inf) a NaN where the nearest-even value passes 448 or ``x`` is not
    finite, where torch's ``.to`` saturates.  ``float64`` is stored as
    fp32: the TPU kernel upcasts every tile to fp32 before any
    arithmetic, so the round trip through fp64 computes the same.  Plain
    torch: the JAX package quantizes outside any kernel."""
    if dtype == torch.float64 or dtype == torch.float32:
        return x.to(torch.float64).to(torch.float32)
    q = x.to(dtype)
    if dtype not in _NAN_BITS:
        return q
    bad = torch.isnan(x)
    if dtype == torch.float8_e4m3fn:
        bad |= ~torch.isfinite(x) | (x.abs() > _E4M3_TIE)
    if not bool(bad.any()):
        return q
    size = q.element_size()
    pos = _NAN_BITS[dtype]
    neg = pos | 1 << (8 * size - 1)
    if size == 2:           # as a signed int16
        neg -= 1 << 16
    bits_t = _BITS_OF[size]
    nan = torch.where(torch.signbit(x), neg, pos).to(bits_t)
    return torch.where(bad, nan, q.view(bits_t)).view(dtype)


def _stored(x: torch.Tensor, operand_dtype) -> torch.Tensor:
    """A padded operand as the kernel stores it: quantized to
    ``operand_dtype`` where one is given, else as it is, an fp64 one as
    fp32 (the tiles' arithmetic is fp32 either way)."""
    if operand_dtype is not None:
        return _quantize(x, operand_dtype)
    return x.to(torch.float32) if x.dtype == torch.float64 else x


# ---------------------------------------------------------------------------
# Stochastic rounding: fp32 -> bf16 with probability proportional to the
# truncated fraction, so E[SR(x)] == x.  A post-pass on the executor's fp32
# output, as in the JAX package; gradients pass straight through.
# ---------------------------------------------------------------------------

class _SrApply(torch.autograd.Function):
    """``xf`` (fp32) rounded to bf16 by adding the 16-bit ``bits`` below
    the bf16 mantissa boundary and truncating, as the JAX package's
    ``_sr_apply`` does in uint32: a round-up with probability (low 16
    bits) / 2^16, carries rippling into the exponent.  Non-finite values
    round to nearest.  Backward: straight through, the cotangent as
    fp32."""

    @staticmethod
    def forward(ctx, xf, bits):
        # uint32 arithmetic in int64: torch's int32 would overflow and its
        # >> is arithmetic, which would break on the sign bit
        u = xf.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        rounded = ((u + bits.to(torch.int64)) >> 16) & 0xFFFF
        sr = torch.where(rounded >= 1 << 15, rounded - (1 << 16), rounded) \
            .to(torch.int16).view(torch.bfloat16)
        return torch.where(torch.isfinite(xf), sr,
                           _quantize(xf, torch.bfloat16))

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.float32), None


_sr_apply = _SrApply.apply


def stochastic_round_bf16(x: torch.Tensor,
                          generator: torch.Generator) -> torch.Tensor:
    """Stochastically round ``x`` to bfloat16: unbiased, and deterministic
    per ``generator`` state and device (the bits are 16-bit draws from
    it, not the JAX package's threefry bits); non-finite entries round to
    nearest.  The executor applies this on its fp32 output when
    ``sr_seed`` is set, with a generator on the output's device seeded
    with it."""
    xf = x.to(torch.float32)
    bits = torch.randint(0, 1 << 16, xf.shape, generator=generator,
                         device=xf.device, dtype=torch.int32)
    return _sr_apply(xf, bits)


def _sr_round(x: torch.Tensor, sr_seed: int) -> torch.Tensor:
    """The post-pass of an entry point given ``sr_seed``."""
    gen = torch.Generator(device=x.device).manual_seed(sr_seed)
    return stochastic_round_bf16(x, gen)


def _resolve_pipeline_depth(pipeline_depth, device: torch.device) -> int:
    """``None`` picks 2 on the card (the ring streams the next step's
    chunks while the current one computes) and 1 on the CPU, where the
    plain executor has no ring.  Explicit values are always honoured."""
    if pipeline_depth is None:
        return 2 if device.type == "cuda" else 1
    depth = int(pipeline_depth)
    if not 1 <= depth <= MAX_PIPELINE_DEPTH:
        raise ValueError(
            f"pipeline_depth must be in [1, {MAX_PIPELINE_DEPTH}], got "
            f"{pipeline_depth} (each slot rings 2*{MAX_OPERAND_TERMS} "
            "operand chunks in shared memory)")
    return depth


def _resolve_bwd(bwd: str) -> str:
    if bwd not in ("fused", "dense"):
        raise ValueError(f"bwd must be 'fused' or 'dense', got {bwd!r}")
    return bwd


def _warn_fan_in_clamp(kind: str, variant: str, gram: str, requested: int,
                       clamped: int) -> None:
    key = (kind, variant, gram, requested, clamped)
    if key in _CLAMP_WARNED:
        return
    _CLAMP_WARNED.add(key)
    warnings.warn(
        f"fused {kind} schedule: levels={requested} (variant={variant!r}, "
        f"gram={gram!r}) exceeds the MAX_OPERAND_TERMS={MAX_OPERAND_TERMS} "
        f"operand fan-in; clamped to levels={clamped}",
        stacklevel=3)


def _fan_in_clamp(kind: str, levels: int, variant: str,
                  gram: str = "strassen") -> int:
    """Clamp ``levels`` until the program's operand fan-in fits, warning
    once per distinct clamp (the shape-driven clamp above this is
    expected behaviour and stays silent)."""
    prog_kind = "ata" if kind == "rank_k" else kind
    g = gram if prog_kind in ("ata", "aat") else "strassen"
    requested = levels
    while levels > 0 and compile_program(prog_kind, levels, variant,
                                         gram=g).max_terms \
            > MAX_OPERAND_TERMS:
        levels -= 1
    if levels < requested:
        _warn_fan_in_clamp(kind, variant, g, requested, levels)
    return levels


# ---------------------------------------------------------------------------
# Geometry: bind a program kind to concrete shapes/tiles (single source of
# truth shared by the executor and the traffic model).
# ---------------------------------------------------------------------------

def _ata_geometry(m: int, n: int, levels: int, variant: str,
                  bk: int, bn: int, kind: str = "ata",
                  gram: str = "strassen"):
    """Executor/traffic-model geometry for the column-gram kinds.

    Clamps ``levels`` so (a) every leaf block holds at least one (bk, bn)
    tile of real data and (b) the operand fan-in fits (warned once),
    then derives leaf/padded shapes and grid extents.
    """
    levels = min(levels, ata_levels_for(m, n, max(bk, bn)))
    levels = _fan_in_clamp(kind, levels, variant, gram)
    plan = compile_program("rank_k" if kind == "rank_k" else "ata",
                           levels, variant, gram=gram)
    B = plan.blocks
    mb = _round_up(max(m, 1), B * bk) // B     # leaf rows (bk multiple)
    nb = _round_up(max(n, 1), B * bn) // B     # leaf cols (bn multiple)
    M, N = B * mb, B * nb
    t_blocks = N // bn
    return {
        "plan": plan, "levels": levels, "mb": mb, "nb": nb, "M": M, "N": N,
        "n_k": mb // bk, "nbt": nb // bn,
        "n_tri": t_blocks * (t_blocks + 1) // 2,
    }


def _aat_geometry(m: int, n: int, levels: int, variant: str,
                  bm: int, bk: int, gram: str = "strassen"):
    """Geometry for the row-gram (A A^t) kind — the column-gram geometry
    with the roles of the two grids swapped: output tiles tile the *row*
    dimension, the contraction sweeps the columns."""
    levels = min(levels, ata_levels_for(m, n, max(bm, bk)))
    levels = _fan_in_clamp("aat", levels, variant, gram)
    plan = compile_program("aat", levels, variant, gram=gram)
    B = plan.blocks
    mb = _round_up(max(m, 1), B * bm) // B     # leaf rows (bm multiple)
    nb = _round_up(max(n, 1), B * bk) // B     # leaf cols (bk multiple)
    M, N = B * mb, B * nb
    t_blocks = M // bm
    return {
        "plan": plan, "levels": levels, "mb": mb, "nb": nb, "M": M, "N": N,
        "n_k": nb // bk, "nbt": mb // bm,
        "n_tri": t_blocks * (t_blocks + 1) // 2,
    }


def _rank_k_geometry(m: int, T: int, levels: int, variant: str, bk: int,
                     gram: str = "strassen"):
    """Geometry for C += A^t A against an existing packed (T-tile) stack:
    the ata geometry with the column side pinned to the stack layout, so
    levels clamp to divisors of T (like symm)."""
    while levels > 0 and T % (1 << levels):
        levels -= 1
    levels = min(levels, ata_levels_for(m, T, 1))   # never exceed the grid
    levels = _fan_in_clamp("rank_k", levels, variant, gram)
    plan = compile_program("rank_k", levels, variant, gram=gram)
    B = plan.blocks
    mb = _round_up(max(m, 1), B * bk) // B
    return {"plan": plan, "levels": levels, "M": B * mb, "mb": mb,
            "n_k": mb // bk, "nbt": T // B,
            "n_tri": T * (T + 1) // 2}


def _matmul_geometry(m: int, k: int, n: int, levels: int, variant: str,
                     bm: int, bk: int, bn: int, trans_a: bool = False,
                     trans_b: bool = False):
    """Geometry for C = op(A) op(B), (m, k) x (k, n): the generic
    per-axis level clamp (``strassen_levels_for`` at (2, 2, 2)) — stop
    splitting once the smallest leaf axis reaches tile size — then the
    fan-in clamp, and each axis padded to its own leaf grid (bb322 and
    bb422 split m three and four ways)."""
    dm, dk, dn = leaf_ir.algebra_dims(variant)
    leaf, lv = max(bm, bk, bn), 0
    cm, ck, cn = m, k, n
    while min(cm, ck, cn) > leaf:
        cm, ck, cn = cm // dm, ck // dk, cn // dn
        lv += 1
    levels = _fan_in_clamp("matmul", min(levels, lv), variant)
    plan = compile_program("matmul", levels, variant, trans_a=trans_a,
                           trans_b=trans_b)
    Bm, Bk, Bn = plan.blocks_m, plan.blocks_k, plan.blocks_n
    mb = _round_up(max(m, 1), Bm * bm) // Bm
    kb = _round_up(max(k, 1), Bk * bk) // Bk
    nb = _round_up(max(n, 1), Bn * bn) // Bn
    return {"plan": plan, "levels": levels, "M": Bm * mb, "K": Bk * kb,
            "N": Bn * nb, "nbm": mb // bm, "nbn": nb // bn, "n_k": kb // bk}


def _symm_geometry(m: int, T: int, levels: int, variant: str, bm: int):
    """Level clamp + padded-row geometry for the symm executor (shared
    with ``ata_bwd_traffic_model``).  ``T`` is the packed stack's tile
    count per side; the column side cannot be padded (the stack layout is
    fixed), so levels clamp to divisors of T.  Rectangular variants pad
    rows to their own ``blocks_m`` grid while T divides ``blocks_n``."""
    dn = leaf_ir.algebra_dims(variant)[2]
    while levels > 0 and T % (dn ** levels):
        levels -= 1
    levels = _fan_in_clamp("symm", levels, variant)
    plan = compile_program("symm", levels, variant)
    bm_blocks = plan.blocks_m
    mb = _round_up(max(m, 1), bm_blocks * bm) // bm_blocks
    return {"plan": plan, "levels": levels, "M": bm_blocks * mb,
            "nbm": mb // bm, "q": T // plan.blocks_n}


# ---------------------------------------------------------------------------
# Binding: a program + concrete tiles/grid, as a static (hashable) spec.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _Spec:
    """Static binding of a LeafProgram to tiles and a flattened grid.

    The walk is ``(n_out, n_c, n_k)``: output tiles (tri-decoded for
    packed outputs), the padded contribution sweep, and the K sweep.
    ``q_i``/``q_j`` are output tiles per leaf block along each output
    dim; ``bi``/``bj`` the output tile edges; ``bc`` the contraction
    tile edge.
    """
    kind: str
    levels: int
    variant: str
    gram: str                   # gram-algebra entry (gram kinds)
    trans_a: bool               # matmul-only operand-spec transposes
    trans_b: bool
    tmax: int
    n_c: int
    n_k: int
    n_out: int
    n_tj: int                   # dense outputs: tiles along j (0 for tri)
    q_i: int
    q_j: int
    blocks_j: int               # dense outputs: leaf blocks along j
    bi: int
    bj: int
    bc: int
    out_tri: bool
    left_trans: bool
    right_trans: bool
    right_tri: bool
    diag_sym: bool
    accumulate: bool
    pipeline_depth: int = 1     # cp.async ring slots (1 = load, then compute)
    acc_dtype: str = "float32"  # accumulator dtype (name)

    @property
    def grid_steps(self) -> int:
        return self.n_out * self.n_c * self.n_k


def _bind(prog: LeafProgram, *, n_out, n_tj, q_i, q_j, n_k, bi, bj, bc,
          diag_sym=False, pipeline_depth=1,
          acc_dtype="float32") -> _Spec:
    ls, rs, os_ = prog.left_spec, prog.right_spec, prog.out_spec
    return _Spec(
        kind=prog.kind, levels=prog.levels, variant=prog.variant,
        gram=prog.gram,
        trans_a=ls.transpose if prog.kind == "matmul" else False,
        trans_b=rs.transpose if prog.kind == "matmul" else False,
        tmax=prog.max_terms, n_c=prog.max_contributions, n_k=n_k,
        n_out=n_out, n_tj=n_tj, q_i=q_i, q_j=q_j,
        blocks_j=prog.out_blocks[1],
        bi=bi, bj=bj, bc=bc,
        out_tri=os_.packing == "tri",
        left_trans=ls.transpose, right_trans=rs.transpose,
        right_tri=rs.layout == "tri",
        diag_sym=diag_sym, accumulate=os_.accumulate,
        pipeline_depth=pipeline_depth, acc_dtype=acc_dtype)


# ---------------------------------------------------------------------------
# The lowered tables: the program as arrays indexed by (leaf destination,
# contribution slot[, term slot]) — int32 index tables, float32
# coefficient tables (dps's +-1/2, +-1/4 must survive lowering).  Empty
# slots carry coefficient 0 (the kernel skips them) and index block
# (0, 0).  rtrn marks the per-term mirrors of a tri-stored right operand
# (the symm kind); it is lowered for every kind.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _program_tables(kind: str, levels: int, variant: str,
                    gram: str = "strassen",
                    trans_a: bool = False, trans_b: bool = False):
    prog = compile_program(kind, levels, variant, gram=gram,
                           trans_a=trans_a, trans_b=trans_b)
    n_dest, n_c, tmax = prog.n_dests(), prog.max_contributions, \
        prog.max_terms
    sign = np.zeros((n_dest, n_c), np.float32)
    lrow = np.zeros((n_dest, n_c, tmax), np.int32)
    lcol = np.zeros_like(lrow)
    lsgn = np.zeros((n_dest, n_c, tmax), np.float32)
    rrow = np.zeros_like(lrow)
    rcol = np.zeros_like(lrow)
    rsgn = np.zeros_like(lsgn)
    rtrn = np.zeros_like(lrow)
    for (di, dj), contribs in prog.by_dest().items():
        ld = prog.dest_index(di, dj)
        for s, contrib in enumerate(contribs):
            sign[ld, s] = contrib.sign
            for p, (r, c, sg, tr) in enumerate(contrib.left):
                assert tr == 0, "per-term left transposes are not lowered"
                lrow[ld, s, p], lcol[ld, s, p], lsgn[ld, s, p] = r, c, sg
            for q, (r, c, sg, tr) in enumerate(contrib.right):
                rrow[ld, s, q], rcol[ld, s, q] = r, c
                rsgn[ld, s, q], rtrn[ld, s, q] = sg, tr
    return sign, lrow, lcol, lsgn, rrow, rcol, rsgn, rtrn


@functools.lru_cache(maxsize=None)
def _device_tables(kind: str, levels: int, variant: str, gram: str,
                   device: str, trans_a: bool = False,
                   trans_b: bool = False):
    """The lowered tables as tensors on ``device``, uploaded once."""
    return tuple(torch.from_numpy(t).to(device)
                 for t in _program_tables(kind, levels, variant, gram,
                                          trans_a, trans_b))


def _spec_tables(spec: _Spec, device) -> tuple:
    """The device tables of the program ``spec`` binds."""
    return _device_tables(spec.kind, spec.levels, spec.variant, spec.gram,
                          str(device), spec.trans_a, spec.trans_b)


@functools.lru_cache(maxsize=None)
def _op_tables(kind: str, levels: int, variant: str, gram: str = "strassen",
               trans_a: bool = False, trans_b: bool = False):
    """The program as op-indexed tables, what ``csrc/leaf_products.cu``
    walks: per leaf op (``LeafProgram.ops`` order) its left terms ``lrow,
    lcol, lsgn`` and right terms ``rrow, rcol, rsgn, rtrn`` (``[n_ops,
    tmax]``), its destinations in the op's order (``[n_ops, max_dests]``):
    ``dest`` (leaf index), ``dsgn`` (sign), ``dflag`` and ``dtrn`` (the
    destination takes the op's product transposed, which only the gram
    kinds' ``dps`` programs emit), and ``odiag`` (``[n_ops]``, packed
    outputs only: every destination of the op is a straight one on a
    diagonal leaf block, so a position above the diagonal of a leaf block
    skips it).  Empty slots carry coefficient or sign 0 and come last in
    their row, which the kernel counts on.

    The order in which an element ``(r, c)`` of a leaf block (in the leaf
    block's coordinates) takes its contributions: the ops in op order;
    within an op, where ``r >= c`` its straight slots then its transposed
    ones, where ``r < c`` the transposed ones first, each in table order.
    ``dflag`` marks a slot ``_FIRST`` (no earlier contribution feeds that
    destination) and ``_LAST`` (no later one does) in the order of an
    element on or below the diagonal, and the same shifted left by
    ``_UPPER`` in the order of an element above it.  Since ``by_dest``
    sorts stably, a destination's slots in op order, the transposed ones
    with their sides swapped, are exactly its slots in
    :func:`_program_tables`.

    A destination that no op feeds is refused (the kernel stores where a
    destination is first fed)."""
    prog = compile_program(kind, levels, variant, gram=gram,
                           trans_a=trans_a, trans_b=trans_b)
    n_ops, tmax = len(prog.ops), prog.max_terms
    max_dests = max(len(op.dests) for op in prog.ops)
    lrow = np.zeros((n_ops, tmax), np.int32)
    lcol, rrow, rcol, rtrn = (np.zeros_like(lrow) for _ in range(4))
    lsgn = np.zeros((n_ops, tmax), np.float32)
    rsgn = np.zeros_like(lsgn)
    dest = np.zeros((n_ops, max_dests), np.int32)
    dflag, dtrn = np.zeros_like(dest), np.zeros_like(dest)
    dsgn = np.zeros((n_ops, max_dests), np.float32)
    odiag = np.zeros(n_ops, np.int32)
    tri = prog.out_spec.packing == "tri"
    for o, op in enumerate(prog.ops):
        for p, (r, c, sg, tr) in enumerate(op.left):
            assert tr == 0, "per-term left transposes are not lowered"
            lrow[o, p], lcol[o, p], lsgn[o, p] = r, c, sg
        for q, (r, c, sg, tr) in enumerate(op.right):
            rrow[o, q], rcol[o, q], rsgn[o, q], rtrn[o, q] = r, c, sg, tr
        for d, (di, dj, sg, tr) in enumerate(op.dests):
            if tr and kind not in _GRAM_KINDS:
                raise ValueError(f"the {kind} program has a transposed "
                                 "destination; only the gram kinds take one")
            dest[o, d], dsgn[o, d], dtrn[o, d] = prog.dest_index(di, dj), \
                sg, tr
        odiag[o] = tri and all(di == dj and not tr
                               for di, dj, _, tr in op.dests)
    for shift, first_trn in ((0, 0), (_UPPER, 1)):
        last = {}
        for o, op in enumerate(prog.ops):
            for trn in (first_trn, 1 - first_trn):
                for d in range(len(op.dests)):
                    if dtrn[o, d] != trn:
                        continue
                    if dest[o, d] not in last:
                        dflag[o, d] |= _FIRST << shift
                    last[dest[o, d]] = (o, d)
        for o, d in last.values():
            dflag[o, d] |= _LAST << shift
    if len(last) != prog.n_dests():
        raise ValueError(f"{prog.n_dests() - len(last)} destinations of the "
                         f"{kind} program get no contribution")
    return (lrow, lcol, lsgn, rrow, rcol, rsgn, rtrn, dest, dsgn, dflag,
            dtrn, odiag)


@functools.lru_cache(maxsize=None)
def _device_op_tables(kind: str, levels: int, variant: str, gram: str,
                      device: str, trans_a: bool = False,
                      trans_b: bool = False):
    """The op tables as tensors on ``device``, uploaded once."""
    return tuple(torch.from_numpy(t).to(device)
                 for t in _op_tables(kind, levels, variant, gram, trans_a,
                                     trans_b))


# a re-registered algebra table must invalidate the lowered tables too —
# compile_program.cache_clear() alone would leave these stale
leaf_ir.on_algebra_change(_program_tables.cache_clear)
leaf_ir.on_algebra_change(_device_tables.cache_clear)
leaf_ir.on_algebra_change(_op_tables.cache_clear)
leaf_ir.on_algebra_change(_device_op_tables.cache_clear)


# ---------------------------------------------------------------------------
# The executor: the CUDA kernel and its plain version.
# ---------------------------------------------------------------------------

def _out_tiles(spec: _Spec, device):
    """Per output tile of a packed (gram-kind) output: leaf destination
    ``ld`` and global tile coords ``(gi, gj)``, the kernel's tri-decode,
    for all tiles."""
    ij = tri_coords(spec.q_i * spec.blocks_j).long().to(device)
    gi, gj = ij[:, 0], ij[:, 1]
    di, dj = gi // spec.q_i, gj // spec.q_j
    return di * (di + 1) // 2 + dj, gi, gj


def _operand_shapes(spec: _Spec):
    """Stored tile shapes of the left and right operands: ``K x i`` or
    ``i x K`` on the left; on the right the stack's ``(bs, bs)`` tiles,
    ``j x K`` (a transposed dense side) or ``K x j``."""
    l_shape = (spec.bc, spec.bi) if spec.left_trans else (spec.bi, spec.bc)
    if spec.right_tri:
        r_shape = (spec.bj, spec.bj)
    elif spec.right_trans:
        r_shape = (spec.bj, spec.bc)
    else:
        r_shape = (spec.bc, spec.bj)
    return l_shape, r_shape


def _out_shape(spec: _Spec):
    """The raw output buffer: the packed tri stack, or the dense grid."""
    if spec.out_tri:
        return spec.n_out * spec.bi, spec.bj
    return (spec.n_out // spec.n_tj) * spec.bi, spec.n_tj * spec.bj


def _tiles(x: torch.Tensor, r: int, c: int) -> torch.Tensor:
    """(rows // r, cols // c, r, c) view of the (r, c) tiles of ``x``."""
    return x.reshape(x.shape[0] // r, r, x.shape[1] // c, c) \
        .permute(0, 2, 1, 3)


def _leaf_program_plain(spec: _Spec, tables, left: torch.Tensor,
                        right: torch.Tensor, out_dtype,
                        seed: torch.Tensor | None = None) -> torch.Tensor:
    """The TPU kernel's own walk, in plain torch: a CPU oracle that the op
    walk (:func:`_leaf_products_plain`, ``csrc/leaf_products.cu``) is held
    against.  It takes any gram program, over the destination-indexed
    tables (:func:`_program_tables`), and walks output tiles the TPU
    kernel's way (contributions, then K blocks), over every output tile
    at once, recomputing a leaf product for every destination it feeds.

    The accumulator, of ``spec.acc_dtype``, starts from ``seed`` (the
    incoming stack of an accumulating program, cast to it) or from zero.
    Per (contribution, K block) step it gathers each term's tile for all
    output tiles and forms the signed sums in fp32, term by term in
    table order: the tile upcast, times its coefficient, added to the
    running sum; a transposed side flips its sum once.  Then it adds
    ``sign * (L @ R)``, computed in fp32 and rounded to the accumulator's
    type, where the sign is not 0 (``acc += contrib.astype(acc)``).
    """
    if spec.kind not in _GRAM_KINDS:
        raise ValueError(f"the destination walk takes the gram kinds, not "
                         f"{spec.kind!r}")
    sign, lrow, lcol, lsgn, rrow, rcol, rsgn, _ = tables
    ld, gi, gj = _out_tiles(spec, left.device)
    iq, jq = gi % spec.q_i, gj % spec.q_j
    l_shape, r_shape = _operand_shapes(spec)
    ltiles = _tiles(left, *l_shape)
    rtiles = _tiles(right, *r_shape)

    def add(acc, term):
        return term if acc is None else acc + term

    def left_sum(c, k):
        acc = None
        for p in range(spec.tmax):
            r, col = lrow[ld, c, p].long(), lcol[ld, c, p].long()
            tile = ltiles[r * spec.n_k + k, col * spec.q_i + iq] \
                if spec.left_trans \
                else ltiles[r * spec.q_i + iq, col * spec.n_k + k]
            acc = add(acc, tile.float() * lsgn[ld, c, p][:, None, None])
        return acc.transpose(1, 2) if spec.left_trans else acc

    def right_sum(c, k):
        acc = None
        for p in range(spec.tmax):
            r, col = rrow[ld, c, p].long(), rcol[ld, c, p].long()
            if spec.right_trans:
                tile = rtiles[r * spec.q_j + jq, col * spec.n_k + k].float()
            else:
                tile = rtiles[r * spec.n_k + k, col * spec.q_j + jq].float()
            acc = add(acc, tile * rsgn[ld, c, p][:, None, None])
        return acc.transpose(1, 2) if spec.right_trans else acc

    acc_t = _ACC_DTYPES[spec.acc_dtype]
    if seed is None:
        acc = torch.zeros((spec.n_out, spec.bi, spec.bj), dtype=acc_t,
                          device=left.device)
    else:           # the incoming packed stack of rank_k, a tri output
        acc = seed.reshape(spec.n_out, spec.bi, spec.bj).to(acc_t,
                                                            copy=True)
    with ieee_fp32():
        for c in range(spec.n_c):
            sgn = sign[ld, c][:, None, None]
            for k in range(spec.n_k):
                contrib = sgn * torch.bmm(left_sum(c, k), right_sum(c, k))
                acc += torch.where(sgn != 0, contrib, 0.0).to(acc_t)
    return acc.reshape(_out_shape(spec)).to(out_dtype)


def _spec_op_tables(spec: _Spec, device=None) -> tuple:
    """The op tables of the program ``spec`` binds: numpy arrays, or
    tensors on ``device``."""
    key = (spec.kind, spec.levels, spec.variant, spec.gram)
    if device is None:
        return _op_tables(*key, spec.trans_a, spec.trans_b)
    return _device_op_tables(*key, str(device), spec.trans_a, spec.trans_b)


def _leaf_products_plain(spec: _Spec, left: torch.Tensor,
                         right: torch.Tensor, out_dtype,
                         seed: torch.Tensor | None = None) -> torch.Tensor:
    """The plain torch version of ``csrc/leaf_products.cuh``: the op
    tables, the kernel's walk, every output position at once.

    A position is an output tile ``(iq, jq)`` of a leaf block (the
    kernel's positions are its sub-tiles, which share the arithmetic).
    Per op, per K block it forms each side's signed sum in fp32 for the
    op's positions, term by term in table order (the tile upcast,
    mirrored where a tri-stored term says so, ``tile + tile^t`` on a
    diagonal tile under ``diag_sym``, times its coefficient, added to the
    running sum; a transposed side flips its sum once) and adds one
    ``torch.bmm`` into the op's product.  Then it adds ``sign * product``
    into each of the op's destinations, storing (onto the seed, the
    incoming packed stack of rank_k, where there is one) where the slot
    is the first to feed one.  A transposed destination (the ``dps``
    gram's) takes at ``(iq, jq)`` the transpose of the product at the
    mirror position ``(jq, iq)``, in :func:`_op_tables`' element order:
    an element on or below its leaf block's diagonal takes an op's
    straight slots first, one above it the transposed ones.  So each leaf
    product is computed once: ``n_ops * n_k`` bmm calls.

    The accumulator is of ``spec.acc_dtype``.  An fp32 one takes each
    op's product once, as above; a bf16 or fp64 one takes each K block's
    ``sign * part`` rounded to its type, the sum rounded in it, K block
    by K block (every K block of a slot before the next slot of an
    element), where the kernel does (``acc += contrib.astype(acc)``), the
    seed cast to it first.

    A packed output (the gram kinds) holds tile ``(iq, jq)`` of a
    diagonal leaf block only where ``iq >= jq``: an op that feeds only
    diagonal leaf blocks, straight, runs at those positions alone, as in
    the kernel, and the packed stack is gathered from the positions at
    the end.
    """
    (lrow, lcol, lsgn, rrow, rcol, rsgn, rtrn, dest, dsgn, dflag, dtrn,
     odiag) = _spec_op_tables(spec)
    dev = left.device
    q_i, q_j, n_k = spec.q_i, spec.q_j, spec.n_k
    pos = torch.arange(q_i * q_j, device=dev)
    every = (pos // q_j, pos % q_j, pos)
    heavy = pos[pos // q_j >= pos % q_j]
    heavy = (heavy // q_j, heavy % q_j, heavy)
    l_shape, r_shape = _operand_shapes(spec)
    ltiles = _tiles(left, *l_shape)
    rtiles = right.reshape(-1, *r_shape) if spec.right_tri \
        else _tiles(right, *r_shape)
    if dtrn.any():      # a gram program: square positions and tiles
        iq, jq, _ = every
        mirror = jq * q_j + iq
        # the elements of each position on or below the leaf block's
        # diagonal
        lower = torch.where(
            (iq == jq)[:, None, None],
            torch.ones(spec.bi, spec.bj, dtype=torch.bool,
                       device=dev).tril(),
            (iq > jq)[:, None, None])

    def signed_sum(tile_of, rows, cols, coefs):
        acc = None
        for p, coef in enumerate(coefs):
            if coef == 0:
                continue
            term = tile_of(p, int(rows[p]), int(cols[p])).float() \
                * float(coef)
            acc = term if acc is None else acc + term
        return acc

    def left_sum(o, k, iq):
        def tile_of(_, r, c):
            return ltiles[r * n_k + k, c * q_i + iq] if spec.left_trans \
                else ltiles[r * q_i + iq, c * n_k + k]
        acc = signed_sum(tile_of, lrow[o], lcol[o], lsgn[o])
        return acc.transpose(1, 2) if spec.left_trans else acc

    def right_sum(o, k, jq):
        def tile_of(p, r, c):
            if spec.right_tri:
                # conceptual tile coords as _tri_term_coords; the stored
                # tile is (max, min), mirrored when the read lies above
                # the diagonal or the term itself is mirrored
                trn, kk = bool(rtrn[o, p]), torch.full_like(jq, k)
                gr = r * q_j + (jq if trn else kk)
                gc = c * q_j + (kk if trn else jq)
                fr, fc = torch.maximum(gr, gc), torch.minimum(gr, gc)
                tile = rtiles[fr * (fr + 1) // 2 + fc].float()
                mirrored = (gr < gc)[:, None, None] | trn
                tile = torch.where(mirrored, tile.transpose(1, 2), tile)
                if spec.diag_sym:
                    tile = torch.where((gr == gc)[:, None, None],
                                       tile + tile.transpose(1, 2), tile)
                return tile
            if spec.right_trans:
                return rtiles[r * q_j + jq, c * n_k + k]
            return rtiles[r * n_k + k, c * q_j + jq]
        acc = signed_sum(tile_of, rrow[o], rcol[o], rsgn[o])
        return acc.transpose(1, 2) if spec.right_trans else acc

    n_dest = int(dest.max()) + 1          # _op_tables: every one is fed
    acc_t = _ACC_DTYPES[spec.acc_dtype]
    acc = torch.zeros((n_dest, len(pos), spec.bi, spec.bj), dtype=acc_t,
                      device=dev)
    start = None            # the seed at each (leaf destination, position)
    if spec.out_tri:        # each stack tile: its leaf destination, position
        ld, gi, gj = _out_tiles(spec, dev)
        held = (ld, (gi % q_i) * q_j + gj % q_j)
        if seed is not None:
            start = torch.zeros_like(acc)
            start[held] = seed.reshape(spec.n_out, spec.bi, spec.bj).to(acc_t)

    def add(o, d, at, term, flag, where=None):
        """Slot d of op o adds ``term`` (fp32, rounded to the accumulator's
        type) at positions ``at``, onto the seed where ``flag`` says it is
        the first; only ``where`` if given."""
        ld = int(dest[o, d])
        term = term.to(acc_t)
        if flag & _FIRST:
            new = term if start is None else start[ld, at] + term
        else:
            new = acc[ld, at] + term
        acc[ld, at] = new if where is None \
            else torch.where(where, new, acc[ld, at])

    with ieee_fp32():
        for o in range(len(lrow)):
            iq, jq, at = heavy if spec.out_tri and odiag[o] else every
            parts = [torch.bmm(left_sum(o, k, iq), right_sum(o, k, jq))
                     for k in range(n_k)]
            if acc_t == torch.float32:      # the op's product, once
                prod = torch.zeros_like(parts[0])
                for part in parts:
                    prod += part
                terms = [(prod, _FIRST | _LAST)]
            else:   # each K block's part; a slot's flags hold at its ends
                terms = [(part, (_FIRST if k == 0 else 0)
                          | (_LAST if k == n_k - 1 else 0))
                         for k, part in enumerate(parts)]
            slots = np.flatnonzero(dsgn[o])
            if not dtrn[o].any():
                for d in slots:
                    for val, keep in terms:
                        add(o, d, at, val * float(dsgn[o, d]),
                            dflag[o, d] & keep)
                continue
            # both halves of each position in their own order: straight
            # slots first on and below the diagonal, transposed above
            straight = [d for d in slots if not dtrn[o, d]]
            mirrored = [d for d in slots if dtrn[o, d]]
            for half, order in ((lower, straight + mirrored),
                                (~lower, mirrored + straight)):
                shift = 0 if half is lower else _UPPER
                for d in order:
                    for val, keep in terms:
                        if dtrn[o, d]:
                            val = val[mirror].transpose(1, 2)
                        add(o, d, at, val * float(dsgn[o, d]),
                            (dflag[o, d] >> shift) & keep, half)
    if spec.out_tri:
        return acc[held].reshape(_out_shape(spec)).to(out_dtype)
    blocks_i = acc.shape[0] // spec.blocks_j
    out = acc.reshape(blocks_i, spec.blocks_j, q_i, q_j, spec.bi, spec.bj) \
        .permute(0, 2, 4, 1, 3, 5)
    return out.reshape(_out_shape(spec)).to(out_dtype)


# The operand types the kernel stores (an fp64 operand is stored as fp32),
# and the mixed pairs leaf_products.cu takes besides same-type ones
_OPERAND_TYPES = (torch.float32, torch.bfloat16, torch.float16,
                  torch.float8_e4m3fn, torch.float8_e5m2)
_MIXED_PAIRS = {(torch.float32, torch.bfloat16),
                (torch.bfloat16, torch.float32)}
# The types the seed and the output may have
_VALUE_TYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)


@functools.cache
def _products_lib(name: str = "leaf_products") -> ctypes.CDLL:
    """One library of ``csrc/leaf_products.cuh`` (``PRODUCT_LIBRARIES``),
    built at first use; all three share the C interface."""
    lib = _build.library(name)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.leaf_products_launch.argtypes = [ptr] * 17 + [i64] * 4 + [i32] * 25 \
        + [ptr]
    lib.leaf_products_launch.restype = i32
    lib.leaf_products_batched_launch.argtypes = [ptr] * 16 + [i64] * 4 \
        + [i32] * 20 + [i64, i64, i32, ptr, ptr]
    lib.leaf_products_batched_launch.restype = i32
    lib.leaf_products_batched_blocks_per_sm.argtypes = [i32] * 4
    lib.leaf_products_batched_blocks_per_sm.restype = i32
    lib.leaf_products_batched_smem_bytes.argtypes = [i32] * 4
    lib.leaf_products_batched_smem_bytes.restype = ctypes.c_size_t
    lib.leaf_products_smem_bytes.argtypes = [i32] * 9
    lib.leaf_products_smem_bytes.restype = ctypes.c_size_t
    lib.leaf_products_blocks_per_sm.argtypes = [i32] * 9
    lib.leaf_products_blocks_per_sm.restype = i32
    lib.leaf_products_whole_positions.argtypes = [i32] * 8 + [i64]
    lib.leaf_products_whole_positions.restype = i64
    lib.leaf_products_ring_depth.argtypes = [i32]
    lib.leaf_products_ring_depth.restype = i32
    lib.leaf_products_error_string.argtypes = [i32]
    lib.leaf_products_error_string.restype = ctypes.c_char_p
    return lib


def _kernel_types(left_dtype, right_dtype, acc_dtype: str):
    """The types the kernel stores a launch's two sides in: fp64 as fp32,
    and a pair no library instantiates (fp16 beside fp32, say, or a mixed
    pair under a bf16 or fp64 accumulator) both as fp32.  Each is exact
    and changes no bit: every tile is widened to fp32 before any
    arithmetic."""
    lt, rt = (torch.float32 if t == torch.float64 else t
              for t in (left_dtype, right_dtype))
    if lt == rt and lt in _OPERAND_TYPES:
        return lt, rt
    if acc_dtype == "float32" and (lt, rt) in _MIXED_PAIRS:
        return lt, rt
    return torch.float32, torch.float32


def _products_library(acc_dtype: str, left_dtype) -> str:
    """The library that runs a launch whose left side is stored as
    ``left_dtype`` (after :func:`_kernel_types`)."""
    if acc_dtype != "float32":
        return "leaf_products_acc"
    if left_dtype in (torch.float16, torch.float8_e4m3fn,
                      torch.float8_e5m2):
        return "leaf_products_lowp"
    return "leaf_products"


def ring_depth(spec: _Spec) -> int:
    """The ring depth a launch of ``spec`` runs at: its
    ``pipeline_depth``, except that a bf16 or fp64 accumulator runs one
    depth for every request (depth changes no bit; one instantiation
    serves)."""
    lib = _products_library(spec.acc_dtype, torch.float32)
    return _products_lib(lib).leaf_products_ring_depth(spec.pipeline_depth)


def run_dests(spec: _Spec, tile: int, base_smem: int) -> int:
    """How many slots of each op a launch of ``spec`` at ``tile`` keeps
    its running sums of on chip, ``Ops::n_run`` of ``csrc/leaf_products.cuh``:
    under a bf16 or fp64 accumulator (each K block's part rounded into the
    destination) an op's first ``run_dests`` slots hold their
    destinations' running values in shared memory from the op's first K
    block to its last, ``tile**2`` values each, and the others read and
    write the workspace every K block.  As many as fit in the shared
    memory a block can use beside the ``base_smem`` bytes of its ring and
    sums, at most the widest op's; 0 for an fp32 accumulator, which adds
    each op's product once.  Where they live changes no bit."""
    if spec.acc_dtype == "float32":
        return 0
    per = tile * tile * _ACC_BYTES[spec.acc_dtype]
    max_dests = _spec_op_tables(spec)[7].shape[1]
    return max(0, min(max_dests, (SMEM_LIMIT_BYTES - base_smem) // per))


def kept_slots(spec: _Spec, n_run: int) -> np.ndarray:
    """``[n_ops, max_dests]``: the slots (op, destination) whose running
    values a launch at ``n_run`` (:func:`run_dests`) keeps on chip, an
    op's first ``n_run`` live ones; the other live slots go through the
    workspace every K block."""
    dsgn = _spec_op_tables(spec)[8]
    return (dsgn != 0) & (np.arange(dsgn.shape[1]) < n_run)


def _products_base_smem(spec: _Spec, tile: int, left_bytes: int,
                        right_bytes: int) -> int:
    """A launch's shared memory without running values: ring, sums and
    the per-slot terms."""
    lib = _products_library(spec.acc_dtype, torch.float32)
    return _products_lib(lib).leaf_products_smem_bytes(
        int(spec.right_tri), spec.tmax, tile, left_bytes, right_bytes,
        spec.pipeline_depth, int(_pairs(spec)), ACC_CODES[spec.acc_dtype], 0)


def _products_run_dests(spec: _Spec, tile: int, left_bytes: int,
                        right_bytes: int) -> int:
    return run_dests(spec, tile, _products_base_smem(spec, tile, left_bytes,
                                                     right_bytes))


def _products_smem(spec: _Spec, tile: int, left_bytes: int,
                   right_bytes: int) -> int:
    base = _products_base_smem(spec, tile, left_bytes, right_bytes)
    return base + run_dests(spec, tile, base) * tile * tile \
        * _ACC_BYTES[spec.acc_dtype]


def _products_tile(spec: _Spec, left_bytes: int, right_bytes: int) -> int:
    """The block tile a ``leaf_products`` launch takes: the first of
    ``PRODUCT_TILES`` that divides both output tile edges and fits in
    shared memory at this depth, else the smallest."""
    for tile in PRODUCT_TILES:
        if spec.bi % tile == 0 and spec.bj % tile == 0 and _products_smem(
                spec, tile, left_bytes, right_bytes) <= SMEM_LIMIT_BYTES:
            return tile
    return PRODUCT_TILES[-1]


def smem_bytes(spec: _Spec, left_bytes: int, right_bytes: int,
               tile: int | None = None) -> int:
    """Dynamic shared memory one ``leaf_products`` launch of ``spec``
    needs at ``tile``, by default the one the launch takes, as its kernel
    lays it out (the wrapper refuses more than ``SMEM_LIMIT_BYTES``)."""
    if tile is None:
        tile = _products_tile(spec, left_bytes, right_bytes)
    return _products_smem(spec, tile, left_bytes, right_bytes)


def _pairs(spec: _Spec) -> bool:
    """Whether ``leaf_products.cu`` runs ``spec`` in pair mode: its
    program has a transposed destination (the ``dps`` gram's)."""
    return bool(_spec_op_tables(spec)[10].any())


def _positions(spec: _Spec, tile: int, batch: int = 1) -> int:
    """Output positions of a launch at block tile ``tile``: a tile x tile
    sub-tile of an output tile of a leaf block, of every slot."""
    return spec.q_i * spec.q_j * -(-spec.bi // tile) * -(-spec.bj // tile) \
        * batch


def _live_positions(spec: _Spec, tile: int, batch: int = 1) -> int:
    """The positions of a launch that write something, the first ones in
    the kernel's order: all of them, unless every op feeds only diagonal
    leaf blocks of a packed output (a program of levels 0), whose
    positions above a leaf block's diagonal come last and write
    nothing."""
    if spec.out_tri and _spec_op_tables(spec)[-1].all():
        q = spec.q_i
        return q * (q + 1) // 2 * -(-spec.bi // tile) * -(-spec.bj // tile) \
            * batch
    return _positions(spec, tile, batch)


# The batched kernel's chunk depth at each tile (csrc ``batched_kc``), and
# the time of one block's step there relative to a tile-128 step:
# chip_smoke.py phase 4m's times at both tiles over their makespans, 1.03-
# 1.11 on an H100 (PERF.md)
BATCHED_KC = {128: 16, 64: 32}
BATCHED_STEP_COST = {128: 1.0, 64: 1.08}


def _batched_makespan(spec: _Spec, batch: int, tile: int,
                      blocks: int) -> int:
    """Steps (chunks) of the busiest of ``blocks`` blocks that take a
    launch's items at ``tile`` heaviest first, each block free the next
    item: the heavy items (every op) first, then the light ones (above a
    leaf block's diagonal: the ops that feed more than diagonal blocks)."""
    odiag = _spec_op_tables(spec)[-1]
    per_op = spec.n_k * -(-spec.bc // BATCHED_KC[tile])
    heavy, light = len(odiag) * per_op, int((odiag == 0).sum()) * per_op
    subs = -(-spec.bi // tile) * -(-spec.bj // tile) * batch
    q = spec.q_i
    n_heavy = q * (q + 1) // 2 * subs if spec.out_tri else _positions(
        spec, tile, batch)
    n_light = q * (q - 1) // 2 * subs if spec.out_tri and light else 0
    loads = [heavy * (n_heavy // blocks + (b < n_heavy % blocks))
             for b in range(blocks)]
    heapq.heapify(loads)
    for _ in range(n_light):
        heapq.heapreplace(loads, loads[0] + light)
    return max(loads)


def batched_plan(spec: _Spec, batch: int, sms: int, blocks_per_sm,
                 tile: int | None = None) -> dict:
    """The persistent batched launch of ``spec`` over ``batch`` slots on a
    card of ``sms`` SMs (``leaf_products_batched_kernel``): its block
    tile, its items (the (slot, position) pairs at that tile that write
    something, in the order :func:`batched_item` gives) and its grid.
    Block b walks item b, then takes the next item not yet taken, so the
    heaviest left goes to the first block free.  ``blocks_per_sm`` maps
    each tile to the blocks of the batched kernel an SM holds at once (0
    where it does not fit).  The tile is the one whose busiest block
    (:func:`_batched_makespan`) takes the least time at
    ``BATCHED_STEP_COST``, 128 only where it divides the output tiles;
    ``tile`` forces one (neither changes a bit).  The grid is one wave of
    blocks, or one block an item where there are fewer items.  A
    position's K range is never split."""
    def grid(t):
        return min(_live_positions(spec, t, batch),
                   sms * blocks_per_sm.get(t, 0))

    if tile is None:
        fits = [t for t in PRODUCT_TILES if blocks_per_sm.get(t, 0) > 0
                and spec.bi % t == 0 and spec.bj % t == 0] or [64]
        tile = min(fits, key=lambda t: BATCHED_STEP_COST[t]
                   * _batched_makespan(spec, batch, t, max(grid(t), 1)))
    elif tile not in PRODUCT_TILES:
        raise ValueError(f"tile must be one of {PRODUCT_TILES}, got {tile}")
    per_sm = blocks_per_sm.get(tile, 0)
    if per_sm < 1:
        raise ValueError(f"the batched kernel does not fit an SM at tile "
                         f"{tile} (pipeline_depth={spec.pipeline_depth}, "
                         f"{spec.tmax} operand terms)")
    return {"tile": tile, "items": _live_positions(spec, tile, batch),
            "grid": grid(tile), "blocks_per_sm": per_sm, "sms": sms}


def _cell(spec: _Spec, c: int) -> tuple:
    """Output tile (iq, jq) of a leaf block at cell ``c``, in the kernel's
    order (``cell_of``): row-major, or for a packed output the q(q + 1)/2
    cells with iq >= jq in packed order, then the others, (j, i + 1) for
    the packed (i, j) of q - 1 rows."""
    if not spec.out_tri:
        return divmod(c, spec.q_j)
    heavy = spec.q_i * (spec.q_i + 1) // 2
    t = c if c < heavy else c - heavy
    i = (math.isqrt(8 * t + 1) - 1) // 2
    j = t - i * (i + 1) // 2
    return (i, j) if c < heavy else (j, i + 1)


def batched_item(spec: _Spec, batch: int, tile: int, g: int) -> tuple:
    """Item ``g`` of a batched launch at ``tile``, as the kernel's
    ``item_of`` decodes it: ``(slot, iq, jq, i0, j0)``, output tile (iq,
    jq) of a leaf block and its sub-tile at (i0, j0).  The slot is the
    innermost index, then the sub-tile, then the cell, so every slot's
    heavy cells come first."""
    n_sub_i, n_sub_j = -(-spec.bi // tile), -(-spec.bj // tile)
    z, pos = g % batch, g // batch
    j0 = pos % n_sub_j * tile
    pos //= n_sub_j
    i0 = pos % n_sub_i * tile
    iq, jq = _cell(spec, pos // n_sub_i)
    return z, iq, jq, i0, j0


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _batched_blocks_per_sm(name: str, dtype, tmax: int, depth: int,
                           device: str) -> dict:
    """The batched kernel's occupancy on ``device`` by tile (0 where a
    tile does not fit), asked of the library once a configuration."""
    lib = _products_lib(name)
    with torch.cuda.device(torch.device(device)):
        return {tile: max(0, lib.leaf_products_batched_blocks_per_sm(
            LEAF_DTYPE_CODES[dtype], tmax, tile, depth))
            for tile in PRODUCT_TILES}


@functools.lru_cache(maxsize=256)
def _batched_launch_plan(spec: _Spec, dtype, right_dtype, batch: int, device,
                         tile: int | None = None) -> dict:
    """:func:`batched_plan` on ``device`` for the sides of ``spec`` stored
    as ``dtype`` and ``right_dtype`` (raising for what the batched kernel
    does not run), once a configuration: a launch takes it from the
    cache."""
    _check_batched(spec, dtype, right_dtype)
    name = _products_library(spec.acc_dtype, dtype)
    per_sm = _batched_blocks_per_sm(name, dtype, spec.tmax,
                                    spec.pipeline_depth, str(device))
    return batched_plan(spec, batch, _sms(device), per_sm, tile)


def products_launch_shape(spec: _Spec, left_dtype, right_dtype,
                          tile: int | None = None,
                          batch: int | None = None) -> dict:
    """How a ``leaf_products`` launch of ``spec`` on operands of these
    types fills the current card: the library that runs it, the types it
    stores them as, its ring depth, its block tile, output positions (a
    tile x tile sub-tile each, of every slot),
    the positions walked whole (the rest, the ragged last wave's, are
    walked in quarters, four blocks each; in pair mode none), thread
    blocks (in pair mode one a mirror pair of positions and one a
    position that is its own mirror), blocks an SM holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), shared memory
    a block, and under a bf16 or fp64 accumulator the slots of an op kept
    on chip (:func:`run_dests`) and the (op, slot) pairs kept and not
    (:func:`kept_slots`).  ``batch``: a batched launch of that many slots, the
    persistent kernel's :func:`batched_plan` (``positions`` its items, the
    positions that write something, all walked whole; ``blocks`` its grid;
    the plan itself under ``"plan"``)."""
    lt, rt = _kernel_types(left_dtype, right_dtype, spec.acc_dtype)
    lb, rb = (torch.empty((), dtype=d).element_size() for d in (lt, rt))
    name = _products_library(spec.acc_dtype, lt)
    lib = _products_lib(name)
    depth = lib.leaf_products_ring_depth(spec.pipeline_depth)
    if batch is not None:
        plan = _batched_launch_plan(
            spec, lt, rt, batch,
            torch.device("cuda", torch.cuda.current_device()), tile)
        return {"library": name, "types": (str(lt), str(rt)),
                "ring_depth": depth, "tile": plan["tile"], "pair": False,
                "positions": plan["items"],
                "whole_positions": plan["items"], "blocks": plan["grid"],
                "blocks_per_sm": plan["blocks_per_sm"],
                "smem_bytes": lib.leaf_products_batched_smem_bytes(
                    LEAF_DTYPE_CODES[lt], spec.tmax, plan["tile"],
                    spec.pipeline_depth),
                "plan": plan}
    tile = _products_tile(spec, lb, rb) if tile is None else tile
    positions = _positions(spec, tile)
    codes = (LEAF_DTYPE_CODES[lt], LEAF_DTYPE_CODES[rt],
             ACC_CODES[spec.acc_dtype], int(spec.right_tri), spec.tmax, tile,
             spec.pipeline_depth)
    pair = _pairs(spec)
    n_run = _products_run_dests(spec, tile, lb, rb)
    if pair:            # square: Q sub-tiles along a leaf block's edge
        side = spec.q_i * -(-spec.bi // tile)
        whole, blocks = positions, side * (side + 1) // 2
    else:
        whole = lib.leaf_products_whole_positions(*codes, n_run, positions)
        blocks = whole + 4 * (positions - whole)
    kept = kept_slots(spec, n_run)
    return {"library": name, "types": (str(lt), str(rt)),
            "ring_depth": depth, "tile": tile, "pair": pair,
            "positions": positions, "whole_positions": whole,
            "blocks": blocks,
            "blocks_per_sm": lib.leaf_products_blocks_per_sm(
                *codes, int(pair), n_run),
            "smem_bytes": _products_smem(spec, tile, lb, rb),
            "run_dests": n_run, "kept_slots": int(kept.sum()),
            "per_k_slots": int((_spec_op_tables(spec)[8] != 0).sum()
                               - kept.sum())}


def product_flops(spec: _Spec) -> int:
    """Flops of ``csrc/leaf_products.cu`` on ``spec``, each leaf product
    computed once at the padded leaf shapes.  Symm and matmul: ``2 *
    LeafProgram.mult_count``.  The gram kinds: ``2 * bi * bj * n_k * bc``
    a tile product, over the ``q (q + 1) / 2`` tiles of a diagonal leaf
    block for an op that feeds only diagonal blocks, straight (its
    diagonal tiles whole), and over all ``q^2`` for the others — every op
    of a ``dps`` program among them, whose transposed destinations take
    the product at the mirror position."""
    if spec.kind in _GRAM_KINDS:
        odiag = _spec_op_tables(spec)[-1]
        q = spec.q_i
        tiles = int(odiag.sum()) * q * (q + 1) // 2 \
            + int((odiag == 0).sum()) * q * q
        return tiles * 2 * spec.bi * spec.bj * spec.n_k * spec.bc
    prog = compile_program(spec.kind, spec.levels, spec.variant,
                           trans_a=spec.trans_a, trans_b=spec.trans_b)
    mb, nb = spec.q_i * spec.bi, spec.q_j * spec.bj
    if spec.kind == "symm":
        return 2 * prog.mult_count(mb, nb)
    return 2 * prog.mult_count(mb, nb, spec.n_k * spec.bc)


def _operand_extents(spec: _Spec):
    """The padded (rows, cols) each operand must have for ``spec``."""
    prog = compile_program(spec.kind, spec.levels, spec.variant,
                           gram=spec.gram, trans_a=spec.trans_a,
                           trans_b=spec.trans_b)
    rows_i = prog.blocks_m * spec.q_i * spec.bi
    k_len = prog.blocks_k * spec.n_k * spec.bc
    left = (k_len, rows_i) if spec.left_trans else (rows_i, k_len)
    if spec.right_tri:
        T = spec.n_tj
        return left, (T * (T + 1) // 2 * spec.bj, spec.bj)
    cols_j = prog.blocks_n * spec.q_j * spec.bj
    return left, (cols_j, k_len) if spec.right_trans else (k_len, cols_j)


def _check_buffer(name: str, x: torch.Tensor, want, device,
                  types=_VALUE_TYPES) -> None:
    if x.dtype not in types:
        raise TypeError(f"leaf_program takes a {name} of "
                        f"{', '.join(str(t) for t in types)}, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"the {name} lies on {x.device}, not {device}")
    if tuple(x.shape) != tuple(want):
        raise ValueError(f"{name} of shape {tuple(x.shape)} does not fit "
                         f"the bound program (want {tuple(want)})")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"leaf_program needs a contiguous, 16-byte "
                         f"aligned {name}")


def _check_kernel_args(spec: _Spec, left: torch.Tensor, right: torch.Tensor,
                       out_dtype, seed, out, lead=()) -> None:
    """``lead``: the leading batch axis of a batched launch's buffers
    (``(K,)``), else ``()``."""
    if out_dtype not in _VALUE_TYPES:
        raise TypeError(f"leaf_program writes "
                        f"{', '.join(str(t) for t in _VALUE_TYPES)}, got "
                        f"{out_dtype}")
    for name, x, want in zip(("left operand", "right operand"),
                             (left, right), _operand_extents(spec)):
        _check_buffer(name, x, (*lead, *want), left.device,
                      (*_OPERAND_TYPES, torch.float64))
    if spec.kind in ("ata", "aat", "rank_k"):
        if right.data_ptr() != left.data_ptr():
            raise ValueError(f"the {spec.kind} kernel reads one operand: "
                             "pass the same tensor as left and right")
        if spec.bi != spec.bj or spec.q_i != spec.q_j:
            raise ValueError(f"the {spec.kind} kernel takes square output "
                             "tiles")
    # every raw chunk is copied in 16-byte vectors along its column edge
    l_shape, r_shape = _operand_shapes(spec)
    if min(spec.bi, spec.bj, spec.bc) < 8 or l_shape[1] % 8 \
            or r_shape[1] % 8:
        raise ValueError(
            f"leaf_program needs tile edges >= 8 and stored tile widths "
            f"that are multiples of 8, got bi={spec.bi}, bj={spec.bj}, "
            f"bc={spec.bc} ({spec.kind} tiles stored {l_shape} x "
            f"{r_shape})")
    if spec.accumulate != (seed is not None):
        raise ValueError(f"the {spec.kind} program "
                         f"{'needs' if spec.accumulate else 'takes no'} "
                         "seed stack")
    if seed is not None:
        _check_buffer("seed stack", seed, (*lead, *_out_shape(spec)),
                      left.device)
    if out is not None:
        _check_buffer("output buffer", out, (*lead, *_out_shape(spec)),
                      left.device)
        if out.dtype != out_dtype:
            raise ValueError(f"output buffer of {out.dtype}, not "
                             f"{out_dtype}")


def _tma_layout(x: torch.Tensor, edge: int | None):
    """``x`` as a TMA map reads an fp8 side: every box starts on 16 bytes
    and every row is a multiple of 16 bytes long.  ``edge`` is the width
    of one tile along ``x``'s rows (None for a packed tri stack, whose
    boxes start on 16-column boundaries already); each tile's columns
    are widened to ``pitch``, the edge rounded up to 16, with zeros,
    which the kernel reads only where it reads past a tile's edge
    (outputs it never stores, or depth it masks).  Returns ``(stored x,
    pitch)``; any other type passes as it is.  A batched launch's stack
    ``(K, rows, cols)`` is laid out slot by slot the same way."""
    if x.element_size() != 1:
        return x, edge or x.shape[-1]
    lead = x.shape[:-1]
    raw = x.view(torch.uint8).reshape(-1, x.shape[-1])
    if edge is None:
        raw = F.pad(raw, (0, -x.shape[-1] % 16))
        return raw.view(x.dtype).reshape(*lead, -1), x.shape[-1]
    pitch = -(-edge // 16) * 16
    if pitch != edge:
        raw = F.pad(raw.reshape(raw.shape[0], -1, edge),
                    (0, pitch - edge)).reshape(raw.shape[0], -1)
    return raw.view(x.dtype).reshape(*lead, -1), pitch


def _check_batched(spec: _Spec, left_dtype, right_dtype) -> None:
    """What the batched kernel runs: the ata and aat kinds (one operand, a
    dense right side, no seed) of a program with no transposed
    destination, an fp32 accumulator, both sides stored in one type."""
    if spec.kind not in ("ata", "aat") or _pairs(spec) \
            or spec.acc_dtype != "float32" or left_dtype != right_dtype:
        raise ValueError(
            f"the batched launch runs the ata and aat kinds of a program "
            f"with no transposed destination and an fp32 accumulator on "
            f"one operand, got the {spec.kind} kind of the {spec.gram} "
            f"gram, a {spec.acc_dtype} accumulator, {left_dtype} and "
            f"{right_dtype} sides")


def leaf_program(spec: _Spec, left: torch.Tensor, right: torch.Tensor,
                 out_dtype, seed: torch.Tensor | None = None,
                 out: torch.Tensor | None = None,
                 tile: int | None = None) -> torch.Tensor:
    """Run a bound program on its padded operands.

    ``ata``, ``aat``, ``rank_k``: ``left`` and ``right`` are the same
    padded A.  ``symm``: ``left`` is the padded X, ``right`` the packed
    lower-triangular (bs, bs) tile stack.  ``matmul``: the padded A and
    B as stored (the transposes are the spec's).  ``seed`` is the
    incoming packed stack of ``rank_k``, which starts the accumulator.
    ``out``, where given, is the buffer written (it may be ``seed``: each
    output element is read before it is written).

    A batched launch (the port of ``jax.vmap`` over the TPU kernel): each
    operand and ``out`` carry a leading slot axis ``K``, and one launch
    runs the program on every slot (the result ``(K, ...)``); each slot's
    output is bit-equal to a launch on its slot alone.  On the card it
    takes the persistent ``leaf_products_batched_kernel``, for the ata and
    aat kinds of a program with no transposed destination and an fp32
    accumulator (what ``BoundGram`` binds; others raise), its tile and grid
    from :func:`batched_plan`.  On the CPU the plain version runs slot by
    slot (a seed too).  ``tile`` is the block
    tile of ``csrc/leaf_products.cuh``, one of ``PRODUCT_TILES``; by
    default the first that divides the output tiles and fits (a batched
    launch: the plan's).  Neither
    it nor ``spec.pipeline_depth`` changes a bit of the result (a bf16 or
    fp64 accumulator runs one ring depth for every request:
    :func:`ring_depth`).

    The operands are fp32, bf16, fp16, fp8 (e4m3fn, e5m2) or fp64 (stored
    as fp32); a pair of types no library instantiates is stored as fp32
    (:func:`_kernel_types`, exact).  The seed and the output are fp32,
    bf16, fp16 or fp64; the accumulator is ``spec.acc_dtype``.

    A CUDA tensor launches ``csrc/leaf_products.cuh`` from the library
    :func:`_products_library` picks, on the current stream (no
    synchronisation), or raises; a CPU tensor runs its plain version
    (:func:`_leaf_products_plain`).  Returns the raw output buffer in
    ``out_dtype``: the packed stack ``(n_out * bi, bj)`` for the gram
    kinds, the dense padded grid for symm and matmul; an output of
    another type than the accumulator accumulates in a workspace of the
    accumulator's type and is cast once by the kernel.
    Each launch counts in ``KERNEL_LAUNCHES`` by kind and in
    ``LIBRARY_LAUNCHES`` by the library that ran it.
    """
    if spec.kind not in _KINDS:
        raise ValueError(f"unknown program kind {spec.kind!r}")
    if left.device != right.device:
        raise ValueError(f"operands on {left.device} and {right.device}")
    batched = left.ndim == 3
    if left.device.type == "cpu":
        if batched:
            res = torch.stack([_leaf_products_plain(
                spec, left[k], right[k], out_dtype,
                None if seed is None else seed[k])
                for k in range(left.shape[0])])
        else:
            res = _leaf_products_plain(spec, left, right, out_dtype, seed)
        return res if out is None else out.copy_(res)
    if left.device.type != "cuda":
        raise ValueError(f"leaf_program runs on cuda or cpu, not "
                         f"{left.device}")
    lead = tuple(left.shape[:1]) if batched else ()
    _check_kernel_args(spec, left, right, out_dtype, seed, out, lead)
    one = right is left
    lt, rt = _kernel_types(left.dtype, right.dtype, spec.acc_dtype)
    left, l_pitch = _tma_layout(left.to(lt),
                                spec.bi if spec.left_trans else spec.bc)
    right, r_pitch = (left, l_pitch) if one else _tma_layout(
        right.to(rt), None if spec.right_tri
        else spec.bc if spec.right_trans else spec.bj)
    if batched:     # the plan raises where the kernel does not fit an SM
        plan = _batched_launch_plan(spec, left.dtype, right.dtype, lead[0],
                                    left.device, tile)
        tile = plan["tile"]
    else:
        if tile is None:
            tile = _products_tile(spec, left.element_size(),
                                  right.element_size())
        elif tile not in PRODUCT_TILES:
            raise ValueError(f"tile must be one of {PRODUCT_TILES}, got "
                             f"{tile}")
        smem = smem_bytes(spec, left.element_size(), right.element_size(),
                          tile)
        if smem > SMEM_LIMIT_BYTES:
            raise ValueError(
                f"pipeline_depth={spec.pipeline_depth} with {spec.tmax} "
                f"operand terms needs {smem} bytes of shared memory, over "
                f"the {SMEM_LIMIT_BYTES} a Hopper block can use; lower "
                "pipeline_depth")
    if out is None:
        out = torch.empty((*lead, *_out_shape(spec)), dtype=out_dtype,
                          device=left.device)
    acc_t = _ACC_DTYPES[spec.acc_dtype]
    ws = out if out.dtype == acc_t else torch.empty(
        out.shape, dtype=acc_t, device=out.device)
    tables = _spec_op_tables(spec, left.device)
    n_ops, max_dests = tables[7].shape
    right_layout = _RIGHT_TRI if spec.right_tri \
        else _RIGHT_JK if spec.right_trans else _RIGHT_KJ
    name = _products_library(spec.acc_dtype, left.dtype)
    lib = _products_lib(name)
    geometry = (spec.n_k, spec.q_i, spec.q_j, spec.blocks_j, spec.bi,
                spec.bj, spec.bc, int(spec.left_trans))
    with torch.cuda.device(left.device):
        stream = torch.cuda.current_stream().cuda_stream
        if batched:
            # the counter its blocks take items from, zeroed on the stream
            # by this launch alone (a captured launch gets its own, zeroed
            # at each replay)
            counter = torch.zeros(1, dtype=torch.int32, device=left.device)
            err = lib.leaf_products_batched_launch(
                left.data_ptr(), right.data_ptr(), ws.data_ptr(),
                out.data_ptr(), *(t.data_ptr() for t in tables),
                *left.shape[-2:], *right.shape[-2:], n_ops, spec.tmax,
                max_dests, *geometry, int(spec.right_trans),
                int(spec.out_tri), LEAF_DTYPE_CODES[left.dtype],
                LEAF_DTYPE_CODES[out.dtype], l_pitch, r_pitch, tile,
                spec.pipeline_depth, lead[0], math.prod(_out_shape(spec)),
                plan["items"], plan["grid"], counter.data_ptr(), stream)
        else:
            err = lib.leaf_products_launch(
                left.data_ptr(), right.data_ptr(),
                None if seed is None else seed.data_ptr(), ws.data_ptr(),
                out.data_ptr(), *(t.data_ptr() for t in tables),
                *left.shape[-2:], *right.shape[-2:], n_ops, spec.tmax,
                max_dests, *geometry, right_layout, int(spec.diag_sym),
                int(spec.out_tri), int(_pairs(spec)),
                LEAF_DTYPE_CODES[left.dtype], LEAF_DTYPE_CODES[right.dtype],
                0 if seed is None else LEAF_DTYPE_CODES[seed.dtype],
                LEAF_DTYPE_CODES[out.dtype], ACC_CODES[spec.acc_dtype],
                l_pitch, r_pitch, tile, spec.pipeline_depth,
                _products_run_dests(spec, tile, left.element_size(),
                                    right.element_size()), stream)
    if err:
        raise RuntimeError(
            f"leaf_program launch failed: CUDA error {err} "
            f"({lib.leaf_products_error_string(err).decode()})")
    KERNEL_LAUNCHES[f"leaf_program/{spec.kind}"] += 1
    LIBRARY_LAUNCHES[f"{name}.cu/{spec.kind}"] += 1
    if batched:
        BATCHED_LAUNCHES[f"leaf_program/{spec.kind}"] += 1
    return out


# ---------------------------------------------------------------------------
# Fused ATA: C = tril(A^t A) into the packed triangular block stack, and
# its backward dA = A (S + S^t) through the symm kind.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _AtaConfig:
    """The resolved knobs of one fused ata call (the counterpart of the
    JAX custom VJPs' nondiff arguments)."""
    levels: int
    variant: str
    gram: str
    bk: int
    bn: int
    out_dtype: torch.dtype
    bwd: str
    pipeline_depth: int
    operand_dtype: torch.dtype | None
    acc_dtype: str


def _ata_config(a, device, *, levels, variant, gram, bk, bn, out_dtype, bwd,
                pipeline_depth, operand_dtype, acc_dtype, sr_seed,
                kind="ata"):
    """Place ``a`` and resolve the knobs of the gram kinds (for aat,
    ``bn`` is the output tile edge bm); returns ``(a, config, sr)``, the
    config's output fp32 where ``sr`` (the resolved ``sr_seed``) asks for
    the stochastic rounding post-pass."""
    a = _place(a, device)
    if a.ndim != 2:
        raise ValueError(f"fused {kind} expects a matrix, got shape "
                         f"{tuple(a.shape)}")
    depth = _resolve_pipeline_depth(pipeline_depth, a.device)
    op_dt = _resolve_operand_dtype(operand_dtype)
    acc_dt = _resolve_acc_dtype(acc_dtype)
    out_dtype = _promoted(a.dtype) if out_dtype is None else out_dtype
    sr = _resolve_sr_seed(sr_seed, out_dtype)
    cfg = _AtaConfig(
        levels=levels, variant=variant, gram=gram, bk=bk, bn=bn,
        out_dtype=torch.float32 if sr is not None else out_dtype,
        bwd=_resolve_bwd(bwd), pipeline_depth=depth, operand_dtype=op_dt,
        acc_dtype=acc_dt)
    return a, cfg, sr


def fused_ata_packed(
    a: torch.Tensor,
    *,
    levels: int = 2,
    variant: str = "strassen",
    gram: str = "strassen",
    bk: int = 256,
    bn: int = 256,
    out_dtype=None,
    bwd: str = "fused",
    pipeline_depth=None,
    operand_dtype=None,
    acc_dtype=None,
    sr_seed=None,
    device=None,
):
    """Packed lower-triangular block stack of ``tril(a.T @ a)`` via the
    leaf-program executor.

    ``a`` is zero-padded so each of the ``2^levels`` leaf blocks is a
    (bk, bn)-tile multiple (exact: zero rows add nothing to A^tA, zero
    columns are sliced away by the dense wrapper).  ``levels`` is a cap,
    clamped as in ``_ata_geometry``.

    Returns ``(packed, n_padded)`` with packed of shape
    ``(T(T+1)/2 * bn, bn)``, ``T = n_padded // bn``, in the ordering of
    ``symmetry.pack_tril_blocks``.

    Differentiable: the backward takes the *packed* cotangent straight
    into :func:`fused_symm_matmul` (``bwd="fused"``) — ``dA = A (S +
    S^t)`` with S the block-lower matrix the stack represents, no dense
    n^2 buffer.  ``bwd="dense"`` is the classical baseline (unpack, then
    ``A @ (S + S^t)`` in torch).

    ``device=None`` runs on the card; a CPU tensor is moved there unless
    ``device="cpu"``, which runs the plain executor.  ``pipeline_depth``
    is the kernel's ring depth (None = 2 on the card, 1 on the CPU).
    Precision, as in the JAX package: ``operand_dtype`` (fp8 e4m3fn or
    e5m2, bf16, fp16, fp32, fp64) quantizes the padded A once, stored so
    in the forward's tiles, each widened to fp32 before the signed sums;
    ``acc_dtype`` (fp32 by default, bf16, fp64) is the accumulator;
    ``sr_seed`` (with a bf16 ``out_dtype``) computes the stack in fp32
    and rounds it stochastically, deterministic per seed and device
    (:func:`stochastic_round_bf16`, a straight-through gradient).  The
    backward runs on the unquantized A, in fp32.
    """
    a, cfg, sr = _ata_config(
        a, device, levels=levels, variant=variant, gram=gram, bk=bk, bn=bn,
        out_dtype=out_dtype, bwd=bwd, pipeline_depth=pipeline_depth,
        operand_dtype=operand_dtype, acc_dtype=acc_dtype, sr_seed=sr_seed)
    n_pad = _ata_geometry(*a.shape, levels, variant, bk, bn, gram=gram)["N"]
    packed = _FusedAtaPacked.apply(a, cfg)
    return (packed if sr is None else _sr_round(packed, sr)), n_pad


def _gram_spec(kind, m, n, levels, variant, gram, b_out, b_k,
               pipeline_depth=1, acc_dtype="float32"):
    """The ata (or aat) program bound to the tiles of an (m, n) operand:
    ``(spec, M, N)``, ``(M, N)`` its padded shape; ``b_out`` is the
    output tile edge (bn, or bm for aat), ``b_k`` the contraction's."""
    if kind == "ata":
        geo = _ata_geometry(m, n, levels, variant, b_k, b_out, gram=gram)
    else:
        geo = _aat_geometry(m, n, levels, variant, b_out, b_k, gram=gram)
    spec = _bind(geo["plan"], n_out=geo["n_tri"], n_tj=0, q_i=geo["nbt"],
                 q_j=geo["nbt"], n_k=geo["n_k"], bi=b_out, bj=b_out,
                 bc=b_k, pipeline_depth=pipeline_depth, acc_dtype=acc_dtype)
    return spec, geo["M"], geo["N"]


def _pad_stored(a, M, N, operand_dtype):
    """``a`` (or a stack of them) zero-padded to ``(M, N)`` and quantized
    once after padding: operand tiles are stored (and copied) at this
    precision; every sum upcasts to fp32."""
    m, n = a.shape[-2:]
    if (M, N) != (m, n):
        a = F.pad(a, (0, N - n, 0, M - m))
    return _stored(a, operand_dtype).contiguous()


def _prepare_ata(a, levels, variant, gram, bk, bn, pipeline_depth=1,
                 operand_dtype=None, acc_dtype="float32"):
    """Pad and quantize ``a`` and bind the ata program to its tiles;
    returns ``(spec, padded a)``, what :func:`leaf_program` takes."""
    if a.ndim != 2:
        raise ValueError(f"fused ata expects a matrix, got shape "
                         f"{tuple(a.shape)}")
    spec, M, N = _gram_spec("ata", *a.shape, levels, variant, gram, bn, bk,
                            pipeline_depth, acc_dtype)
    return spec, _pad_stored(a, M, N, operand_dtype)


def _fused_ata_packed_exec(a, cfg: _AtaConfig):
    """Pad, quantize, bind and run; returns ``(packed, n_padded)``."""
    spec, a = _prepare_ata(a, cfg.levels, cfg.variant, cfg.gram, cfg.bk,
                           cfg.bn, cfg.pipeline_depth, cfg.operand_dtype,
                           cfg.acc_dtype)
    return leaf_program(spec, a, a, cfg.out_dtype), a.shape[1]


def _symm_bwd(a: torch.Tensor, s_packed: torch.Tensor,
              cfg: _AtaConfig) -> torch.Tensor:
    """``dA = A (S + S^t)`` from the packed block-lower stack of S, run
    by the symm kind at the forward's clamped levels; fp32 or wider."""
    m, n = a.shape
    geo = _ata_geometry(m, n, cfg.levels, cfg.variant, cfg.bk, cfg.bn,
                        gram=cfg.gram)
    return fused_symm_matmul(
        a, s_packed, levels=geo["levels"], variant=cfg.variant, bm=cfg.bk,
        diag_sym=True, out_dtype=_promoted(a.dtype),
        pipeline_depth=cfg.pipeline_depth, device=a.device)[:, :n]


class _FusedAtaPacked(torch.autograd.Function):
    """The packed stack of ``tril(A^t A)``; its backward feeds the packed
    cotangent to the symm kind as it is (``_fused_ata_packed_bwd``)."""

    @staticmethod
    def forward(ctx, a, cfg):
        ctx.save_for_backward(a)
        ctx.cfg = cfg
        return _fused_ata_packed_exec(a, cfg)[0]

    @staticmethod
    def backward(ctx, gp):
        # vdot(gp, packed(A)) has S = the block-lower cotangent (diagonal
        # tiles full, as the forward computes them), so dA = A (S + S^t)
        (a,), cfg = ctx.saved_tensors, ctx.cfg
        acc = _promoted(a.dtype)
        if cfg.bwd == "fused":
            return _symm_bwd(a, gp.to(acc), cfg).to(a.dtype), None
        m, n = a.shape
        geo = _ata_geometry(m, n, cfg.levels, cfg.variant, cfg.bk, cfg.bn,
                            gram=cfg.gram)
        M, N = geo["M"], geo["N"]
        s = unpack_tril_blocks(gp.to(acc), N, cfg.bn, symmetrize=False)
        ap = F.pad(a.to(acc), (0, N - n, 0, M - m))
        with ieee_fp32():
            da = (ap @ (s + s.T))[:m, :n]
        return da.to(a.dtype), None


class _FusedAtaDense(torch.autograd.Function):
    """Dense ``tril(A^t A)``; its backward packs ``tril(g)`` per tile and
    runs the symm kind (``_fused_ata_dense_bwd``)."""

    @staticmethod
    def forward(ctx, a, cfg):
        ctx.save_for_backward(a)
        ctx.cfg = cfg
        n = a.shape[1]
        packed, n_pad = _fused_ata_packed_exec(a, cfg)
        dense = unpack_tril_blocks(packed, n_pad, cfg.bn, symmetrize=False)
        # diagonal blocks are computed full — drop their upper halves
        return torch.tril(dense)[:n, :n]

    @staticmethod
    def backward(ctx, g):
        # C = tril(A^t A) => dL/dA = A (S + S^t), S = tril(dL/dC); the
        # factor 2 on the diagonal of S + S^t is the quadratic term's
        (a,), cfg = ctx.saved_tensors, ctx.cfg
        acc = _promoted(a.dtype)
        if cfg.bwd == "dense":
            s = torch.tril(g).to(acc)
            with ieee_fp32():
                da = a.to(acc) @ (s + s.T)
            return da.to(a.dtype), None
        m, n = a.shape
        n_pad = _ata_geometry(m, n, cfg.levels, cfg.variant, cfg.bk, cfg.bn,
                              gram=cfg.gram)["N"]
        s_packed = _pack_cotangent(g.to(acc), n, n_pad, cfg.bn)
        return _symm_bwd(a, s_packed, cfg).to(a.dtype), None


def _pack_cotangent(g: torch.Tensor, n: int, n_pad: int,
                    bn: int) -> torch.Tensor:
    """Packed lower-triangular (bn, bn) tile stack of ``S = tril(g)``,
    zero-padded to ``n_pad`` — copied block-row by block-row from slices
    of ``g``, so the padded dense S (and a fortiori S + S^t) never exists;
    the stack is the only n(n+1)/2-sized temporary."""
    t = n_pad // bn
    out = g.new_zeros((t * (t + 1) // 2, bn, bn))
    for i in range(t):
        r0 = i * bn
        if r0 >= n:
            break
        rows = min(bn, n - r0)
        blk = g[r0:r0 + rows, :min(r0 + bn, n)]     # tiles (i, 0..i)
        full, rest = divmod(blk.shape[1], bn)
        base = i * (i + 1) // 2
        out[base:base + full, :rows] = \
            blk[:, :full * bn].reshape(rows, full, bn).transpose(0, 1)
        if rest:
            out[base + full, :rows, :rest] = blk[:, full * bn:]
        out[base + i].tril_()
    return out.reshape(-1, bn)


def fused_ata(
    a: torch.Tensor,
    *,
    levels: int = 2,
    variant: str = "strassen",
    gram: str = "strassen",
    bk: int = 256,
    bn: int = 256,
    out_dtype=None,
    bwd: str = "fused",
    pipeline_depth=None,
    operand_dtype=None,
    acc_dtype=None,
    sr_seed=None,
    device=None,
) -> torch.Tensor:
    """Dense ``tril(a.T @ a)`` at the original size via the fused
    executor; the knobs are :func:`fused_ata_packed`'s.

    Differentiable: ``dA = A (S + S^t)`` with ``S = tril(cotangent)``.
    ``bwd="fused"`` gathers the cotangent per tile into the packed stack
    (:func:`_pack_cotangent`) and runs the symm kind; ``bwd="dense"`` is
    the classical ``a @ (s + s.T)``.
    """
    a, cfg, sr = _ata_config(
        a, device, levels=levels, variant=variant, gram=gram, bk=bk, bn=bn,
        out_dtype=out_dtype, bwd=bwd, pipeline_depth=pipeline_depth,
        operand_dtype=operand_dtype, acc_dtype=acc_dtype, sr_seed=sr_seed)
    out = _FusedAtaDense.apply(a, cfg)
    return out if sr is None else _sr_round(out, sr)


# ---------------------------------------------------------------------------
# Fused symm matmul: D = X @ Sym where Sym is given only as the packed
# lower-triangular (bs, bs) tile stack of S — the engine of the backward.
# ---------------------------------------------------------------------------

def fused_symm_matmul(
    x: torch.Tensor,
    s_packed: torch.Tensor,
    *,
    levels: int = 2,
    variant: str = "strassen",
    bm: int = 256,
    diag_sym: bool = False,
    out_dtype=None,
    pipeline_depth=None,
    operand_dtype=None,
    acc_dtype=None,
    device=None,
) -> torch.Tensor:
    """``x @ Sym`` via the flattened symm program, one kernel launch.

    ``s_packed`` is the packed lower-triangular tile stack of S — shape
    (T(T+1)/2 * bs, bs) in ``symmetry.pack_tril_blocks`` order (the tile
    edge ``bs`` is read off the stack's trailing dim).

    * ``diag_sym=False``: Sym is the symmetric completion of the stack
      (diagonal tiles stored full); computes ``x @ Sym``.
    * ``diag_sym=True``: Sym = S + S^t with S the block-lower matrix the
      stack represents — the Gram-VJP operand.  The same mirrored reads;
      diagonal tiles contribute ``tile + tile^t``.

    ``x`` is zero-padded on the right to the stack's T*bs columns and on
    the bottom to leaf multiples.  Returns ``(x.shape[0], T*bs)``.  No
    dense Sym (or S + S^t) is ever built.  ``levels`` is a cap, clamped
    to divisors of T and to the fan-in.  ``device`` as in
    :func:`fused_ata_packed`; ``operand_dtype`` quantizes both ``x`` and
    the stack.
    """
    x, s_packed = _place(x, device), _place(s_packed, device)
    out_dtype = (_promoted(x.dtype, s_packed.dtype)
                 if out_dtype is None else out_dtype)
    spec, xp, sp = _prepare_symm(
        x, s_packed, levels, variant, bm, diag_sym,
        _resolve_pipeline_depth(pipeline_depth, x.device),
        _resolve_operand_dtype(operand_dtype), _resolve_acc_dtype(acc_dtype))
    return leaf_program(spec, xp, sp, out_dtype)[:x.shape[0]]


def _prepare_symm(x, s_packed, levels, variant, bm, diag_sym,
                  pipeline_depth=1, operand_dtype=None, acc_dtype="float32"):
    """Check the stack, pad and quantize ``x`` and bind the symm program
    to its tiles; returns ``(spec, padded x, stack)``, what
    :func:`leaf_program` takes."""
    if x.ndim != 2 or s_packed.ndim != 2:
        raise ValueError(f"bad ranks: {tuple(x.shape)} x packed "
                         f"{tuple(s_packed.shape)}")
    bs, T = _stack_tiles(s_packed)
    N = T * bs
    m, nx = x.shape
    if nx > N:
        raise ValueError(f"x has {nx} cols but the stack spans {N}")
    geo = _symm_geometry(m, T, levels, variant, bm)
    M = geo["M"]
    if (M, N) != (m, nx):
        x = F.pad(x, (0, N - nx, 0, M - m))
    x, s_packed = _stored(x, operand_dtype), _stored(s_packed, operand_dtype)
    spec = _bind(geo["plan"], n_out=(M // bm) * T, n_tj=T, q_i=geo["nbm"],
                 q_j=geo["q"], n_k=geo["q"], bi=bm, bj=bs, bc=bs,
                 diag_sym=diag_sym, pipeline_depth=pipeline_depth,
                 acc_dtype=acc_dtype)
    return spec, x.contiguous(), s_packed.contiguous()


def _stack_tiles(stack: torch.Tensor, edge: str = "bs"):
    """``(tile edge, T)`` of a packed lower-triangular tile stack of
    shape ``(T(T+1)/2 * edge, edge)``; ValueError for anything else."""
    bs = stack.shape[1]
    if bs == 0 or stack.shape[0] % bs:
        raise ValueError(f"packed stack {tuple(stack.shape)} not a "
                         f"({edge}, {edge}) tile stack")
    n_tri = stack.shape[0] // bs
    T = (math.isqrt(8 * n_tri + 1) - 1) // 2
    if T * (T + 1) // 2 != n_tri:
        raise ValueError(f"stack of {n_tri} tiles is not triangular")
    return bs, T


# ---------------------------------------------------------------------------
# Fused AAT: C = tril(A A^t), the row gram (Arrigoni-Massini 2021), from
# the same IR.  The transpose of A never exists: the right side reads the
# same stored A tiles mirrored.
# ---------------------------------------------------------------------------

def _prepare_aat(a, levels, variant, gram, bm, bk, pipeline_depth=1,
                 operand_dtype=None, acc_dtype="float32"):
    """Pad and quantize ``a`` and bind the aat program to its tiles;
    returns ``(spec, padded a)``, what :func:`leaf_program` takes (as
    left and right)."""
    if a.ndim != 2:
        raise ValueError(f"fused aat expects a matrix, got shape "
                         f"{tuple(a.shape)}")
    spec, M, N = _gram_spec("aat", *a.shape, levels, variant, gram, bm, bk,
                            pipeline_depth, acc_dtype)
    return spec, _pad_stored(a, M, N, operand_dtype)


def _fused_aat_packed_exec(a, cfg: _AtaConfig):
    """Pad, quantize, bind and run (``cfg.bn`` is the output tile edge
    bm); returns ``(packed, m_padded)``."""
    spec, a = _prepare_aat(a, cfg.levels, cfg.variant, cfg.gram, cfg.bn,
                           cfg.bk, cfg.pipeline_depth, cfg.operand_dtype,
                           cfg.acc_dtype)
    return leaf_program(spec, a, a, cfg.out_dtype), a.shape[0]


def _sym_left_product(s: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``(S + S^t) A`` for ``S`` of ``M >= rows(A)`` rows, in full fp32:
    the row gram's backward, a dense product outside any kernel as in
    the JAX package (``jnp.dot``)."""
    acc = _promoted(a.dtype)
    ap = F.pad(a.to(acc), (0, 0, 0, s.shape[0] - a.shape[0]))
    with ieee_fp32():
        return ((s + s.T) @ ap)[:a.shape[0]]


class _FusedAatPacked(torch.autograd.Function):
    """The packed stack of ``tril(A A^t)``; its backward is the dense
    ``(S + S^t) A`` with S the block-lower cotangent."""

    @staticmethod
    def forward(ctx, a, cfg):
        ctx.save_for_backward(a)
        ctx.cfg = cfg
        return _fused_aat_packed_exec(a, cfg)[0]

    @staticmethod
    def backward(ctx, gp):
        (a,), cfg = ctx.saved_tensors, ctx.cfg
        acc = _promoted(a.dtype)
        m_pad = _aat_geometry(*a.shape, cfg.levels, cfg.variant, cfg.bn,
                              cfg.bk, gram=cfg.gram)["M"]
        s = unpack_tril_blocks(gp.to(acc), m_pad, cfg.bn, symmetrize=False)
        return _sym_left_product(s, a).to(a.dtype), None


class _FusedAatDense(torch.autograd.Function):
    """Dense ``tril(A A^t)``; its backward is the JAX package's dense
    ``dA = (S + S^t) A`` with ``S = tril(g)``."""

    @staticmethod
    def forward(ctx, a, cfg):
        ctx.save_for_backward(a)
        ctx.cfg = cfg
        m = a.shape[0]
        packed, m_pad = _fused_aat_packed_exec(a, cfg)
        dense = unpack_tril_blocks(packed, m_pad, cfg.bn, symmetrize=False)
        # diagonal blocks are computed full — drop their upper halves
        return torch.tril(dense)[:m, :m]

    @staticmethod
    def backward(ctx, g):
        (a,), cfg = ctx.saved_tensors, ctx.cfg
        acc = _promoted(a.dtype)
        return _sym_left_product(torch.tril(g).to(acc), a).to(a.dtype), None


def fused_aat_packed(
    a: torch.Tensor,
    *,
    levels: int = 2,
    variant: str = "strassen",
    gram: str = "strassen",
    bm: int = 256,
    bk: int = 256,
    out_dtype=None,
    pipeline_depth=None,
    operand_dtype=None,
    acc_dtype=None,
    sr_seed=None,
    device=None,
):
    """Packed lower-triangular block stack of ``tril(a @ a.T)``.

    Returns ``(packed, m_padded)`` with packed of shape
    ``(T(T+1)/2 * bm, bm)``, ``T = m_padded // bm``.  Zero-padding is
    exact: zero columns add nothing to A A^t, zero rows add zero
    rows/columns to C that the dense wrapper slices away.  The knobs are
    :func:`fused_ata_packed`'s (``bm`` the output tile edge, ``bk`` the
    contraction tile edge).  Differentiable: ``dA = (S + S^t) A`` with S
    the block-lower cotangent, a dense product in torch.
    """
    a, cfg, sr = _ata_config(
        a, device, levels=levels, variant=variant, gram=gram, bk=bk, bn=bm,
        out_dtype=out_dtype, bwd="dense", pipeline_depth=pipeline_depth,
        operand_dtype=operand_dtype, acc_dtype=acc_dtype, sr_seed=sr_seed,
        kind="aat")
    m_pad = _aat_geometry(*a.shape, levels, variant, bm, bk, gram=gram)["M"]
    packed = _FusedAatPacked.apply(a, cfg)
    return (packed if sr is None else _sr_round(packed, sr)), m_pad


def fused_aat(
    a: torch.Tensor,
    *,
    levels: int = 2,
    variant: str = "strassen",
    gram: str = "strassen",
    bm: int = 256,
    bk: int = 256,
    out_dtype=None,
    pipeline_depth=None,
    operand_dtype=None,
    acc_dtype=None,
    sr_seed=None,
    device=None,
) -> torch.Tensor:
    """Dense ``tril(a @ a.T)`` at the original size via the fused
    executor — ``ata(x, gram_of="rows")``; the knobs are
    :func:`fused_aat_packed`'s.

    Differentiable: ``dA = (S + S^t) A`` with ``S = tril(cotangent)``, the
    dense product of the JAX package (the row gram's backward is
    symmetric on the left, which the symm program does not express).
    """
    a, cfg, sr = _ata_config(
        a, device, levels=levels, variant=variant, gram=gram, bk=bk, bn=bm,
        out_dtype=out_dtype, bwd="dense", pipeline_depth=pipeline_depth,
        operand_dtype=operand_dtype, acc_dtype=acc_dtype, sr_seed=sr_seed,
        kind="aat")
    out = _FusedAatDense.apply(a, cfg)
    return out if sr is None else _sr_round(out, sr)


# ---------------------------------------------------------------------------
# Batched grams: one launch over a stack of K slots, the port of jax.vmap
# over the fused ata / aat (the JAX engine's slot batches, batched_gram).
# ---------------------------------------------------------------------------

# BoundGram's symmetric grams of an edge up to this are one gather of the
# packed stack, through an int32 index of g^2 offsets kept with the program
# (16 MiB at 2048); a larger gram is unpacked tile by tile
# (unpack_tril_blocks), keeping no index.
GATHER_MAX_EDGE = 2048


def _mirror_index(g: int, b: int, device) -> torch.Tensor:
    """The offset, within one slot's packed stack of (b, b) tiles, of
    element (max(r, c), min(r, c)) of a g x g gram, for each (r, c) in
    row-major order: tile (hi // b, lo // b) at (hi % b, lo % b).  int32
    throughout, no int64 temporary."""
    r = torch.arange(g, dtype=torch.int32, device=device)
    hi = torch.maximum(r[:, None], r[None, :])
    lo = torch.minimum(r[:, None], r[None, :])
    ti, tj = hi // b, lo // b
    return (((ti * (ti + 1) // 2 + tj) * b + hi % b) * b + lo % b).view(-1)


class BoundGram:
    """The ata (``gram_of="cols"``) or aat (``"rows"``) program bound
    once to the shape of a ``(K, m, n)`` stack: the spec, the padded
    shape, the op tables on the device and, on the card, the launch
    geometry (:func:`products_launch_shape`).  ``b_out`` is the output
    tile edge (bn of ata, bm of aat), ``b_k`` the contraction's (bk).
    The port's counterpart of the JAX package's compiled
    ``jax.jit(jax.vmap(...))`` executable: each call pads the stack
    once, quantizes it once and launches once over every slot
    (:func:`leaf_program` with a slot axis), or on the CPU runs the
    plain version slot by slot.  Forward-only."""

    def __init__(self, m: int, n: int, *, batch: int, gram_of: str = "cols",
                 levels: int = 2, variant: str = "strassen",
                 b_out: int = 256, b_k: int = 256, out_dtype,
                 dtype=torch.float32, pipeline_depth=None,
                 operand_dtype=None, device):
        if gram_of not in ("cols", "rows"):
            raise ValueError(f"gram_of must be 'cols' or 'rows', got "
                             f"{gram_of!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.kind = "ata" if gram_of == "cols" else "aat"
        self.shape, self.batch, self.b_out = (m, n), batch, b_out
        self.out_dtype = out_dtype
        self.operand_dtype = _resolve_operand_dtype(operand_dtype)
        self.spec, M, N = _gram_spec(
            self.kind, m, n, levels, variant, "strassen", b_out, b_k,
            _resolve_pipeline_depth(pipeline_depth, self.device), "float32")
        self.padded = (M, N)
        self.edge = N if self.kind == "ata" else M   # the padded gram edge
        self.tables = _spec_op_tables(self.spec, self.device)
        stored = _stored(torch.empty((), dtype=dtype), self.operand_dtype)
        self._mirror = None     # the symmetric gather's index, at first use
        self.launch = products_launch_shape(
            self.spec, stored.dtype, stored.dtype, batch=batch) \
            if self.device.type == "cuda" else None

    def packed(self, stack: torch.Tensor) -> torch.Tensor:
        """``(K, T(T+1)/2 * b, b)``: each slot's packed lower-triangular
        tile stack, one launch."""
        if tuple(stack.shape) != (self.batch, *self.shape):
            raise ValueError(f"stack of shape {tuple(stack.shape)}, bound "
                             f"to {(self.batch, *self.shape)}")
        if stack.device != self.device:
            raise ValueError(f"the stack lies on {stack.device}, the bound "
                             f"program on {self.device}")
        if stack.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(
                f"the batched {self.kind} is forward-only: got a stack that "
                "requires grad (take ata_full slot by slot for a gradient)")
        sp = _pad_stored(stack, *self.padded, self.operand_dtype)
        return leaf_program(self.spec, sp, sp, self.out_dtype)

    def __call__(self, stack: torch.Tensor, *,
                 symmetrize: bool = False) -> torch.Tensor:
        """``(K, n, n)`` lower triangles ``tril(x.T @ x)`` of each slot x
        (``(K, m, m)``, ``tril(x @ x.T)``, for the row gram); the full
        symmetric grams with ``symmetrize``: up to ``GATHER_MAX_EDGE`` one
        gather of the packed stack (:func:`_mirror_index`, made once a
        program) plus 0, the bits of ``unpack_tril_blocks``' mirror (-0
        made +0 as its adds make it); past it ``unpack_tril_blocks``."""
        g = self.shape[1] if self.kind == "ata" else self.shape[0]
        packed = self.packed(stack)
        if not symmetrize or g > GATHER_MAX_EDGE:
            c = unpack_tril_blocks(packed, self.edge, self.b_out,
                                   symmetrize=symmetrize)[:, :g, :g]
            return c if symmetrize else torch.tril(c)
        if self._mirror is None:
            self._mirror = _mirror_index(g, self.b_out, self.device)
        return packed.view(self.batch, -1).index_select(
            1, self._mirror).view(self.batch, g, g).add_(0)


# ---------------------------------------------------------------------------
# Fused rank-k update: C += tril(A^t A) on an existing packed stack, the
# accumulating ata program.  The incoming stack seeds the accumulator tile
# by tile, so a streamed Gram chunk is one kernel with no delta stack.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _RankKConfig:
    """The resolved knobs of one rank-k update."""
    levels: int
    variant: str
    gram: str
    bk: int
    T: int
    out_dtype: torch.dtype
    stack_dtype: torch.dtype
    pipeline_depth: int
    operand_dtype: torch.dtype | None
    acc_dtype: str
    donate: bool


def _check_rank_k(c_stack, a):
    """The JAX package's shape errors; returns the stack's ``(bn, T)``."""
    if c_stack.ndim != 2 or a.ndim != 2:
        raise ValueError(f"bad ranks: stack {tuple(c_stack.shape)} x "
                         f"{tuple(a.shape)}")
    bn, T = _stack_tiles(c_stack, "bn")
    if a.shape[1] > T * bn:
        raise ValueError(f"chunk has {a.shape[1]} cols but the stack "
                         f"spans {T * bn}")
    return bn, T


def _prepare_rank_k(c_stack, a, levels, variant, gram, bk, pipeline_depth=1,
                    operand_dtype=None, acc_dtype="float32"):
    """Check the stack and the chunk, pad and quantize the chunk (only
    the chunk: the stack seeds the accumulator at its own precision) and
    bind the rank_k program; returns ``(spec, padded chunk)``."""
    bn, T = _check_rank_k(c_stack, a)
    m, n = a.shape
    geo = _rank_k_geometry(m, T, levels, variant, bk, gram=gram)
    M, N = geo["M"], T * bn
    if (M, N) != (m, n):
        a = F.pad(a, (0, N - n, 0, M - m))
    a = _stored(a, operand_dtype)
    spec = _bind(geo["plan"], n_out=geo["n_tri"], n_tj=0, q_i=geo["nbt"],
                 q_j=geo["nbt"], n_k=geo["n_k"], bi=bn, bj=bn, bc=bk,
                 pipeline_depth=pipeline_depth, acc_dtype=acc_dtype)
    return spec, a.contiguous()


class _FusedRankK(torch.autograd.Function):
    """``C_in + tril(A^t A)`` on the packed stack, in place when donated;
    the stack's cotangent passes through packed and dA runs the symm
    kind on it."""

    @staticmethod
    def forward(ctx, c_stack, a, cfg):
        ctx.save_for_backward(a)
        ctx.cfg = cfg
        spec, ap = _prepare_rank_k(c_stack, a, cfg.levels, cfg.variant,
                                   cfg.gram, cfg.bk, cfg.pipeline_depth,
                                   cfg.operand_dtype, cfg.acc_dtype)
        out = leaf_program(spec, ap, ap, cfg.out_dtype, seed=c_stack,
                           out=c_stack if cfg.donate else None)
        if cfg.donate:
            ctx.mark_dirty(c_stack)
        return out

    @staticmethod
    def backward(ctx, g):
        # dC_in = g, cast back to the stack's dtype; dA = A (S + S^t) with
        # S the block-lower cotangent stack, at the forward's levels
        (a,), cfg = ctx.saved_tensors, ctx.cfg
        lv = _rank_k_geometry(a.shape[0], cfg.T, cfg.levels, cfg.variant,
                              cfg.bk, gram=cfg.gram)["levels"]
        da = fused_symm_matmul(
            a, g, levels=lv, variant=cfg.variant, bm=cfg.bk, diag_sym=True,
            out_dtype=_promoted(a.dtype),
            pipeline_depth=cfg.pipeline_depth, device=a.device)
        return g.to(cfg.stack_dtype), da[:, :a.shape[1]].to(a.dtype), None


def fused_rank_k_update(
    c_stack: torch.Tensor,
    a: torch.Tensor,
    *,
    levels: int = 2,
    variant: str = "strassen",
    gram: str = "strassen",
    bk: int = 256,
    out_dtype=None,
    pipeline_depth=None,
    operand_dtype=None,
    acc_dtype=None,
    donate: bool = False,
    device=None,
) -> torch.Tensor:
    """``C += tril(a.T @ a)`` on a packed lower-triangular tile stack.

    ``c_stack`` is a ``(T(T+1)/2 * bn, bn)`` stack (``fused_ata_packed``
    ordering; the tile edge is read off the stack's trailing dim); ``a``
    is an (m, n) chunk with ``n <= T * bn`` (columns zero-padded to the
    stack span, exact for the Gram).  Returns the updated stack in
    ``out_dtype`` (default: the stack's dtype).

    ``levels`` is clamped to depths dividing the stack's T, like
    :func:`fused_symm_matmul`.  ``operand_dtype`` quantizes only the
    chunk: the stack seeds the accumulator at its own precision.
    ``donate=True`` writes the result over ``c_stack`` in place (when
    ``out_dtype`` is its dtype and it is contiguous; otherwise a new
    stack), the counterpart of the JAX buffer donation; it refuses a
    stack that requires grad, whose old value autograd may need.

    Differentiable in both arguments: the stack cotangent passes through
    packed, and ``dA`` runs the symm kind on it — no dense n^2 buffer in
    either direction.
    """
    c_stack, a = _place(c_stack, device), _place(a, device)
    _bn, T = _check_rank_k(c_stack, a)
    out_dtype = c_stack.dtype if out_dtype is None else out_dtype
    donate = donate and out_dtype == c_stack.dtype \
        and c_stack.is_contiguous()
    if donate and torch.is_grad_enabled() and c_stack.requires_grad:
        raise ValueError(
            "rank_k_update(donate=True) writes the new stack over the "
            "incoming one, but autograd tracks that stack and may need its "
            "old value; pass donate=False to differentiate through it")
    cfg = _RankKConfig(
        levels=levels, variant=variant, gram=gram, bk=bk, T=T,
        out_dtype=out_dtype, stack_dtype=c_stack.dtype,
        pipeline_depth=_resolve_pipeline_depth(pipeline_depth, a.device),
        operand_dtype=_resolve_operand_dtype(operand_dtype),
        acc_dtype=_resolve_acc_dtype(acc_dtype), donate=donate)
    return _FusedRankK.apply(c_stack, a, cfg)


# ---------------------------------------------------------------------------
# Fused Strassen matmul: C = op(A) @ op(B), dense output.  The transposes
# are folded into how each side's tiles are read: no transposed copy of an
# operand exists.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _MatmulConfig:
    """The resolved knobs of one fused matmul."""
    levels: int
    variant: str
    bm: int
    bk: int
    bn: int
    trans_a: bool
    trans_b: bool
    out_dtype: torch.dtype
    bwd: str
    pipeline_depth: int
    operand_dtype: torch.dtype | None
    acc_dtype: str


def _pad_to(x: torch.Tensor, shape) -> torch.Tensor:
    if tuple(x.shape) == tuple(shape):
        return x
    return F.pad(x, (0, shape[1] - x.shape[1], 0, shape[0] - x.shape[0]))


def _prepare_matmul(a, b, levels, variant, bm, bk, bn, trans_a=False,
                    trans_b=False, pipeline_depth=1, operand_dtype=None,
                    acc_dtype="float32"):
    """Pad (each axis to its leaf grid) and quantize both operands as
    stored and bind the matmul program; returns ``(spec, padded a,
    padded b)``, what :func:`leaf_program` takes."""
    m, k = a.shape[::-1] if trans_a else a.shape
    n = b.shape[0] if trans_b else b.shape[1]
    geo = _matmul_geometry(m, k, n, levels, variant, bm, bk, bn, trans_a,
                           trans_b)
    M, K, N = geo["M"], geo["K"], geo["N"]
    a = _pad_to(a, (K, M) if trans_a else (M, K))
    b = _pad_to(b, (N, K) if trans_b else (K, N))
    a, b = _stored(a, operand_dtype), _stored(b, operand_dtype)
    spec = _bind(geo["plan"], n_out=(M // bm) * (N // bn), n_tj=N // bn,
                 q_i=geo["nbm"], q_j=geo["nbn"], n_k=geo["n_k"], bi=bm,
                 bj=bn, bc=bk, pipeline_depth=pipeline_depth,
                 acc_dtype=acc_dtype)
    return spec, a.contiguous(), b.contiguous()


def _fused_matmul_exec(a, b, *, levels, variant, bm, bk, bn, out_dtype,
                       trans_a=False, trans_b=False, pipeline_depth=1,
                       operand_dtype=None, acc_dtype="float32"):
    """One matmul-kind launch: ``op(a) @ op(b)`` at the original size."""
    m = a.shape[1] if trans_a else a.shape[0]
    n = b.shape[0] if trans_b else b.shape[1]
    spec, ap, bp = _prepare_matmul(a, b, levels, variant, bm, bk, bn,
                                   trans_a, trans_b, pipeline_depth,
                                   operand_dtype, acc_dtype)
    return leaf_program(spec, ap, bp, out_dtype)[:m, :n]


class _FusedMatmul(torch.autograd.Function):
    """``op(A) @ op(B)``; with ``bwd="fused"`` both VJP products are
    matmul-kind launches with the transposes folded into the operand
    orientation (the kernel upcasts tile-wise, so a bf16 residual feeds
    the backward without an fp32 copy)."""

    @staticmethod
    def forward(ctx, a, b, cfg):
        ctx.save_for_backward(a, b)
        ctx.cfg = cfg
        return _fused_matmul_exec(
            a, b, levels=cfg.levels, variant=cfg.variant, bm=cfg.bm,
            bk=cfg.bk, bn=cfg.bn, out_dtype=cfg.out_dtype,
            trans_a=cfg.trans_a, trans_b=cfg.trans_b,
            pipeline_depth=cfg.pipeline_depth,
            operand_dtype=cfg.operand_dtype, acc_dtype=cfg.acc_dtype)

    @staticmethod
    def backward(ctx, g):
        (a, b), cfg = ctx.saved_tensors, ctx.cfg
        acc = _promoted(a.dtype, b.dtype)
        gf = g.to(acc)
        bm, bk, bn = cfg.bm, cfg.bk, cfg.bn
        if cfg.bwd == "dense":
            ca = (a.T if cfg.trans_a else a).to(acc)
            cb = (b.T if cfg.trans_b else b).to(acc)
            with ieee_fp32():
                da, db = gf @ cb.T, ca.T @ gf
            if cfg.trans_a:
                da = da.T
            if cfg.trans_b:
                db = db.T
        else:
            ex = functools.partial(_fused_matmul_exec, levels=cfg.levels,
                                   variant=cfg.variant, out_dtype=acc,
                                   pipeline_depth=cfg.pipeline_depth)
            if not cfg.trans_a and not cfg.trans_b:
                # C = a b: da = g b^t; db = a^t g
                da = ex(gf, b, bm=bm, bk=bn, bn=bk, trans_b=True)
                db = ex(a, gf, bm=bk, bk=bm, bn=bn, trans_a=True)
            elif cfg.trans_a and cfg.trans_b:
                # C = a^t b^t: da = b^t g^t (stored (k, m));
                #              db = g^t a^t (stored (n, k))
                da = ex(b, gf, bm=bk, bk=bn, bn=bm, trans_a=True,
                        trans_b=True)
                db = ex(gf, a, bm=bn, bk=bm, bn=bk, trans_a=True,
                        trans_b=True)
            elif cfg.trans_a:
                # C = a^t b: da = b g^t (stored (k, m)); db = a g
                da = ex(b, gf, bm=bk, bk=bn, bn=bm, trans_b=True)
                db = ex(a, gf, bm=bk, bk=bm, bn=bn)
            else:
                # C = a b^t: da = g b (b stored (n, k)); db = g^t a
                da = ex(gf, b, bm=bm, bk=bn, bn=bk)
                db = ex(gf, a, bm=bn, bk=bm, bn=bk, trans_a=True)
        return da.to(a.dtype), db.to(b.dtype), None


def fused_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    levels: int = 2,
    variant: str = "strassen",
    bm: int = 256,
    bk: int = 256,
    bn: int = 256,
    trans_a: bool = False,
    trans_b: bool = False,
    out_dtype=None,
    bwd: str = "fused",
    pipeline_depth=None,
    operand_dtype=None,
    acc_dtype=None,
    device=None,
) -> torch.Tensor:
    """``op(a) @ op(b)`` via the flattened Strassen program, one kernel
    launch; ``op`` transposes where the flag is set, folded into how the
    kernel reads that side, so no transposed copy of an operand exists.
    The engine of the distributed ring / 2.5D block tasks, which are
    ``A_loc^t @ A_perm`` products.

    ``levels`` is a cap, clamped per axis so every leaf keeps at least
    one tile (``variant`` may be rectangular: bb322, bb422) and to the
    operand fan-in.  Differentiable: ``bwd="fused"`` (default) runs both
    VJP products as matmul-kind launches with the transposes folded;
    ``bwd="dense"`` is the classical product in torch.  ``device``,
    ``pipeline_depth`` and ``operand_dtype`` as in
    :func:`fused_ata_packed`.
    """
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"bad shapes for matmul: {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    k_a = a.shape[0] if trans_a else a.shape[1]
    k_b = b.shape[1] if trans_b else b.shape[0]
    if k_a != k_b:
        raise ValueError(
            f"bad shapes for matmul: {tuple(a.shape)} x {tuple(b.shape)} "
            f"(trans_a={trans_a}, trans_b={trans_b})")
    a, b = _place(a, device), _place(b, device)
    cfg = _MatmulConfig(
        levels=levels, variant=variant, bm=bm, bk=bk, bn=bn,
        trans_a=bool(trans_a), trans_b=bool(trans_b),
        out_dtype=(_promoted(a.dtype, b.dtype)
                   if out_dtype is None else out_dtype),
        bwd=_resolve_bwd(bwd),
        pipeline_depth=_resolve_pipeline_depth(pipeline_depth, a.device),
        operand_dtype=_resolve_operand_dtype(operand_dtype),
        acc_dtype=_resolve_acc_dtype(acc_dtype))
    return _FusedMatmul.apply(a, b, cfg)


# ---------------------------------------------------------------------------
# Analytic HBM traffic model of the bound program: tile fetches per step
# (including the padded null contribution slots, as the TPU kernel makes
# them), one write per output tile.
# ---------------------------------------------------------------------------

def _traffic(spec: _Spec, *, left_bytes: int, right_bytes: int,
             out_bytes: int, cin_bytes: int = 0) -> dict:
    """Core HBM model of one bound program: streamed tile fetches
    (incl. padded null contribution slots), one write per output tile,
    plus the incoming stack read for accumulating programs."""
    grid = spec.grid_steps
    l_tile = spec.bi * spec.bc
    r_tile = (spec.bj * spec.bj) if spec.right_tri else spec.bj * spec.bc
    reads = grid * spec.tmax * (l_tile * left_bytes + r_tile * right_bytes)
    if spec.accumulate:
        reads += spec.n_out * spec.bi * spec.bj * cin_bytes
    writes = spec.n_out * spec.bi * spec.bj * out_bytes
    # one (bi, bc) x (bc, bj) leaf product per step; the gather adds are
    # second-order
    flops = 2 * grid * spec.bi * spec.bc * spec.bj
    return {"grid_steps": grid, "read_bytes": reads, "write_bytes": writes,
            "flops": flops}


def ata_traffic_model(
    m: int, n: int, *, levels: int = 2, variant: str = "strassen",
    gram: str = "strassen",
    bk: int = 256, bn: int = 256, in_bytes: int = 4, out_bytes: int = 4,
) -> dict:
    """HBM bytes of ``fused_ata_packed`` on an (m, n) input.

    ``intermediate_bytes`` is the zero-pad copy of A when the shape is
    not tile-aligned, 0 otherwise.  Uses the executor's ``_ata_geometry``.
    """
    geo = _ata_geometry(m, n, levels, variant, bk, bn, gram=gram)
    M, N = geo["M"], geo["N"]
    spec = _bind(geo["plan"], n_out=geo["n_tri"], n_tj=0, q_i=geo["nbt"],
                 q_j=geo["nbt"], n_k=geo["n_k"], bi=bn, bj=bn, bc=bk)
    t = _traffic(spec, left_bytes=in_bytes, right_bytes=in_bytes,
                 out_bytes=out_bytes)
    t["intermediate_bytes"] = M * N * in_bytes if (M, N) != (m, n) else 0
    t["padded_shape"] = (M, N)
    return t


def aat_traffic_model(
    m: int, n: int, *, levels: int = 2, variant: str = "strassen",
    gram: str = "strassen",
    bm: int = 256, bk: int = 256, in_bytes: int = 4, out_bytes: int = 4,
) -> dict:
    """HBM bytes of ``fused_aat_packed`` (row gram) — same core model,
    the row-gram geometry."""
    geo = _aat_geometry(m, n, levels, variant, bm, bk, gram=gram)
    M, N = geo["M"], geo["N"]
    spec = _bind(geo["plan"], n_out=geo["n_tri"], n_tj=0, q_i=geo["nbt"],
                 q_j=geo["nbt"], n_k=geo["n_k"], bi=bm, bj=bm, bc=bk)
    t = _traffic(spec, left_bytes=in_bytes, right_bytes=in_bytes,
                 out_bytes=out_bytes)
    t["intermediate_bytes"] = M * N * in_bytes if (M, N) != (m, n) else 0
    t["padded_shape"] = (M, N)
    return t


def rank_k_traffic_model(
    m: int, n: int, *, levels: int = 2, variant: str = "strassen",
    gram: str = "strassen",
    bk: int = 256, bn: int = 256, state_bytes: int = 4, in_bytes: int = 4,
) -> dict:
    """HBM bytes of one ``fused_rank_k_update`` chunk against the
    streamed update it replaces (ata kernel, delta stack, gather-add: the
    delta stack is written and re-read, the state read and rewritten)."""
    T = _round_up(max(n, 1), bn) // bn
    # the stack layout fixes T; mirror the executor's divisibility clamp
    geo = _rank_k_geometry(m, T, levels, variant, bk, gram=gram)
    M, N = geo["M"], T * bn
    spec = _bind(geo["plan"], n_out=geo["n_tri"], n_tj=0, q_i=geo["nbt"],
                 q_j=geo["nbt"], n_k=geo["n_k"], bi=bn, bj=bn, bc=bk)
    t = _traffic(spec, left_bytes=in_bytes, right_bytes=in_bytes,
                 out_bytes=state_bytes, cin_bytes=state_bytes)
    stack_bytes = geo["n_tri"] * bn * bn * state_bytes
    t["intermediate_bytes"] = (M * N * in_bytes if (M, N) != (m, n) else 0)
    t["padded_shape"] = (M, N)
    t["state_bytes"] = stack_bytes
    t["baseline"] = {
        "read_bytes": (t["read_bytes"] - stack_bytes) + 2 * stack_bytes,
        "write_bytes": 2 * stack_bytes,
        "intermediate_bytes": t["intermediate_bytes"] + stack_bytes,
    }
    return t


def ata_bwd_traffic_model(
    m: int, n: int, *, levels: int = 2, variant: str = "strassen",
    gram: str = "strassen",
    bk: int = 256, bn: int = 256, in_bytes: int = 4, cot_bytes: int = 4,
    cotangent: str = "packed",
) -> dict:
    """HBM bytes of the Gram backward ``dA = A (S + S^t)`` on an (m, n)
    forward problem: the fused symm-kind kernel against the dense-dot
    baseline.  Shares ``_ata_geometry`` / ``_symm_geometry`` with the
    executors, so it cannot drift from their clamping.

    ``cotangent="packed"``: the cotangent arrives as the packed stack
    (``fused_ata_packed``'s backward) and feeds the kernel directly.
    ``cotangent="dense"``: the dense entry first gathers tril(g) into
    the packed stack, the only temporary.  The baseline counts what the
    dense-dot backward builds: ``tril(g)``, ``S^t`` and ``S + S^t``,
    three dense N^2 buffers.
    """
    geo = _ata_geometry(m, n, levels, variant, bk, bn, gram=gram)
    M, N = geo["M"], geo["N"]
    T = N // bn
    sgeo = _symm_geometry(M, T, geo["levels"], variant, bk)
    plan, q = sgeo["plan"], sgeo["q"]
    assert sgeo["M"] == M, (sgeo["M"], M)   # bwd reuses the forward padding
    spec = _bind(plan, n_out=(M // bk) * T, n_tj=T, q_i=sgeo["nbm"],
                 q_j=q, n_k=q, bi=bk, bj=bn, bc=bn, diag_sym=True)
    t = _traffic(spec, left_bytes=in_bytes, right_bytes=cot_bytes,
                 out_bytes=4)            # dA in the fp32 accumulation dtype
    stack_bytes = T * (T + 1) // 2 * bn * bn * cot_bytes
    pad_copy = M * N * in_bytes if (M, N) != (m, n) else 0
    fused_inter = pad_copy + (stack_bytes if cotangent == "dense" else 0)
    dense_inter = 3 * N * N * cot_bytes
    t.update({
        "intermediate_bytes": fused_inter,
        "packed_stack_bytes": stack_bytes,
        "padded_shape": (M, N),
        "levels": sgeo["levels"],
        "dense_baseline": {
            "read_bytes": M * N * in_bytes + N * N * cot_bytes,
            "write_bytes": M * N * 4,
            "intermediate_bytes": dense_inter,
        },
        "intermediate_ratio_dense_over_fused": (
            dense_inter / fused_inter if fused_inter else None),
    })
    return t


def live_steps(spec: _Spec) -> int:
    """(tile, contribution, K block) steps with a nonzero sign, ``2 * bi *
    bj * bc`` flops each: the steps of the TPU kernel's walk, which
    :func:`_leaf_program_plain` follows.  They count the per-destination
    recomputation that ``csrc/leaf_products.cu`` does not do
    (:func:`product_flops`)."""
    sign = _program_tables(spec.kind, spec.levels, spec.variant,
                           spec.gram, spec.trans_a, spec.trans_b)[0]
    live_per_dest = torch.from_numpy((sign != 0).sum(axis=1))
    if not spec.out_tri:        # every leaf destination has q_i * q_j tiles
        return int(live_per_dest.sum()) * spec.q_i * spec.q_j * spec.n_k
    ld, _, _ = _out_tiles(spec, "cpu")
    return int(live_per_dest[ld].sum()) * spec.n_k
