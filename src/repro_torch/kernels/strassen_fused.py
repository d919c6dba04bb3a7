"""The fused leaf-program executor of the PyTorch port, ata kind.

The port of the host side of ``repro/kernels/strassen_fused.py``.  A
``LeafProgram`` (``core/leaf_ir.py``) is bound to tile sizes
(:class:`_Spec`), lowered to eight tables (:func:`_program_tables`) and
run by :func:`leaf_program`:

* on a CUDA tensor, the hand-written kernel ``csrc/leaf_program.cu``
  (one thread block per (packed output tile, 64 x 64 sub-tile); the
  contribution x K sweep loops inside the block behind a
  ``pipeline_depth``-slot ``cp.async`` ring);
* on a CPU tensor, :func:`_leaf_program_plain`, a torch walk over the
  same tables — the counterpart of Pallas interpret mode, and the plain
  version the kernel is held against on the card.

Each packed lower-triangular output tile is written once.  The analytic
traffic model (:func:`ata_traffic_model`) shares the executor's
geometry, so it cannot drift from the padding and clamping it runs.
Only the ``ata`` kind is ported; aat, symm, rank_k and matmul are
ROADMAP Queue 2.
"""
from __future__ import annotations

import ctypes
import functools
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
from .ops import _place

__all__ = ["fused_ata", "fused_ata_packed", "ata_traffic_model",
           "leaf_program", "KERNEL_LAUNCHES", "MAX_OPERAND_TERMS",
           "MAX_PIPELINE_DEPTH"]


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


# Operand fan-in cap: the kernel gathers up to 2 * max_terms operand
# chunks per step into shared memory, so deep programs are clamped.
MAX_OPERAND_TERMS = 8

# Ring depth cap: each slot holds another 2 * max_terms raw chunks.
MAX_PIPELINE_DEPTH = 4

# Shared memory one thread block may use on Hopper (227 KB).
SMEM_LIMIT_BYTES = 232_448

# Operand-tile storage dtypes the JAX executor takes; the port runs
# fp32 and bf16 tiles, the rest are ROADMAP Queue 1 #6.
_SUPPORTED_OPERAND_DTYPES = ("float8_e4m3fn", "float8_e5m2", "bfloat16",
                             "float16", "float32", "float64")
_PORTED_OPERAND_DTYPES = ("bfloat16", "float32")

# dtype codes of the C interface
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Launches of each CUDA kernel, bumped where the kernel is launched and
#: nowhere else — a run reads it to show the main path went through it.
KERNEL_LAUNCHES = {"leaf_program": 0}

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
    if name not in _PORTED_OPERAND_DTYPES:
        raise NotImplementedError(
            f"operand_dtype={name!r} is not ported yet (ROADMAP Queue 1 "
            f"#6); the port takes {_PORTED_OPERAND_DTYPES}")
    return getattr(torch, name)


def _resolve_acc_dtype(acc_dtype):
    name = "float32" if acc_dtype is None else _dtype_name(acc_dtype)
    if name not in ("float32", "bfloat16", "float64"):
        raise ValueError(f"acc_dtype={name!r}: the accumulator must be "
                         "float32 (default), bfloat16 or float64")
    if name != "float32":
        raise NotImplementedError(
            f"acc_dtype={name!r} is not ported yet (ROADMAP Queue 1 #6); "
            "the kernel accumulates in float32")
    return name


def _resolve_sr_seed(sr_seed):
    if sr_seed is not None:
        raise NotImplementedError(
            "sr_seed (stochastically rounded bf16 output) is not ported yet "
            "(ROADMAP Queue 1 #6)")


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


def _refuse_grad(a: torch.Tensor) -> None:
    if torch.is_grad_enabled() and a.requires_grad:
        raise NotImplementedError(
            "gradients through the fused path are not ported yet (ROADMAP "
            "Queue 1 #4); use mode='reference' or torch.no_grad()")


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
# (0, 0).  rtrn (per-term mirrors of a tri-stored right operand) is
# lowered for every kind and read by none that the port runs yet.
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
                   device: str):
    """The lowered tables as tensors on ``device``, uploaded once."""
    return tuple(torch.from_numpy(t).to(device)
                 for t in _program_tables(kind, levels, variant, gram))


# a re-registered algebra table must invalidate the lowered tables too —
# compile_program.cache_clear() alone would leave these stale
leaf_ir.on_algebra_change(_program_tables.cache_clear)
leaf_ir.on_algebra_change(_device_tables.cache_clear)


# ---------------------------------------------------------------------------
# The executor: the CUDA kernel and its plain version.
# ---------------------------------------------------------------------------

def _out_tiles(spec: _Spec, device):
    """Per output tile: leaf destination ``ld`` and the within-leaf tile
    offsets ``(iq, jq)`` — the kernel's tri-decode, for all tiles."""
    t_blocks = spec.q_i * spec.blocks_j
    ij = tri_coords(t_blocks).long().to(device)
    gi, gj = ij[:, 0], ij[:, 1]
    di, dj = gi // spec.q_i, gj // spec.q_j
    return di * (di + 1) // 2 + dj, gi % spec.q_i, gj % spec.q_j


def _leaf_program_plain(spec: _Spec, tables, a: torch.Tensor,
                        out_dtype) -> torch.Tensor:
    """The plain torch version of the kernel: the same tables, the same
    walk (contributions, then K blocks), over every output tile at once.

    Per (contribution, K block) step it gathers each term's (bc, bi)
    tile of A for all tiles, forms the signed sums in fp32 in term order,
    and adds ``sign * Lsum^t Rsum`` where the sign is not 0.
    """
    sign, lrow, lcol, lsgn, rrow, rcol, rsgn, _rtrn = tables
    ld, iq, jq = _out_tiles(spec, a.device)
    M, N = a.shape
    tiles = a.reshape(M // spec.bc, spec.bc, N // spec.bi, spec.bi) \
        .permute(0, 2, 1, 3)

    def signed_sum(rows, cols, coefs, c, k, q, within):
        acc = None
        for p in range(spec.tmax):
            tile = tiles[rows[ld, c, p].long() * spec.n_k + k,
                         cols[ld, c, p].long() * q + within]
            term = tile.float() * coefs[ld, c, p][:, None, None]
            acc = term if acc is None else acc + term
        return acc

    acc = torch.zeros((spec.n_out, spec.bi, spec.bj), dtype=torch.float32,
                      device=a.device)
    with ieee_fp32():
        for c in range(spec.n_c):
            sgn = sign[ld, c][:, None, None]
            for k in range(spec.n_k):
                left = signed_sum(lrow, lcol, lsgn, c, k, spec.q_i, iq)
                right = signed_sum(rrow, rcol, rsgn, c, k, spec.q_j, jq)
                contrib = sgn * torch.bmm(left.transpose(1, 2), right)
                acc += torch.where(sgn != 0, contrib, 0.0)
    return acc.reshape(spec.n_out * spec.bi, spec.bj).to(out_dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("leaf_program")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.leaf_program_ata.argtypes = [ptr] * 9 + [ctypes.c_longlong] \
        + [i32] * 10 + [ptr]
    lib.leaf_program_ata.restype = i32
    lib.leaf_program_smem_bytes.argtypes = [i32, i32, i32]
    lib.leaf_program_smem_bytes.restype = ctypes.c_size_t
    lib.leaf_program_max_contributions.argtypes = []
    lib.leaf_program_max_contributions.restype = i32
    lib.leaf_program_error_string.argtypes = [i32]
    lib.leaf_program_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_args(spec: _Spec, a: torch.Tensor, out_dtype) -> None:
    if spec.kind != "ata":
        raise NotImplementedError(
            f"the {spec.kind!r} program kind has no CUDA kernel yet "
            "(ROADMAP Queue 2 #1)")
    if a.dtype not in _DTYPE_CODES:
        raise TypeError(f"leaf_program takes float32 or bfloat16 operands, "
                        f"got {a.dtype}")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"leaf_program writes float32 or bfloat16, got "
                        f"{out_dtype}")
    B = 2 ** spec.levels
    want = (B * spec.n_k * spec.bc, B * spec.q_i * spec.bi)
    if a.ndim != 2 or tuple(a.shape) != want:
        raise ValueError(f"operand of shape {tuple(a.shape)} does not fit "
                         f"the bound program (want {want})")
    if not a.is_contiguous() or a.data_ptr() % 16:
        raise ValueError("leaf_program needs a contiguous, 16-byte aligned "
                         "operand")
    if spec.bi != spec.bj or spec.q_i != spec.q_j:
        raise ValueError("the ata kernel takes square output tiles")
    if spec.bi < 8 or spec.bi % 8 or spec.bc < 8:
        raise ValueError(f"leaf_program needs bn >= 8 with bn % 8 == 0 "
                         f"and bk >= 8, got bn={spec.bi}, bk={spec.bc}")


def leaf_program(spec: _Spec, a: torch.Tensor, out_dtype) -> torch.Tensor:
    """Run a bound ata program on the padded operand ``a``.

    A CUDA tensor launches ``csrc/leaf_program.cu`` on the current
    stream (no synchronisation) or raises; a CPU tensor runs
    :func:`_leaf_program_plain`.  Returns the packed stack
    ``(n_out * bn, bn)`` in ``out_dtype``.
    """
    tables = _device_tables(spec.kind, spec.levels, spec.variant, spec.gram,
                            str(a.device))
    if a.device.type == "cpu":
        return _leaf_program_plain(spec, tables, a, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"leaf_program runs on cuda or cpu, not "
                         f"{a.device}")
    _check_kernel_args(spec, a, out_dtype)
    lib = _lib()
    if spec.n_c > lib.leaf_program_max_contributions():
        raise ValueError(f"{spec.n_c} contribution slots exceed the "
                         f"kernel's {lib.leaf_program_max_contributions()}")
    smem = lib.leaf_program_smem_bytes(spec.tmax, a.element_size(),
                                       spec.pipeline_depth)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"pipeline_depth={spec.pipeline_depth} with {spec.tmax} operand "
            f"terms needs {smem} bytes of shared memory, over the "
            f"{SMEM_LIMIT_BYTES} a Hopper block can use; lower "
            "pipeline_depth")
    out = torch.empty((spec.n_out * spec.bi, spec.bj), dtype=out_dtype,
                      device=a.device)
    with torch.cuda.device(a.device):
        err = lib.leaf_program_ata(
            a.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in tables[:7]),
            a.shape[1], spec.n_out, spec.n_c, spec.n_k, spec.tmax, spec.q_i,
            spec.bi, spec.bc, _DTYPE_CODES[a.dtype], _DTYPE_CODES[out_dtype],
            spec.pipeline_depth, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"leaf_program launch failed: CUDA error {err} "
                           f"({lib.leaf_program_error_string(err).decode()})")
    KERNEL_LAUNCHES["leaf_program"] += 1
    return out


# ---------------------------------------------------------------------------
# Fused ATA: C = tril(A^t A) into the packed triangular block stack.
# ---------------------------------------------------------------------------

def fused_ata_packed(
    a: torch.Tensor,
    *,
    levels: int = 2,
    variant: str = "strassen",
    gram: str = "strassen",
    bk: int = 256,
    bn: int = 256,
    out_dtype=None,
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

    ``device=None`` runs on the card; a CPU tensor is moved there unless
    ``device="cpu"``, which runs the plain executor.  ``pipeline_depth``
    is the kernel's ring depth (None = 2 on the card, 1 on the CPU);
    ``operand_dtype`` (None, fp32 or bf16) the stored operand tiles.
    ``acc_dtype`` other than fp32 and ``sr_seed`` are ROADMAP Queue 1 #6;
    gradients are Queue 1 #4.
    """
    a = _place(a, device)
    _refuse_grad(a)
    depth = _resolve_pipeline_depth(pipeline_depth, a.device)
    op_dt = _resolve_operand_dtype(operand_dtype)
    acc_dt = _resolve_acc_dtype(acc_dtype)
    _resolve_sr_seed(sr_seed)
    out_dtype = (torch.promote_types(a.dtype, torch.float32)
                 if out_dtype is None else out_dtype)
    return _fused_ata_packed_exec(a, levels, variant, gram, bk, bn,
                                  out_dtype, depth, op_dt, acc_dt)


def _prepare_ata(a, levels, variant, gram, bk, bn, pipeline_depth=1,
                 operand_dtype=None, acc_dtype="float32"):
    """Pad and quantize ``a`` and bind the ata program to its tiles;
    returns ``(spec, padded a)``, what :func:`leaf_program` takes."""
    if a.ndim != 2:
        raise ValueError(f"fused ata expects a matrix, got shape "
                         f"{tuple(a.shape)}")
    m, n = a.shape
    geo = _ata_geometry(m, n, levels, variant, bk, bn, gram=gram)
    M, N = geo["M"], geo["N"]
    if (M, N) != (m, n):
        a = F.pad(a, (0, N - n, 0, M - m))
    if operand_dtype is not None:
        # operand tiles are stored (and copied) at this precision; every
        # sum upcasts to fp32
        a = a.to(operand_dtype)
    spec = _bind(geo["plan"], n_out=geo["n_tri"], n_tj=0, q_i=geo["nbt"],
                 q_j=geo["nbt"], n_k=geo["n_k"], bi=bn, bj=bn, bc=bk,
                 pipeline_depth=pipeline_depth, acc_dtype=acc_dtype)
    return spec, a.contiguous()


def _fused_ata_packed_exec(a, levels, variant, gram, bk, bn, out_dtype,
                           pipeline_depth=1, operand_dtype=None,
                           acc_dtype="float32"):
    """Pad, quantize, bind and run; returns ``(packed, n_padded)``."""
    spec, a = _prepare_ata(a, levels, variant, gram, bk, bn, pipeline_depth,
                           operand_dtype, acc_dtype)
    return leaf_program(spec, a, out_dtype), a.shape[1]


def fused_ata(
    a: torch.Tensor,
    *,
    levels: int = 2,
    variant: str = "strassen",
    gram: str = "strassen",
    bk: int = 256,
    bn: int = 256,
    out_dtype=None,
    pipeline_depth=None,
    operand_dtype=None,
    acc_dtype=None,
    sr_seed=None,
    device=None,
) -> torch.Tensor:
    """Dense ``tril(a.T @ a)`` at the original size via the fused
    executor; the knobs are :func:`fused_ata_packed`'s."""
    n = a.shape[-1]
    packed, n_pad = fused_ata_packed(
        a, levels=levels, variant=variant, gram=gram, bk=bk, bn=bn,
        out_dtype=out_dtype, pipeline_depth=pipeline_depth,
        operand_dtype=operand_dtype, acc_dtype=acc_dtype, sr_seed=sr_seed,
        device=device)
    dense = unpack_tril_blocks(packed, n_pad, bn, symmetrize=False)
    # diagonal blocks are computed full — drop their upper halves
    return torch.tril(dense)[:n, :n]


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


def live_steps(spec: _Spec) -> int:
    """(tile, contribution, K block) steps with a nonzero sign — the
    steps the kernel runs; ``2 * bi * bj * bc`` flops each."""
    sign = _program_tables(spec.kind, spec.levels, spec.variant,
                           spec.gram)[0]
    ld, _, _ = _out_tiles(spec, "cpu")
    live_per_dest = torch.from_numpy((sign != 0).sum(axis=1))
    return int(live_per_dest[ld].sum()) * spec.n_k
