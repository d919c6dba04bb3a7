"""Leaf-program IR: one compilable representation for every fused variant.

The PyTorch port's copy of ``repro/core/leaf_ir.py``.  The module is
numpy only; the port keeps its own copy so that it never imports the JAX
package, and :func:`import_algebras` moves registered tables across.

A fast-matmul variant is *data* (Benson & Ballard, "A Framework for
Practical Parallel Fast Matrix Multiplication"): an algebra table of
(operand quadrants, output quadrants) coefficient rows fed to one
generic executor.  Two registries drive the compiler:

* **Algebra tables** (:data:`ALGEBRAS`, :func:`register_algebra`) — the
  per-level multiplication expansion rules over an ``<m, k, n>`` block
  grid.  strassen / winograd / classical / bb322 / bb422 ship
  registered; registration runs a levels=1 numeric identity check.
* **Gram algebras** (:data:`GRAM_ALGEBRAS`,
  :func:`register_gram_algebra`) — the symmetric recursion itself as a
  table: ``strassen`` (``G(l) = 4 G(l-1) + 2 t^(l-1)``) and ``dps``
  (``G(l) = 2 G(l-1) + 3 t^(l-1)``, arXiv 2001.04109).

:func:`compile_program` flattens a *kind* (``ata`` | ``aat`` | ``matmul``
| ``symm`` | ``rank_k``) against the tables into a :class:`LeafProgram`;
``kernels/strassen_fused.py`` binds it to tiles and lowers it to the
eight tables its CUDA kernel reads.  :func:`interpret_program` is the
dense float64 oracle.

Kinds:

``ata``     C = tril(A^t A)       — paper Alg. 1 (column gram).
``aat``     C = tril(A A^t)       — Arrigoni-Massini 2021 (row gram).
``matmul``  C = op(A) @ op(B)     — level-capped fast matmul.
``symm``    D = X @ Sym           — Sym stored as its lower triangle.
``rank_k``  C += A^t A            — ``ata`` with an accumulating output.
"""
from __future__ import annotations

from dataclasses import dataclass, field
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "ALGEBRAS", "register_algebra", "get_algebra", "algebra_dims",
    "registered_algebras",
    "GRAM_ALGEBRAS", "register_gram_algebra", "get_gram_algebra",
    "registered_gram_algebras",
    "OperandSpec", "OutputSpec", "LeafOp", "Contribution", "LeafProgram",
    "PROGRAM_KINDS", "compile_program", "interpret_program",
    "on_algebra_change", "import_algebras",
]

# A term is (row_block, col_block, coeff, trans) over the leaf grid of
# the STORED operand; trans = 1 means the leaf is read transposed
# (symm: the term was mirrored onto the stored lower triangle).  Coeffs
# are small rationals — the classic tables use only +-1, the dps gram
# algebra needs +-1/2 and +-1/4.
Term = Tuple[int, int, float, int]
# A destination is (dest_row_block, dest_col_block, coeff, trans);
# trans = 1 places the product transposed (gram kinds only).
Dest = Tuple[int, int, float, int]

PROGRAM_KINDS = ("ata", "aat", "matmul", "symm", "rank_k")


# ---------------------------------------------------------------------------
# Algebra-table registry (Benson-Ballard: variants are data, not code)
# ---------------------------------------------------------------------------

# Strassen's 7 products, matching strassen.py (incl. the M7 sign erratum
# fix recorded in DESIGN.md §9: second operand of M7 is B21 + B22).
_STRASSEN = (
    # M1 = (A11 + A22)(B11 + B22) -> C11 + C22
    (((0, 0, 1), (1, 1, 1)), ((0, 0, 1), (1, 1, 1)), ((0, 0, 1), (1, 1, 1))),
    # M2 = (A21 + A22) B11 -> C21 - C22
    (((1, 0, 1), (1, 1, 1)), ((0, 0, 1),), ((1, 0, 1), (1, 1, -1))),
    # M3 = A11 (B12 - B22) -> C12 + C22
    (((0, 0, 1),), ((0, 1, 1), (1, 1, -1)), ((0, 1, 1), (1, 1, 1))),
    # M4 = A22 (B21 - B11) -> C11 + C21
    (((1, 1, 1),), ((1, 0, 1), (0, 0, -1)), ((0, 0, 1), (1, 0, 1))),
    # M5 = (A11 + A12) B22 -> -C11 + C12
    (((0, 0, 1), (0, 1, 1)), ((1, 1, 1),), ((0, 0, -1), (0, 1, 1))),
    # M6 = (A21 - A11)(B11 + B12) -> C22
    (((1, 0, 1), (0, 0, -1)), ((0, 0, 1), (0, 1, 1)), ((1, 1, 1),)),
    # M7 = (A12 - A22)(B21 + B22) -> C11
    (((0, 1, 1), (1, 1, -1)), ((1, 0, 1), (1, 1, 1)), ((0, 0, 1),)),
)

# Winograd's variant (7 mults / 15 adds), destinations expanded from the
# u-term recombination in strassen.py.
_WINOGRAD = (
    # M1 = A11 B11
    (((0, 0, 1),), ((0, 0, 1),),
     ((0, 0, 1), (0, 1, 1), (1, 0, 1), (1, 1, 1))),
    # M2 = A12 B21
    (((0, 1, 1),), ((1, 0, 1),), ((0, 0, 1),)),
    # M3 = (A11 + A12 - A21 - A22) B22
    (((0, 0, 1), (0, 1, 1), (1, 0, -1), (1, 1, -1)), ((1, 1, 1),),
     ((0, 1, 1),)),
    # M4 = A22 (B11 - B12 - B21 + B22)
    (((1, 1, 1),), ((0, 0, 1), (0, 1, -1), (1, 0, -1), (1, 1, 1)),
     ((1, 0, -1),)),
    # M5 = (A21 + A22)(B12 - B11)
    (((1, 0, 1), (1, 1, 1)), ((0, 1, 1), (0, 0, -1)),
     ((0, 1, 1), (1, 1, 1))),
    # M6 = (A21 + A22 - A11)(B11 + B22 - B12)
    (((1, 0, 1), (1, 1, 1), (0, 0, -1)), ((0, 0, 1), (1, 1, 1), (0, 1, -1)),
     ((0, 1, 1), (1, 0, 1), (1, 1, 1))),
    # M7 = (A11 - A21)(B22 - B12)
    (((0, 0, 1), (1, 0, -1)), ((1, 1, 1), (0, 1, -1)),
     ((1, 0, 1), (1, 1, 1))),
)

# Classical 2x2 block multiply in the same representation (8 products).
_CLASSICAL = tuple(
    (((i, k, 1),), ((k, j, 1),), ((i, j, 1),))
    for i in (0, 1) for j in (0, 1) for k in (0, 1)
)


def _rect_classical(dm: int, dk: int, dn: int, rows, cols):
    """Classical products covering A-rows ``rows`` x C-cols ``cols``."""
    return tuple(
        (((i, k, 1),), ((k, j, 1),), ((i, j, 1),))
        for i in rows for j in cols for k in range(dk)
    )


# <3, 2, 2>: Strassen's 7 on the top 2x2 A-rows + 4 classical products
# for row 2 — 11 products, the Hopcroft-Kerr rank for this shape
# (Benson-Ballard, arXiv 1409.2908: rectangular base cases fit
# tall-skinny operands better than repeated square splits).
_BB322 = _STRASSEN + _rect_classical(3, 2, 2, rows=(2,), cols=(0, 1))

# <4, 2, 2>: two Strassen copies on A-row pairs (0,1) and (2,3) — 14
# products vs the classical 16.
_BB422 = _STRASSEN + tuple(
    (tuple((r + 2, c, s) for r, c, s in a_q), b_q,
     tuple((r + 2, c, s) for r, c, s in d_q))
    for a_q, b_q, d_q in _STRASSEN
)

#: name -> algebra table.  Mutated only through :func:`register_algebra`.
ALGEBRAS: Dict[str, tuple] = {}

#: name -> the <m, k, n> split the table describes (A splits m x k,
#: B splits k x n, C splits m x n per recursion level).
_ALGEBRA_DIMS: Dict[str, Tuple[int, int, int]] = {}

#: name -> gram-algebra entry.  Mutated only through
#: :func:`register_gram_algebra`.
GRAM_ALGEBRAS: Dict[str, dict] = {}

#: callbacks run whenever either registry changes — downstream lru
#: caches keyed on the variant/gram name (the executor's lowered
#: tables in ``kernels/strassen_fused.py``) register here so a
#: re-registration cannot leave a stale compiled table behind.
_INVALIDATION_HOOKS: list = []


def on_algebra_change(fn) -> None:
    """Register ``fn()`` to run whenever an algebra table is
    (re)registered.  Used by variant-keyed caches downstream."""
    _INVALIDATION_HOOKS.append(fn)


def _invalidate() -> None:
    # re-registration changes what compile_program(levels, name) means —
    # and every downstream cache keyed on the variant/gram name
    if "compile_program" in globals():
        compile_program.cache_clear()
    for fn in _INVALIDATION_HOOKS:
        fn()


def _check_coeff(s, where: str, name: str) -> None:
    if isinstance(s, bool) or not isinstance(s, (int, float)) \
            or not np.isfinite(s) or s == 0:
        raise ValueError(f"coefficient must be a nonzero finite real, "
                         f"got {s!r} in {where} of algebra {name!r}")


def _smoke_check_algebra(name: str, table, dims) -> None:
    """Cheap levels=1 numeric identity check against the dense oracle.

    Scalar blocks suffice: the tables are bilinear with no per-quad
    transposes, so the identity on scalars implies it on matrix blocks.
    """
    dm, dk, dn = dims
    rng = np.random.default_rng(0)
    for _ in range(2):
        a = rng.standard_normal((dm, dk))
        b = rng.standard_normal((dk, dn))
        c = np.zeros((dm, dn))
        for a_q, b_q, d_q in table:
            p = sum(s * a[r, cc] for r, cc, s in a_q) \
                * sum(s * b[r, cc] for r, cc, s in b_q)
            for r, cc, s in d_q:
                c[r, cc] += s * p
        err = float(np.abs(c - a @ b).max())
        if err > 1e-8:
            raise ValueError(
                f"algebra {name!r} fails the levels=1 multiplication "
                f"identity against the dense oracle (max err {err:.3e})")


def register_algebra(name: str, table, *, dims=(2, 2, 2),
                     overwrite: bool = False) -> None:
    """Register an ``<m, k, n>``-recursion algebra table under ``name``.

    ``table`` is a non-empty tuple of rows ``(a_quads, b_quads,
    dest_quads)``; each quad list is a non-empty tuple of
    ``(row, col, coeff)`` entries — ``a_quads`` over the ``m x k`` grid,
    ``b_quads`` over ``k x n``, ``dest_quads`` over ``m x n`` — with
    nonzero real coefficients.  ``dims`` defaults to the square
    ``<2, 2, 2>`` split.  Registration validates the format AND runs a
    levels=1 numeric identity smoke-check against the dense oracle, so
    an algebraically wrong table fails fast with a clear message instead
    of surfacing later as an interpreter/executor parity miss.
    """
    if not overwrite and name in ALGEBRAS:
        raise ValueError(f"algebra {name!r} already registered")
    dims = tuple(int(d) for d in dims)
    if len(dims) != 3 or any(d < 1 for d in dims):
        raise ValueError(f"dims must be three positive ints <m, k, n>, "
                         f"got {dims!r}")
    dm, dk, dn = dims
    table = tuple(table)
    if not table:
        raise ValueError(f"algebra {name!r} table must be non-empty")
    bounds = ((dm, dk), (dk, dn), (dm, dn))
    labels = ("a_quads", "b_quads", "dest_quads")
    for row in table:
        if len(row) != 3:
            raise ValueError(f"algebra row must be (a, b, dest) triple: "
                             f"{row!r}")
        for quads, (rb, cb), lbl in zip(row, bounds, labels):
            if not quads:
                raise ValueError(f"empty {lbl} list in algebra {name!r} "
                                 f"row {row!r}")
            for q in quads:
                if len(q) != 3:
                    raise ValueError(f"quadrant entry must be "
                                     f"(row, col, coeff): {q!r} in {name!r}")
                r, c, s = q
                if not isinstance(r, int) or not isinstance(c, int) \
                        or not (0 <= r < rb) or not (0 <= c < cb):
                    raise ValueError(f"bad quadrant entry {q!r} in {name!r} "
                                     f"(grid is {rb}x{cb} for {lbl})")
                _check_coeff(s, lbl, name)
    norm = tuple(tuple(tuple(map(tuple, q)) for q in (a, b, d))
                 for a, b, d in table)
    _smoke_check_algebra(name, norm, dims)
    ALGEBRAS[name] = norm
    _ALGEBRA_DIMS[name] = dims
    _invalidate()


def get_algebra(name: str) -> tuple:
    try:
        return ALGEBRAS[name]
    except KeyError:
        raise ValueError(
            f"unknown algebra {name!r}; registered: "
            f"{sorted(ALGEBRAS)}") from None


def algebra_dims(name: str) -> Tuple[int, int, int]:
    """The ``<m, k, n>`` per-level split of a registered algebra."""
    get_algebra(name)
    return _ALGEBRA_DIMS[name]


def registered_algebras() -> Tuple[str, ...]:
    return tuple(sorted(ALGEBRAS))


register_algebra("strassen", _STRASSEN)
register_algebra("winograd", _WINOGRAD)
register_algebra("classical", _CLASSICAL)
register_algebra("bb322", _BB322, dims=(3, 2, 2))
register_algebra("bb422", _BB422, dims=(4, 2, 2))


# ---------------------------------------------------------------------------
# Gram-algebra registry: the symmetric recursion itself as data
# ---------------------------------------------------------------------------
#
# A gram algebra describes ONE level of C = Y Y^t over the 2x2 split of
# Y along (gram axis g, other axis o) — the row split for ``aat``, the
# column split for ``ata`` (one table serves both orientations: the
# column gram is the row gram of Y^t, and terms are stored-block
# agnostic until the compiler maps (g, o) onto the stored grid).
#
#   sym products:  (terms, dests)        P = G(sum_k c_k Y[g_k, o_k])
#   mm  products:  (left, right, dests)  P = (sum L)(sum R)^t
#
# ``terms`` entries are (g, o, coeff); ``dests`` entries are
# (di, dj, coeff, trans) over the 2x2 output grid with di >= dj (the
# upper triangle is implied by symmetry of C) — each dest states the
# FULL content of that output block: C[di, dj] += coeff * (P^t if trans
# else P).  Sym products recurse (their dests must have trans=0: a Gram
# is symmetric, so the flag is meaningless); mm products expand through
# the registered multiplication algebra.

_GRAM_STRASSEN = {
    # C11 = G(Y11) + G(Y12); C22 = G(Y21) + G(Y22)
    "sym": (
        (((0, 0, 1),), ((0, 0, 1, 0),)),
        (((0, 1, 1),), ((0, 0, 1, 0),)),
        (((1, 0, 1),), ((1, 1, 1, 0),)),
        (((1, 1, 1),), ((1, 1, 1, 0),)),
    ),
    # C21 = Y21 Y11^t + Y22 Y12^t
    "mm": (
        (((1, 0, 1),), ((0, 0, 1),), ((1, 0, 1, 0),)),
        (((1, 1, 1),), ((0, 1, 1),), ((1, 0, 1, 0),)),
    ),
}

# A real-coefficient 5-product symmetric scheme with the
# Dumas-Pernet-Sedoglavic recursion shape G(l) = 2 G(l-1) + 3 t^(l-1)
# (arXiv 2001.04109; DPS's own 5-product scheme works over fields with
# an i — this is a real rank-5 realization with the same count, found
# by numeric search and verified exactly):
#   G1 = G(Y11),  G2 = G(Y12)
#   M1 = (Y21 + Y11)(Y21 - Y11)^t
#   M2 = (Y22 + Y12)(Y22 - Y12)^t
#   M3 = (Y11 + Y12 + Y21 - Y22)(Y11 - Y12 + Y21 + Y22)^t
#   C11 =  G1 + G2
#   C21 = -G1 + G2 - M1/2 + M2^t/2 + (M3 + M3^t)/4
#   C22 =  G1 + G2 + (M1 + M1^t)/2 + (M2 + M2^t)/2
_GRAM_DPS = {
    "sym": (
        (((0, 0, 1),),
         ((0, 0, 1, 0), (1, 0, -1, 0), (1, 1, 1, 0))),
        (((0, 1, 1),),
         ((0, 0, 1, 0), (1, 0, 1, 0), (1, 1, 1, 0))),
    ),
    "mm": (
        (((1, 0, 1), (0, 0, 1)), ((1, 0, 1), (0, 0, -1)),
         ((1, 0, -0.5, 0), (1, 1, 0.5, 0), (1, 1, 0.5, 1))),
        (((1, 1, 1), (0, 1, 1)), ((1, 1, 1), (0, 1, -1)),
         ((1, 0, 0.5, 1), (1, 1, 0.5, 0), (1, 1, 0.5, 1))),
        (((0, 0, 1), (0, 1, 1), (1, 0, 1), (1, 1, -1)),
         ((0, 0, 1), (0, 1, -1), (1, 0, 1), (1, 1, 1)),
         ((1, 0, 0.25, 0), (1, 0, 0.25, 1))),
    ),
}


def _check_gram_terms(terms, where: str, name: str):
    if not terms:
        raise ValueError(f"empty term list in {where} of gram algebra "
                         f"{name!r}")
    out = []
    for t in terms:
        if len(t) != 3:
            raise ValueError(f"gram term must be (g, o, coeff): {t!r} in "
                             f"{where} of {name!r}")
        g, o, s = t
        if g not in (0, 1) or o not in (0, 1):
            raise ValueError(f"bad gram term {t!r} in {where} of {name!r} "
                             f"(the split is 2x2)")
        _check_coeff(s, where, name)
        out.append((g, o, s))
    return tuple(out)


def _check_gram_dests(dests, where: str, name: str, *, sym: bool):
    if not dests:
        raise ValueError(f"empty dest list in {where} of gram algebra "
                         f"{name!r}")
    out, seen = [], set()
    for d in dests:
        if len(d) != 4:
            raise ValueError(f"gram dest must be (di, dj, coeff, trans): "
                             f"{d!r} in {where} of {name!r}")
        di, dj, s, tr = d
        if di not in (0, 1) or dj not in (0, 1) or di < dj:
            raise ValueError(f"gram dest {d!r} in {where} of {name!r} must "
                             f"lie in the lower triangle (di >= dj)")
        if tr not in (0, 1):
            raise ValueError(f"bad trans flag in gram dest {d!r} of {name!r}")
        if sym and tr:
            raise ValueError(f"sym dest {d!r} in {where} of {name!r} sets "
                             f"trans — a Gram is symmetric, drop the flag")
        _check_coeff(s, where, name)
        if (di, dj, tr) in seen:
            raise ValueError(f"duplicate dest cell {(di, dj, tr)} in "
                             f"{where} of {name!r}; merge the coefficients")
        seen.add((di, dj, tr))
        out.append((di, dj, s, tr))
    return tuple(out)


def _smoke_check_gram(name: str, sym, mm) -> None:
    """Numeric identity check in the row-gram orientation: the table
    applied to random 2x3 quadrants must reproduce tril(Y Y^t)."""
    rng = np.random.default_rng(1)
    x = {(g, o): rng.standard_normal((2, 3)) for g in (0, 1) for o in (0, 1)}
    y = np.block([[x[0, 0], x[0, 1]], [x[1, 0], x[1, 1]]])
    want = y @ y.T
    out = np.zeros((4, 4))

    def place(p, dests):
        for di, dj, s, tr in dests:
            out[di * 2:(di + 1) * 2, dj * 2:(dj + 1) * 2] += \
                s * (p.T if tr else p)

    for terms, dests in sym:
        combo = sum(s * x[g, o] for g, o, s in terms)
        place(combo @ combo.T, dests)
    for lt, rt, dests in mm:
        u = sum(s * x[g, o] for g, o, s in lt)
        v = sum(s * x[g, o] for g, o, s in rt)
        place(u @ v.T, dests)
    err = max(float(np.abs(out[i * 2:(i + 1) * 2, j * 2:(j + 1) * 2]
                           - want[i * 2:(i + 1) * 2, j * 2:(j + 1) * 2]).max())
              for i, j in ((0, 0), (1, 0), (1, 1)))
    if err > 1e-8:
        raise ValueError(
            f"gram algebra {name!r} fails the one-level Y Y^t identity "
            f"against the dense oracle (max err {err:.3e})")


def register_gram_algebra(name: str, *, sym, mm,
                          overwrite: bool = False) -> None:
    """Register a symmetric-recursion (gram) algebra under ``name``.

    ``sym`` is a tuple of ``(terms, dests)`` rows — products that
    recurse as Grams; ``mm`` is a tuple of ``(left, right, dests)`` rows
    — products expanded through the multiplication algebra.  See the
    registry comment above for entry shapes.  Registration validates the
    format and runs a one-level numeric ``Y Y^t`` identity check, then
    invalidates every downstream compiled-table cache.
    """
    if not overwrite and name in GRAM_ALGEBRAS:
        raise ValueError(f"gram algebra {name!r} already registered")
    sym_n, mm_n = [], []
    for i, row in enumerate(tuple(sym)):
        if len(row) != 2:
            raise ValueError(f"sym row must be (terms, dests): {row!r} in "
                             f"{name!r}")
        terms, dests = row
        sym_n.append((_check_gram_terms(terms, f"sym[{i}]", name),
                      _check_gram_dests(dests, f"sym[{i}]", name, sym=True)))
    for i, row in enumerate(tuple(mm)):
        if len(row) != 3:
            raise ValueError(f"mm row must be (left, right, dests): {row!r} "
                             f"in {name!r}")
        lt, rt, dests = row
        mm_n.append((_check_gram_terms(lt, f"mm[{i}].left", name),
                     _check_gram_terms(rt, f"mm[{i}].right", name),
                     _check_gram_dests(dests, f"mm[{i}]", name, sym=False)))
    if not sym_n:
        raise ValueError(f"gram algebra {name!r} needs at least one sym "
                         f"(recursive) product")
    if not mm_n:
        raise ValueError(f"gram algebra {name!r} needs at least one mm "
                         f"product (nothing feeds the off-diagonal)")
    _smoke_check_gram(name, sym_n, mm_n)
    GRAM_ALGEBRAS[name] = {"sym": tuple(sym_n), "mm": tuple(mm_n)}
    _invalidate()


def get_gram_algebra(name: str) -> dict:
    try:
        return GRAM_ALGEBRAS[name]
    except KeyError:
        raise ValueError(
            f"unknown gram algebra {name!r}; registered: "
            f"{sorted(GRAM_ALGEBRAS)}") from None


def registered_gram_algebras() -> Tuple[str, ...]:
    return tuple(sorted(GRAM_ALGEBRAS))


register_gram_algebra("strassen", **_GRAM_STRASSEN)
register_gram_algebra("dps", **_GRAM_DPS)


def import_algebras(algebras=None, gram_algebras=None, dims=None, *,
                    overwrite: bool = False) -> None:
    """Register tables carried over from the JAX package.

    ``algebras`` maps a name to a table in the form
    ``repro.core.leaf_ir.get_algebra`` returns it, ``dims`` a name to
    its ``algebra_dims`` triple (``<2, 2, 2>`` where absent), and
    ``gram_algebras`` a name to the ``{"sym": ..., "mm": ...}`` entry
    ``get_gram_algebra`` returns.  Each goes through
    :func:`register_algebra` / :func:`register_gram_algebra`, so it is
    validated and identity-checked as a native registration would be,
    and both packages then compile the same programs.
    """
    dims = dims or {}
    for name, table in (algebras or {}).items():
        register_algebra(name, table, dims=dims.get(name, (2, 2, 2)),
                         overwrite=overwrite)
    for name, entry in (gram_algebras or {}).items():
        register_gram_algebra(name, sym=entry["sym"], mm=entry["mm"],
                              overwrite=overwrite)


# ---------------------------------------------------------------------------
# The IR
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OperandSpec:
    """Whole-side properties of one program operand.

    source:    which executor input the side reads (0 = first array,
               1 = second; ``ata``/``aat``/``rank_k`` read the same
               array on both sides).
    layout:    "dense" (a plain (rows, cols) array over the leaf grid)
               or "tri" (the packed lower-triangular tile stack of
               ``core/symmetry.py`` — terms then carry the mirror flag).
    transpose: the side is *used* transposed: the executor swaps the
               roles of the stored axes in its operand offsets.  Never
               set together with
               layout="tri" (tri mirroring is per-term).
    """
    source: int = 0
    layout: str = "dense"
    transpose: bool = False


@dataclass(frozen=True)
class OutputSpec:
    """packing: "tri" = packed lower-triangular tile stack (di >= dj
    always), "dense" = full block grid.  accumulate: seed each output
    tile from an incoming stack (C += ...) instead of zero."""
    packing: str = "dense"
    accumulate: bool = False


@dataclass(frozen=True)
class LeafOp:
    """One leaf product: (signed sum of stored blocks) x (signed sum)."""
    kind: str                 # "syrk" (gram diagonal leaf) | "mm"
    left: Tuple[Term, ...]
    right: Tuple[Term, ...]
    dests: Tuple[Dest, ...]


@dataclass(frozen=True)
class Contribution:
    """One (leaf op, destination) pair — the unit the executor runs.

    Transposed destinations are already normalized away: for gram kinds
    (the only emitters of trans dests) ``(sum L)^t (sum R)`` transposed
    is exactly the straight contribution with the sides swapped, so
    ``left``/``right`` here may be the op's sides exchanged and the
    executor never sees a per-contribution transpose.  ``sign`` is the
    (possibly rational) destination coefficient.
    """
    di: int
    dj: int
    sign: float
    left: Tuple[Term, ...]
    right: Tuple[Term, ...]
    kind: str


@dataclass(frozen=True)
class LeafProgram:
    """A fully flattened schedule over a per-axis leaf-block grid.

    ``dims`` is the registered algebra's per-level ``<m, k, n>`` split,
    so the grid is ``dims[i] ** levels`` blocks per axis —
    ``blocks_m`` x ``blocks_k`` for the stored left operand (before its
    spec transpose), ``blocks_k`` x ``blocks_n`` for the right.  The
    square-split compat surface (``products`` / ``blocks`` /
    ``max_terms`` / ``contributions`` / ``by_dest`` /
    ``max_contributions`` / ``mult_count``) keeps its square-split
    meaning; ``blocks`` raises for rectangular programs.  ``gram`` names the
    gram-algebra entry that shaped the symmetric recursion (gram kinds
    only; "strassen" otherwise).
    """
    kind: str
    levels: int
    variant: str
    ops: Tuple[LeafOp, ...]
    left_spec: OperandSpec
    right_spec: OperandSpec
    out_spec: OutputSpec
    dims: Tuple[int, int, int] = (2, 2, 2)
    gram: str = "strassen"
    _cache: Dict[str, object] = field(default_factory=dict, compare=False,
                                      repr=False)

    # -- compat surface (Plan) ---------------------------------------------
    @property
    def products(self) -> Tuple[LeafOp, ...]:
        return self.ops

    @property
    def blocks_m(self) -> int:
        return self.dims[0] ** self.levels

    @property
    def blocks_k(self) -> int:
        return self.dims[1] ** self.levels

    @property
    def blocks_n(self) -> int:
        return self.dims[2] ** self.levels

    @property
    def blocks(self) -> int:
        """Leaf blocks per matrix dimension (square splits only)."""
        if not (self.dims[0] == self.dims[1] == self.dims[2]):
            raise ValueError(
                f"rectangular program (dims {self.dims}) has no uniform "
                f"block count; use blocks_m/blocks_k/blocks_n")
        return self.blocks_m

    @property
    def out_blocks(self) -> Tuple[int, int]:
        """(rows, cols) of the output leaf grid."""
        if self.out_spec.packing == "tri":
            b = self.blocks          # gram kinds are square-split
            return (b, b)
        return (self.blocks_m, self.blocks_n)

    @property
    def max_terms(self) -> int:
        return max(max(len(p.left), len(p.right)) for p in self.ops)

    def contributions(self) -> Tuple[Contribution, ...]:
        """(op, destination) pairs, sorted by destination block.

        Cached per instance (a module-level lru_cache keyed on ``self``
        would pin every program ever compiled for process lifetime —
        autotune sweeps compile many)."""
        cached = self._cache.get("contributions")
        if cached is None:
            out = []
            for p in self.ops:
                for (di, dj, s, tr) in p.dests:
                    if tr:
                        # P^t = ((sum L) . (sum R))^t with the gram
                        # operand specs is the straight product with the
                        # sides swapped — valid because both sides read
                        # the same source with complementary transposes.
                        assert self.left_spec.source == \
                            self.right_spec.source, \
                            "trans dest outside a gram kind"
                        out.append(Contribution(di, dj, s, p.right, p.left,
                                                p.kind))
                    else:
                        out.append(Contribution(di, dj, s, p.left, p.right,
                                                p.kind))
            out.sort(key=lambda c: (c.di, c.dj))
            cached = tuple(out)
            self._cache["contributions"] = cached
        return cached

    def by_dest(self) -> Dict[Tuple[int, int], Tuple[Contribution, ...]]:
        cached = self._cache.get("by_dest")
        if cached is None:
            grouped: Dict[Tuple[int, int], list] = {}
            for c in self.contributions():
                grouped.setdefault((c.di, c.dj), []).append(c)
            cached = {k: tuple(v) for k, v in grouped.items()}
            self._cache["by_dest"] = cached
        return cached

    @property
    def max_contributions(self) -> int:
        return max(len(v) for v in self.by_dest().values())

    def n_dests(self) -> int:
        """Distinct leaf destinations of the output packing."""
        br, bc = self.out_blocks
        return br * (br + 1) // 2 if self.out_spec.packing == "tri" \
            else br * bc

    def dest_index(self, di: int, dj: int) -> int:
        if self.out_spec.packing == "tri":
            return di * (di + 1) // 2 + dj
        return di * self.out_blocks[1] + dj

    def mult_count(self, mb: int, nb: int, kb: Optional[int] = None) -> int:
        """Scalar multiplications the program performs with the given
        leaf shapes.  Gram kinds (``ata``/``rank_k``: A leaves (mb, nb);
        ``aat``: (mb, nb) with the roles of the grids swapped): SYRK
        leaves compute only the lower triangle — the paper's n(n+1)/2
        saving.  ``matmul``: leaves (mb, kb) x (kb, nb).  ``symm``: X
        leaves (mb, nb) against square (nb, nb) leaves of the packed
        operand.  Matches the ``cost_model`` closed forms evaluated with
        ``leaf=0`` at the padded shape (tests/test_properties.py).
        """
        total = 0
        for p in self.ops:
            if p.kind == "syrk":
                if self.kind == "aat":
                    total += nb * mb * (mb + 1) // 2
                else:
                    total += mb * nb * (nb + 1) // 2
            elif self.kind in ("ata", "rank_k"):
                total += nb * mb * nb          # (nb, mb) @ (mb, nb)
            elif self.kind == "aat":
                total += mb * nb * mb          # (mb, nb) @ (nb, mb)
            elif self.kind == "symm":
                total += mb * nb * nb          # (mb, nb) @ (nb, nb)
            else:
                total += mb * (kb if kb is not None else nb) * nb
        return total


# ---------------------------------------------------------------------------
# The compiler: kind x levels x algebra x gram algebra -> LeafProgram
# ---------------------------------------------------------------------------

def _expand(level: int, left, right, dests, kind, transpose_left,
            transpose_right, table, dims, out: List[LeafOp]):
    """Recursively expand a block product ``level`` more times.

    ``transpose_left`` / ``transpose_right``: that side is conceptually
    ``X^t`` while its terms name stored blocks of ``X`` — quadrant
    (qi, qj) of ``X^t`` is stored block (qj, qi), so quadrant bits
    append swapped on that side.  ``dims`` is the table's per-level
    <m, k, n> split; destination refinement of a *transposed* dest
    places sub-product (ci, cj) transposed at (cj, ci) — square output
    splits only, which gram kinds (the only trans-dest emitters)
    guarantee.
    """
    if level <= 0:
        out.append(LeafOp(kind, tuple(left), tuple(right), tuple(dests)))
        return
    dm, dk, dn = dims
    for a_quads, b_quads, d_quads in table:
        nl = []
        for qi, qj, s in a_quads:
            if transpose_left:
                nl.extend((r * dk + qj, c * dm + qi, s0 * s, 0)
                          for r, c, s0, _t in left)
            else:
                nl.extend((r * dm + qi, c * dk + qj, s0 * s, 0)
                          for r, c, s0, _t in left)
        nr = []
        for qi, qj, s in b_quads:
            if transpose_right:
                nr.extend((r * dn + qj, c * dk + qi, s0 * s, 0)
                          for r, c, s0, _t in right)
            else:
                nr.extend((r * dk + qi, c * dn + qj, s0 * s, 0)
                          for r, c, s0, _t in right)
        nd = []
        for ci, cj, s in d_quads:
            for di, dj, s0, dtr in dests:
                if dtr:
                    assert dm == dn, "trans dest under a rectangular split"
                    nd.append((di * dm + cj, dj * dn + ci, s0 * s, 1))
                else:
                    nd.append((di * dm + ci, dj * dn + cj, s0 * s, 0))
        _expand(level - 1, nl, nr, nd, kind, transpose_left,
                transpose_right, table, dims, out)


def _merge_cells(cells):
    """Sum coefficients of duplicate (di, dj[, tr]) cells, drop zeros."""
    agg: Dict[tuple, float] = {}
    order: List[tuple] = []
    for entry in cells:
        key, c = entry[:-1] if len(entry) == 3 else (entry[0], entry[1],
                                                     entry[3]), entry[2]
        key = tuple(key)
        if key not in agg:
            order.append(key)
            agg[key] = 0
        agg[key] += c
    return [(key, agg[key]) for key in order if agg[key] != 0]


def _compile_gram(levels: int, table, galg, *,
                  rows: bool) -> Tuple[LeafOp, ...]:
    """Flatten the symmetric recursion against a registered gram algebra.

    The gram algebra is stated over the 2x2 (gram axis g, other axis o)
    split of ``C = Y Y^t``; ``rows=True`` (AAT) maps a combo term
    (g, o) onto stored block (g, o) of A, ``rows=False`` (ATA — the
    column gram is the row gram of A^t) onto stored block (o, g).  The
    recursion carries *placements*: (gi, gj, coeff) positions of the
    current node's Gram in the depth-level output grid, always in the
    lower triangle.  An off-diagonal placement (gi != gj) needs the FULL
    Gram content, so lower-triangle gram-algebra dests gain their
    mirrored (transposed for mm products, identical for sym — a Gram is
    symmetric) upper-counterpart placements; a diagonal placement only
    ever refines to positions whose strictly-upper leaf dests are
    provably redundant mirrors and are filtered at the end.

    mm products expand through the multiplication ``table``; the level-0
    value convention is ``(sum L)(sum R)^t`` on the gram axis, which the
    operand specs realize in both orientations with left = L, right = R
    (ATA: left transposed -> (sum L)^t (sum R) over stored blocks).
    """
    ops: List[LeafOp] = []

    def stored(g: int, o: int) -> Tuple[int, int]:
        return (g, o) if rows else (o, g)

    def node(terms, depth: int, placements):
        if depth == levels:
            ts = tuple((*stored(g, o), c, 0) for g, o, c in terms)
            dests = tuple((gi, gj, c, 0)
                          for (gi, gj), c in _merge_cells(
                              [(gi, gj, c) for gi, gj, c in placements]))
            assert dests, "sym placements cancelled to zero"
            ops.append(LeafOp("syrk", ts, ts, dests))
            return
        for s_terms, s_dests in galg["sym"]:
            child_terms = [(g * 2 + qg, o * 2 + qo, c * qc)
                           for g, o, c in terms for qg, qo, qc in s_terms]
            child_pl = []
            for gi, gj, pc in placements:
                full = gi != gj
                for di, dj, dc, _tr in s_dests:
                    child_pl.append((gi * 2 + di, gj * 2 + dj, pc * dc))
                    if full and di != dj:
                        # mirrored placement of a symmetric Gram block
                        child_pl.append((gi * 2 + dj, gj * 2 + di, pc * dc))
            child_pl = [(gi, gj, c)
                        for (gi, gj), c in _merge_cells(child_pl)]
            assert child_pl, "sym placements cancelled to zero"
            node(child_terms, depth + 1, child_pl)
        for l_terms, r_terms, m_dests in galg["mm"]:
            left = [(*stored(g * 2 + qg, o * 2 + qo), c * qc, 0)
                    for g, o, c in terms for qg, qo, qc in l_terms]
            right = [(*stored(g * 2 + qg, o * 2 + qo), c * qc, 0)
                     for g, o, c in terms for qg, qo, qc in r_terms]
            dests = []
            for gi, gj, pc in placements:
                full = gi != gj
                for di, dj, dc, dtr in m_dests:
                    dests.append((gi * 2 + di, gj * 2 + dj, pc * dc, dtr))
                    if full and di != dj:
                        dests.append((gi * 2 + dj, gj * 2 + di, pc * dc,
                                      dtr ^ 1))
            _expand(levels - depth - 1, left, right, dests, "mm",
                    not rows, rows, table, (2, 2, 2), ops)

    node([(0, 0, 1)], 0, [(0, 0, 1)])

    # tri-packed output: strictly-upper leaf dests are redundant mirrors
    # of stored cells — drop them, merge duplicates per (cell, trans).
    pruned: List[LeafOp] = []
    for p in ops:
        kept = _merge_cells([d for d in p.dests if d[0] >= d[1]])
        assert kept, "leaf op lost every stored destination"
        pruned.append(LeafOp(p.kind, p.left, p.right,
                             tuple((di, dj, c, tr)
                                   for (di, dj, tr), c in kept)))
    return tuple(pruned)


@functools.lru_cache(maxsize=None)
def compile_program(kind: str, levels: int, variant: str = "strassen", *,
                    gram: str = "strassen",
                    trans_a: bool = False,
                    trans_b: bool = False) -> LeafProgram:
    """Compile ``kind`` at ``levels`` against the registered tables.

    ``variant`` names the multiplication algebra (may be rectangular
    for ``matmul``; ``symm`` needs a square right split, gram kinds a
    fully square <2, 2, 2> split).  ``gram`` names the gram algebra
    shaping the symmetric recursion — gram kinds only.  ``trans_a`` /
    ``trans_b`` apply to ``matmul`` only: the op list is identical
    (terms name stored blocks either way); only the operand specs
    change, and the executor folds the swap into its index maps.
    """
    if levels < 0:
        raise ValueError(f"levels must be >= 0, got {levels}")
    if kind not in PROGRAM_KINDS:
        raise ValueError(f"unknown program kind {kind!r} "
                         f"(want one of {PROGRAM_KINDS})")
    if (trans_a or trans_b) and kind != "matmul":
        raise ValueError(f"trans_a/trans_b only apply to matmul, not {kind!r}")
    if gram != "strassen" and kind not in ("ata", "aat", "rank_k"):
        raise ValueError(f"gram algebra selection only applies to gram "
                         f"kinds, not {kind!r}")
    table = get_algebra(variant)
    dims = algebra_dims(variant)

    if kind in ("ata", "aat", "rank_k"):
        if dims != (2, 2, 2):
            raise ValueError(
                f"gram kinds recurse over a square 2x2 split; algebra "
                f"{variant!r} is <{dims[0]},{dims[1]},{dims[2]}>")
        galg = get_gram_algebra(gram)
        ops = _compile_gram(levels, table, galg, rows=kind == "aat")
        if kind == "aat":
            return LeafProgram(
                kind, levels, variant, ops,
                left_spec=OperandSpec(source=0),
                right_spec=OperandSpec(source=0, transpose=True),
                out_spec=OutputSpec(packing="tri"),
                dims=dims, gram=gram)
        return LeafProgram(
            kind, levels, variant, ops,
            left_spec=OperandSpec(source=0, transpose=True),
            right_spec=OperandSpec(source=0),
            out_spec=OutputSpec(packing="tri", accumulate=kind == "rank_k"),
            dims=dims, gram=gram)

    if kind == "matmul":
        ops: List[LeafOp] = []
        _expand(levels, [(0, 0, 1, 0)], [(0, 0, 1, 0)], [(0, 0, 1, 0)], "mm",
                trans_a, trans_b, table, dims, ops)
        return LeafProgram(
            kind, levels, variant, tuple(ops),
            left_spec=OperandSpec(source=0, transpose=trans_a),
            right_spec=OperandSpec(source=1, transpose=trans_b),
            out_spec=OutputSpec(packing="dense"), dims=dims)

    # symm: a matmul flattening with the right terms normalized onto the
    # stored lower triangle — mirrored terms read transposed (trans = 1).
    # The packed operand is square, so the right split must have k == n.
    if dims[1] != dims[2]:
        raise ValueError(
            f"symm needs a square right split (k == n); algebra "
            f"{variant!r} is <{dims[0]},{dims[1]},{dims[2]}>")
    base = compile_program("matmul", levels, variant)
    ops = tuple(
        LeafOp("mm", p.left,
               tuple((r, c, s, 0) if r >= c else (c, r, s, 1)
                     for (r, c, s, _t) in p.right),
               p.dests)
        for p in base.ops)
    return LeafProgram(
        "symm", levels, variant, ops,
        left_spec=OperandSpec(source=0),
        right_spec=OperandSpec(source=1, layout="tri"),
        out_spec=OutputSpec(packing="dense"), dims=dims)


# ---------------------------------------------------------------------------
# Dense numpy interpreter — the parity oracle, independent of the kernel.
# ---------------------------------------------------------------------------

def _leaf(a: np.ndarray, r: int, c: int, grid) -> np.ndarray:
    mb, nb = a.shape[0] // grid[0], a.shape[1] // grid[1]
    return a[r * mb:(r + 1) * mb, c * nb:(c + 1) * nb]


def _gather_side(arr: np.ndarray, terms, grid, spec: OperandSpec,
                 diag_sym: bool = False) -> np.ndarray:
    """Signed sum of one side's stored leaves, mirrors/transposes applied."""
    out = None
    for r, c, s, trans in terms:
        if spec.layout == "tri":
            assert r >= c, "tri-layout term referenced the upper triangle"
            leaf = _leaf(arr, r, c, grid)
            if r == c:
                low = np.tril(leaf)
                # diag_sym: Sym = S + S^t, so the diagonal leaf doubles
                # symmetrically; otherwise rebuild the symmetric completion
                leaf = low + (low.T if diag_sym else np.tril(low, -1).T)
            if trans:
                leaf = leaf.T
        else:
            leaf = _leaf(arr, r, c, grid)
            if trans:
                leaf = leaf.T
        blk = s * leaf
        out = blk if out is None else out + blk
    if spec.layout != "tri" and spec.transpose:
        out = out.T
    return out


def interpret_program(prog: LeafProgram, a: np.ndarray,
                      b: Optional[np.ndarray] = None, *,
                      c0: Optional[np.ndarray] = None,
                      diag_sym: bool = False) -> np.ndarray:
    """Execute a program densely in float64 numpy.

    ``a`` (and ``b`` for two-input kinds) must be pre-padded so every
    stored axis divides by its per-axis leaf-grid count (``blocks_m`` x
    ``blocks_k`` for the stored left operand, swapped under the spec
    transpose).  For ``symm``, ``b`` is the dense (n, n) array whose
    strict upper triangle is provably never read (the packed-storage
    contract); ``diag_sym`` computes ``x @ (S + S^t)`` instead.  For
    ``rank_k``, ``c0`` is the (n, n) initial C (lower triangle; defaults
    to zero).

    Returns: tril(C) for tri-packed outputs, dense C otherwise.
    """
    af = np.asarray(a, np.float64)
    operands = {0: af}
    if prog.left_spec.source == 1 or prog.right_spec.source == 1:
        assert b is not None, f"{prog.kind} needs a second operand"
        operands[1] = np.asarray(b, np.float64)
        if prog.right_spec.layout == "tri":
            operands[1] = np.tril(operands[1])     # upper provably unread

    bm, bk, bn = prog.blocks_m, prog.blocks_k, prog.blocks_n
    lgrid = (bk, bm) if prog.left_spec.transpose else (bm, bk)
    rgrid = (bn, bk) if prog.right_spec.transpose else (bk, bn)
    for side, grid in (("left", lgrid), ("right", rgrid)):
        spec = getattr(prog, f"{side}_spec")
        shape = operands[spec.source].shape
        assert shape[0] % grid[0] == 0 and shape[1] % grid[1] == 0, \
            (side, shape, grid)

    # output geometry per kind
    m, n = af.shape
    if prog.kind in ("ata", "rank_k"):
        out_n = (n, n)
    elif prog.kind == "aat":
        out_n = (m, m)
    elif prog.kind == "symm":
        out_n = (m, operands[1].shape[1])
    else:
        la, lb = operands[0].shape, operands[1].shape
        out_n = ((la[1] if prog.left_spec.transpose else la[0]),
                 (lb[0] if prog.right_spec.transpose else lb[1]))
    out = np.zeros(out_n, np.float64)
    if c0 is not None:
        assert prog.out_spec.accumulate, \
            f"{prog.kind} output does not accumulate"
        out += np.tril(np.asarray(c0, np.float64))
    ogrid = prog.out_blocks
    mb, nb = out_n[0] // ogrid[0], out_n[1] // ogrid[1]

    for p in prog.ops:
        left = _gather_side(operands[prog.left_spec.source], p.left, lgrid,
                            prog.left_spec)
        right = _gather_side(operands[prog.right_spec.source], p.right, rgrid,
                             prog.right_spec, diag_sym=diag_sym)
        prod = left @ right
        for di, dj, s, tr in p.dests:
            blk = prod.T if tr else prod
            out[di * mb:(di + 1) * mb, dj * nb:(dj + 1) * nb] += s * blk
    if prog.out_spec.packing == "tri":
        out = np.tril(out)
    return out
