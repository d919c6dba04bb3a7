"""Output guards for served Grams: NaN/Inf scan + Freivalds-style probe.

The Gram's defining identity is a nearly-free correctness oracle: for any
vector x,

    x^t (A^t A) x  =  (Ax)^t (Ax)  =  ||Ax||^2            (cols gram)
    x^t (A A^t) x  =  ||A^t x||^2                          (rows gram)

so a candidate C can be checked against A at O(mn + n^2) cost per probe —
without ever recomputing the n^log2(7)-cost fast product it came from.
This is Freivalds' algorithm specialized to the symmetric case: with x
drawn uniformly from {-1, +1}^n (Rademacher), a C that differs from
A^t A in even one entry satisfies the identity with probability at most
1/2 per probe, so ``probes=k`` bounds the false-negative probability by
2^-k while NaN/Inf and negative-diagonal corruption are caught
deterministically (DESIGN.md §13 derives the bound).

Three layers, all host-side numpy in float64 (the probe must not itself
run through the machinery it is checking):

* :func:`finite_ok` — NaN/Inf scan (catches poisoned tiles, bf16
  overflow, uninitialized output).
* :func:`freivalds_gram` — the randomized identity probe (catches
  *finite* silent corruption: a wrong tile, a dropped leaf product, a
  stale executable).
* :func:`verify_gram` — the combined verdict the serving layer consults
  (``gram.engine.GramEngine``): finite scan, diagonal nonnegativity
  (diag(A^t A)_j = ||A[:, j]||^2 >= 0 — exact for the packed/tril path),
  then ``probes`` Freivalds rounds.

Tolerances: the probe compares two float64 reductions of data that was
*accumulated* in the kernel's fp32 (or looser) arithmetic, so the
threshold is relative to the probe's own magnitude ``||Ax||^2`` with a
dtype-driven default (``default_rtol``).

The port of ``repro/gram/verify.py``: every function takes torch tensors
(on any device; copied to float64 numpy on the host, the probe's own
arithmetic) as well as numpy arrays, and ``default_rtol`` takes torch
dtypes as well as numpy ones and names.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..obs import trace as _trace

__all__ = [
    "GramVerdict", "VerificationError", "default_rtol", "finite_ok",
    "freivalds_gram", "verify_gram", "check_packed_state",
]


def _host(x) -> np.ndarray:
    """``x`` as a numpy array on the host: a tensor in float64 (numpy has
    no bf16 or fp8), an array as it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x)


def _dtype_of(x):
    """The element type of a tensor or an array, for ``default_rtol``."""
    return x.dtype if isinstance(x, torch.Tensor) else np.asarray(x).dtype


class VerificationError(RuntimeError):
    """A served/finalized Gram failed its output guard."""


class GramVerdict(NamedTuple):
    ok: bool                 # all guards passed
    finite: bool             # no NaN/Inf anywhere in C
    diag_ok: bool            # diag(C) >= -tol (Gram diagonals are norms)
    freivalds_ok: bool       # every probe satisfied the identity
    probes: int              # probes run
    max_rel_err: float       # worst |x^tCx - ||Ax||^2| / max(||Ax||^2, eps)

    def reason(self) -> str:
        if self.ok:
            return "ok"
        if not self.finite:
            return "non-finite entries"
        if not self.diag_ok:
            return "negative diagonal"
        return (f"freivalds identity violated "
                f"(rel err {self.max_rel_err:.3e} over {self.probes} probes)")


def default_rtol(dtype) -> float:
    """Probe tolerance by *operand* dtype: fp32 accumulation error across
    a Strassen recursion sits well under 1e-4 relative (the repo's parity
    suites pin 1e-5 at 512^2); half dtypes carry ~5e-2.  fp8 operand
    tiles (DESIGN.md §16) quantize once before fp32 accumulation, so the
    Freivalds residual is bounded by the quantization step: eps(e4m3) =
    2^-3, eps(e5m2) = 2^-2, each given 2x headroom for the Strassen
    signed-sum amplification.  ``dtype``: a torch or numpy dtype, or its
    name."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    elif isinstance(dtype, str):
        name = dtype
    else:
        name = np.dtype(dtype).name
    if name == "float8_e5m2":
        return 5e-1
    if name.startswith("float8"):
        return 2.5e-1
    if name in ("float16", "bfloat16"):
        return 5e-2
    if name == "float64":
        return 1e-10
    return 1e-4


def finite_ok(c) -> bool:
    return bool(np.isfinite(_host(c)).all())


def _as_full(c: np.ndarray, full: bool) -> np.ndarray:
    """Symmetric C from a served result (mirror a tril-only result)."""
    c = np.asarray(c, np.float64)
    if full:
        return c
    return np.tril(c) + np.tril(c, -1).T


def freivalds_gram(a, c, *, probes: int = 2,
                   rtol: Optional[float] = None, gram_of: str = "cols",
                   full: bool = True,
                   rng: Optional[np.random.Generator] = None
                   ) -> tuple[bool, float]:
    """(passed, max relative error) of ``probes`` Rademacher probes of the
    identity x^t C x == ||Ax||^2 (cols) / ||A^t x||^2 (rows).

    ``full=False`` treats ``c`` as lower-triangular (the packed serving
    path) and mirrors it first.  O(probes * (mn + n^2)) on the host.
    """
    if probes <= 0:
        return True, 0.0
    a64 = _host(a).astype(np.float64)
    if gram_of == "rows":
        a64 = a64.T                   # C = A A^t == (A^t)^t (A^t)
    c64 = _as_full(_host(c), full)
    n = c64.shape[0]
    if a64.shape[1] != n:
        raise ValueError(f"A {tuple(a.shape)} does not produce a "
                         f"{c64.shape} {gram_of} gram")
    if rtol is None:
        rtol = default_rtol(_dtype_of(a))
    if rng is None:
        rng = np.random.default_rng(0)
    worst = 0.0
    for _ in range(probes):
        x = rng.integers(0, 2, size=n).astype(np.float64) * 2.0 - 1.0
        lhs = float(x @ (c64 @ x))
        ax = a64 @ x
        rhs = float(ax @ ax)
        # scale by the probe magnitude; the Frobenius floor keeps a tiny
        # ||Ax||^2 (possible for rank-deficient A) from exploding the
        # relative error on a correct C
        scale = max(rhs, float(np.sum(a64 * a64)) / max(n, 1), 1e-30)
        worst = max(worst, abs(lhs - rhs) / scale)
    return worst <= rtol, worst


def verify_gram(a, c, *, probes: int = 2,
                rtol: Optional[float] = None, gram_of: str = "cols",
                full: bool = True,
                rng: Optional[np.random.Generator] = None) -> GramVerdict:
    """Full guard stack for one served Gram (see module docstring).

    Deterministic guards run first (finite scan, diagonal nonnegativity);
    the randomized identity probes only run on arrays that passed them —
    a NaN would otherwise poison the probe arithmetic itself.
    """
    c_arr = _host(c)
    finite = finite_ok(c_arr)
    diag_ok = True
    fre_ok, worst = True, math.inf
    if finite:
        if rtol is None:
            rtol = default_rtol(_dtype_of(a))
        d = np.diagonal(c_arr).astype(np.float64)
        scale = float(np.abs(d).max()) if d.size else 0.0
        diag_ok = bool((d >= -rtol * max(scale, 1.0)).all())
        fre_ok, worst = freivalds_gram(a, c_arr, probes=probes, rtol=rtol,
                                       gram_of=gram_of, full=full, rng=rng)
    ok = finite and diag_ok and fre_ok
    if not ok:
        _trace.instant(
            "verify_veto",
            reason=("non_finite" if not finite
                    else "negative_diagonal" if not diag_ok
                    else "freivalds"))
    return GramVerdict(ok=ok, finite=finite, diag_ok=diag_ok,
                       freivalds_ok=fre_ok,
                       probes=probes if finite else 0, max_rel_err=worst)


def check_packed_state(packed, n: int, *,
                       rtol: float = 1e-4) -> None:
    """Finalize-time guard for streamed packed-tril state: NaN/Inf scan +
    diagonal nonnegativity (no A to probe against — the stream consumed
    it).  Raises :class:`VerificationError` on violation."""
    p = _host(packed)
    if not np.isfinite(p).all():
        _trace.instant("verify_veto", reason="non_finite", where="stream")
        raise VerificationError(
            "streamed Gram state contains non-finite entries")
    # diagonal of the packed lower triangle: row r starts at r(r+1)/2,
    # its diagonal entry sits at offset r within the row
    idx = np.arange(n) * (np.arange(n) + 3) // 2
    d = p.astype(np.float64)[idx]
    scale = float(np.abs(d).max()) if d.size else 0.0
    if not (d >= -rtol * max(scale, 1.0)).all():
        _trace.instant("verify_veto", reason="negative_diagonal",
                       where="stream")
        raise VerificationError(
            "streamed Gram state has a negative diagonal entry")
