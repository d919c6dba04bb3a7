"""The op walk of the symm and matmul kinds, on the CPU, and the op
tables of the gram kinds.

``csrc/leaf_products.cu`` computes each leaf product of a program once and
adds it into each of its destinations.  It walks the op-indexed tables of
``strassen_fused._op_tables``; its plain version ``_leaf_products_plain``
walks the same tables the same way.  Here the tables are held against the
destination-indexed ones, slot for slot (and so against the JAX
package's), for symm, matmul and the gram kinds; the dps gram's
transposed destinations lowered as flagged slots; the plain walk against
the JAX package's float64 ``interpret_program`` and the float64 product
at ragged shapes down to levels 3, its ``torch.bmm`` calls are counted
(one per op and K block), and ``product_flops`` against ``mult_count``.  Tolerances are the
JAX suite's: 1e-5 of max|out| in fp32 (tests/test_leaf_ir.py), the
product and the oracles differing only in summation order.  The CUDA
kernel is held against this plain version on the card by
``chip_smoke.py``.
"""
import warnings

import numpy as np
import pytest
import torch

from repro.core import leaf_ir as jax_ir
from repro.kernels import strassen_fused as jax_sf
from repro_torch.core.symmetry import pack_tril_blocks
from repro_torch.kernels import strassen_fused as sf

VARIANTS = ("strassen", "winograd", "classical", "bb322")
LEVELS = (0, 1, 2, 3)
TRANS = ((False, False), (False, True), (True, False), (True, True))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These shapes are small: one intra-op thread keeps the test from
    crowding the suite's other workers on a shared CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


def _slot_tables(kind, levels, variant, trans_a=False, trans_b=False,
                 gram="strassen"):
    """The destination-indexed tables re-derived from the op tables: each
    destination's slots are the ops that feed it, in op order, a
    transposed slot with its sides swapped; and the first/last flags
    checked against the element order (an op's straight slots first on
    and below a leaf block's diagonal, its transposed ones first above)."""
    prog = sf.compile_program(kind, levels, variant, gram=gram,
                              trans_a=trans_a, trans_b=trans_b)
    (lrow, lcol, lsgn, rrow, rcol, rsgn, rtrn, dest, dsgn, dflag, dtrn,
     _odiag) = sf._op_tables(kind, levels, variant, gram, trans_a, trans_b)
    n_dest, n_c, tmax = prog.n_dests(), prog.max_contributions, \
        prog.max_terms
    sign = np.zeros((n_dest, n_c), np.float32)
    idx = np.zeros((n_dest, n_c, tmax), np.int32)
    out = [sign, idx, idx.copy(), idx.astype(np.float32), idx.copy(),
           idx.copy(), idx.astype(np.float32), idx.copy()]
    slots = np.zeros(n_dest, int)
    for o in range(len(lrow)):
        for d in np.flatnonzero(dsgn[o]):
            ld, s = dest[o, d], slots[dest[o, d]]
            sign[ld, s] = dsgn[o, d]
            sides = (rrow, rcol, rsgn, lrow, lcol, lsgn) if dtrn[o, d] \
                else (lrow, lcol, lsgn, rrow, rcol, rsgn)
            for t, src in zip(out[1:7], sides):
                t[ld, s] = src[o]
            # the swapped right side is the op's left, which has no mirrors
            out[7][ld, s] = 0 if dtrn[o, d] else rtrn[o]
            slots[ld] += 1
    for shift, first_trn in ((0, 0), (sf._UPPER, 1)):
        order = [(o, d) for o in range(len(lrow))
                 for trn in (first_trn, 1 - first_trn)
                 for d in np.flatnonzero(dsgn[o]) if dtrn[o, d] == trn]
        for flag, walk in ((sf._FIRST, order), (sf._LAST, order[::-1])):
            seen = set()
            for o, d in walk:
                assert bool((dflag[o, d] >> shift) & flag) == \
                    (dest[o, d] not in seen)
                seen.add(dest[o, d])
    return tuple(out)


def _assert_tables_equal(got, want):
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("kind,trans_a,trans_b",
                         [("symm", False, False)]
                         + [("matmul", ta, tb) for ta, tb in TRANS])
@pytest.mark.parametrize("variant", VARIANTS)
def test_op_tables_rederive_program_tables(variant, kind, trans_a, trans_b,
                                           levels):
    got = _slot_tables(kind, levels, variant, trans_a, trans_b)
    _assert_tables_equal(got, sf._program_tables(
        kind, levels, variant, "strassen", trans_a, trans_b))
    _assert_tables_equal(got, jax_sf._program_tables(
        kind, levels, variant, "strassen", trans_a, trans_b))


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("kind", ["ata", "aat", "rank_k"])
@pytest.mark.parametrize("variant", ["strassen", "winograd", "classical"])
def test_gram_op_tables_rederive_program_tables(variant, kind, levels):
    """The strassen gram's programs lower to op tables, slot for slot the
    destination tables; every syrk op feeds only diagonal leaf blocks
    (``odiag``) and every mm op only off-diagonal ones, so a position
    above a leaf block's diagonal skips exactly the syrk ops."""
    got = _slot_tables(kind, levels, variant)
    _assert_tables_equal(got, sf._program_tables(kind, levels, variant))
    _assert_tables_equal(got, jax_sf._program_tables(kind, levels, variant))
    prog = sf.compile_program(kind, levels, variant)
    odiag = sf._op_tables(kind, levels, variant)[-1]
    assert odiag.dtype == np.int32 and odiag.shape == (len(prog.ops),)
    for op, diag in zip(prog.ops, odiag):
        on_diag = [di == dj for di, dj, _, _ in op.dests]
        assert bool(diag) == all(on_diag) == (op.kind == "syrk")
        assert any(on_diag) == (op.kind == "syrk")


def test_op_tables_refuse_gram_kinds():
    """The dps gram's op tables lower, with transposed slots (``dtrn``)
    and no op that skips the positions above a leaf block's diagonal; the
    strassen gram's have none, and their flags are the same in both
    halves of a leaf block."""
    for kind in ("ata", "aat", "rank_k"):
        tables = sf._op_tables(kind, 1, "strassen")
        dflag, dtrn = tables[9], tables[10]
        assert not dtrn.any()
        np.testing.assert_array_equal(dflag & 3, dflag >> sf._UPPER)
        dps = sf._op_tables(kind, 1, "strassen", "dps")
        dsgn, dtrn, odiag = dps[8], dps[10], dps[11]
        assert dtrn.dtype == np.int32 and dtrn.shape == dsgn.shape
        assert dtrn.any() and not dtrn[dsgn == 0].any()
        assert not odiag.any()


def test_op_tables_follow_algebra_changes():
    sf._op_tables("matmul", 1, "strassen")
    sf._device_op_tables("matmul", 1, "strassen", "strassen", "cpu")
    assert sf._op_tables.cache_info().currsize > 0
    assert sf._device_op_tables.cache_info().currsize > 0
    sf.leaf_ir.register_algebra("strassen",
                                sf.leaf_ir.get_algebra("strassen"),
                                overwrite=True)
    assert sf._op_tables.cache_info().currsize == 0
    assert sf._device_op_tables.cache_info().currsize == 0


def _symm_case(m, n, bs, bm, levels, diag_sym, seed, variant="strassen"):
    """(spec, padded x, stack, float64 X @ Sym) of a symm program: S is
    n x n, zero-padded to whole bs x bs tiles; diag_sym reads it as the
    lower triangle, otherwise as its symmetric completion."""
    x, s = _rand((m, n), seed), _rand((n, n), seed + 1)
    low = np.tril(s)
    op = low if diag_sym else low + np.tril(s, -1).T
    n_pad = -(-n // bs) * bs
    stack = pack_tril_blocks(torch.from_numpy(
        np.pad(op, ((0, n_pad - n), (0, n_pad - n)))), bs)
    spec, xp, sp = sf._prepare_symm(torch.from_numpy(x), stack, levels,
                                    variant, bm, diag_sym)
    dense = op + op.T if diag_sym else op
    return spec, xp, sp, x.astype(np.float64) @ dense


def _matmul_case(m, k, n, block, levels, trans_a, trans_b, seed,
                 variant="strassen"):
    a, b = _rand((m, k), seed), _rand((k, n), seed + 1)
    spec, ap, bp = sf._prepare_matmul(
        torch.from_numpy(np.ascontiguousarray(a.T if trans_a else a)),
        torch.from_numpy(np.ascontiguousarray(b.T if trans_b else b)),
        levels, variant, block, block, block, trans_a, trans_b)
    return spec, ap, bp, a.astype(np.float64) @ b


@pytest.mark.parametrize("kind,levels", [("symm", 1), ("symm", 2),
                                         ("matmul", 2), ("matmul", 3)])
def test_plain_computes_each_product_once(monkeypatch, kind, levels):
    """One ``torch.bmm`` per op and K block, over every position at once:
    at levels 2, 49 products where the destination walk ran 144."""
    if kind == "symm":
        spec, left, right, _ = _symm_case(64, 64, 8, 8, levels, True, 5)
    else:
        spec, left, right, _ = _matmul_case(128, 128, 128, 8, levels,
                                            False, False, 5)
    calls, rows = [], []
    bmm = torch.bmm

    def counted(x, y):
        calls.append(1)
        rows.append(x.shape[0])
        return bmm(x, y)

    monkeypatch.setattr(torch, "bmm", counted)
    sf.leaf_program(spec, left, right, torch.float32)
    n_ops = 7 ** levels
    positions = spec.q_i * spec.q_j
    assert spec.n_k > 1 and positions > 1
    assert len(calls) == n_ops * spec.n_k
    assert sum(rows) == n_ops * spec.n_k * positions
    # the destination walk computes a product once per destination it feeds
    contributions = {1: 12, 2: 144, 3: 1728}[levels]
    assert sf.live_steps(spec) == contributions * spec.n_k * positions


@pytest.mark.parametrize("kind", ["symm", "matmul"])
def test_product_flops_main_path(kind):
    """2 * mult_count at the padded leaf shapes; 1.6442e12 at the main
    path (10000^2 padded to 10240^2, levels 2, tiles of 256), against the
    destination walk's 4.832e12."""
    if kind == "symm":
        geo = sf._symm_geometry(10240, 40, 2, "strassen", 256)
        spec = sf._bind(geo["plan"], n_out=40 * 40, n_tj=40, q_i=geo["nbm"],
                        q_j=geo["q"], n_k=geo["q"], bi=256, bj=256, bc=256,
                        diag_sym=True)
    else:
        geo = sf._matmul_geometry(10000, 10000, 10000, 2, "strassen", 256,
                                  256, 256, trans_a=True)
        spec = sf._bind(geo["plan"], n_out=40 * 40, n_tj=40, q_i=geo["nbm"],
                        q_j=geo["nbn"], n_k=geo["n_k"], bi=256, bj=256,
                        bc=256)
    flops = sf.product_flops(spec)
    assert flops == 2 * geo["plan"].mult_count(2560, 2560, 2560) \
        == 2 * 49 * 2560 ** 3 == 1_644_167_168_000
    assert round(flops / 1e8) == 16442
    live = sf.live_steps(spec) * 2 * 256 ** 3
    assert round(live / 1e9) == 4832


@pytest.mark.parametrize("case", [("symm", 2, 24, 48, 8, 8),
                                  ("symm", 1, 33, 32, 16, 8),
                                  ("matmul", 2, 40, 24, 16, 8),
                                  ("matmul", 0, 9, 17, 33, 8)])
def test_product_flops_is_mult_count(case):
    kind, levels, m, k, n, block = case
    if kind == "symm":
        spec = _symm_case(m, k, n, block, levels, False, 1)[0]
        prog = sf.compile_program("symm", spec.levels, "strassen")
        want = prog.mult_count(spec.q_i * spec.bi, spec.q_j * spec.bj)
    else:
        spec = _matmul_case(m, k, n, block, levels, False, False, 1)[0]
        prog = sf.compile_program("matmul", spec.levels, "strassen")
        want = prog.mult_count(spec.q_i * spec.bi, spec.q_j * spec.bj,
                               spec.n_k * spec.bc)
    assert sf.product_flops(spec) == 2 * want


def test_product_flops_refuses_gram_kinds():
    """A dps gram program, whose transposed destinations take the product
    at the mirror position, counts every op at all q^2 positions; the
    strassen gram's skips the diagonal-only ops above the diagonal."""
    geo = sf._ata_geometry(64, 64, 1, "strassen", 8, 8, gram="dps")
    spec = sf._bind(geo["plan"], n_out=geo["n_tri"], n_tj=0, q_i=geo["nbt"],
                    q_j=geo["nbt"], n_k=geo["n_k"], bi=8, bj=8, bc=8)
    assert spec.gram == "dps" and sf._pairs(spec)
    q, n_ops = spec.q_i, len(geo["plan"].ops)
    assert sf.product_flops(spec) == n_ops * q * q * 2 * 8 ** 3 * spec.n_k
    plain = sf._bind(sf.compile_program("ata", 1, "strassen"),
                     n_out=geo["n_tri"], n_tj=0, q_i=geo["nbt"],
                     q_j=geo["nbt"], n_k=geo["n_k"], bi=8, bj=8, bc=8)
    assert not sf._pairs(plain) and 0 < sf.product_flops(plain) \
        < 6 * q * q * 2 * 8 ** 3 * spec.n_k


@pytest.mark.parametrize("kind", ["symm", "matmul"])
def test_bf16_output_is_fp32_rounded_once(kind):
    if kind == "symm":
        spec, left, right, _ = _symm_case(40, 32, 8, 8, 2, True, 9)
    else:
        spec, left, right, _ = _matmul_case(40, 32, 24, 8, 2, True, False, 9)
    full = sf.leaf_program(spec, left, right, torch.float32)
    half = sf.leaf_program(spec, left, right, torch.bfloat16)
    assert half.dtype == torch.bfloat16
    assert torch.equal(half, full.to(torch.bfloat16))


@pytest.mark.parametrize("diag_sym", [False, True])
@pytest.mark.parametrize("variant", ["strassen", "classical", "bb322"])
def test_symm_ragged_levels_3(variant, diag_sym):
    """X 70 x 61 against a T = 8 stack of 8 x 8 tiles, at levels 3: held
    against the JAX package's float64 interpret_program and X @ Sym."""
    spec, xp, sp, want = _symm_case(70, 61, 8, 8, 3, diag_sym, 3, variant)
    assert spec.levels == 3
    got = sf.leaf_program(spec, xp, sp, torch.float32)
    prog = jax_ir.compile_program("symm", 3, variant)
    low = np.zeros((64, 64))            # the oracle reads the lower part
    low[:61, :61] = np.tril(_rand((61, 61), 4))
    oracle = jax_ir.interpret_program(prog, xp.double().numpy(), low,
                                      diag_sym=diag_sym)
    assert _rel(got.numpy(), oracle) <= 1e-5
    assert _rel(got.numpy()[:70, :61], want) <= 1e-5


@pytest.mark.parametrize("trans_a,trans_b", TRANS)
@pytest.mark.parametrize("variant", ["strassen", "winograd", "bb322"])
def test_matmul_ragged_levels_3(variant, trans_a, trans_b):
    """200 x 61 @ 61 x 45 at blocks of 8, levels 3 (winograd clamps to
    levels 1 by the fan-in): held against the JAX package's float64
    interpret_program on the same padded operands and the float64 product.
    """
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # winograd's fan-in clamp
        spec, ap, bp, want = _matmul_case(200, 61, 45, 8, 3, trans_a,
                                          trans_b, 7, variant)
    assert spec.levels == (1 if variant == "winograd" else 3)
    got = sf.leaf_program(spec, ap, bp, torch.float32)
    prog = jax_ir.compile_program("matmul", spec.levels, variant,
                                  trans_a=trans_a, trans_b=trans_b)
    oracle = jax_ir.interpret_program(prog, ap.double().numpy(),
                                      bp.double().numpy())
    assert _rel(got.numpy(), oracle) <= 1e-5
    assert _rel(got.numpy()[:200, :45], want) <= 1e-5
