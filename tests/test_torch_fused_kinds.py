"""The port's aat, rank_k and matmul kinds, run as their plain version on
the CPU.

``ata(a, gram_of="rows")`` / ``fused_aat[_packed]``,
``fused_rank_k_update`` / ``ops.rank_k_update`` and ``fused_matmul`` /
``strassen_matmul(mode="fused")`` are held against the JAX package on the
same numpy inputs: its fused executor in interpret mode (a few cases:
interpret mode is slow), its lowered tables bit for bit, its geometry,
traffic models and shape errors, ``jax.grad`` for the gradients, and the
float64 oracles over algebra x gram x levels.  The CUDA kernel is held
against this plain version on the card by ``chip_smoke.py``.

Tolerances, each the JAX suite's own for the same check:

* plain vs the JAX executor, vs float64: 1e-5 of max|out| in fp32
  (tests/test_leaf_ir.py, tests/test_fused_ata.py) — the two differ
  only in summation order;
* the deeper algebras against float64 ``interpret_program``: rtol and
  atol 1e-4 (tests/test_fused_ata.py), each level adds a rounding;
* a streamed stack against the one-shot stack: rtol 1e-5, atol 1e-4
  (tests/test_leaf_ir.py:309-329);
* gradients: 1e-4 (fp32) and 5e-2 (bf16) of max|grad|
  (tests/test_fused_grads.py:245-260); bf16 operands: 3e-2 against the
  float64 product of the unrounded inputs (bf16 keeps 8 mantissa bits).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.core import ata as jax_ata, strassen_matmul as jax_strassen_matmul
from repro.core import leaf_ir as jax_ir
from repro.kernels import strassen_fused as jax_sf
from repro_torch.core import ata, leaf_ir, strassen_matmul
from repro_torch.core.symmetry import pack_tril_blocks, unpack_tril_blocks
from repro_torch.kernels import ops, strassen_fused as sf

VARIANTS = ("strassen", "winograd", "classical")
MATMUL_VARIANTS = VARIANTS + ("bb322", "bb422")
GRAMS = ("strassen", "dps")
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


@pytest.fixture
def pallas_compiler_params(monkeypatch):
    """The installed jax renamed ``pltpu.TPUCompilerParams`` to
    ``CompilerParams``; the JAX executor still uses the old name.  Alias
    it for the duration of one test only."""
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)


def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


def _np(t):
    return t.detach().double().numpy()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _op(x, trans):
    return x.T if trans else x


# ---------------------------------------------------------------------------
# Tables and geometry: bit for bit the JAX package's.
# ---------------------------------------------------------------------------

def _assert_tables_equal(got, want):
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("gram", GRAMS)
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kind", ["aat", "rank_k"])
def test_gram_kind_tables_match_jax(kind, variant, gram, levels):
    _assert_tables_equal(sf._program_tables(kind, levels, variant, gram),
                         jax_sf._program_tables(kind, levels, variant, gram))


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("trans_a,trans_b", TRANS)
@pytest.mark.parametrize("variant", MATMUL_VARIANTS)
def test_matmul_tables_match_jax(variant, trans_a, trans_b, levels):
    ours = leaf_ir.compile_program("matmul", levels, variant,
                                   trans_a=trans_a, trans_b=trans_b)
    ref = jax_ir.compile_program("matmul", levels, variant, trans_a=trans_a,
                                 trans_b=trans_b)
    assert (ours.blocks_m, ours.blocks_k, ours.blocks_n) == \
        (ref.blocks_m, ref.blocks_k, ref.blocks_n)
    _assert_tables_equal(
        sf._program_tables("matmul", levels, variant, "strassen", trans_a,
                           trans_b),
        jax_sf._program_tables("matmul", levels, variant, "strassen",
                               trans_a, trans_b))


def test_geometry_and_traffic_match_jax():
    """The aat and rank_k geometries clamp as the JAX package's do, and
    the traffic models built on them agree."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")         # the fan-in clamp's notice
        for m, n, levels, variant, gram in [
                (257, 511, 3, "strassen", "strassen"),
                (1000, 777, 2, "winograd", "dps"), (40, 24, 2, "classical",
                                                    "strassen")]:
            got = sf._aat_geometry(m, n, levels, variant, 64, 32, gram=gram)
            want = jax_sf._aat_geometry(m, n, levels, variant, 64, 32,
                                        gram=gram)
            assert {k: v for k, v in got.items() if k != "plan"} == \
                {k: v for k, v in want.items() if k != "plan"}
            assert sf.aat_traffic_model(m, n, levels=levels, variant=variant,
                                        gram=gram, bm=64, bk=32) == \
                jax_sf.aat_traffic_model(m, n, levels=levels,
                                         variant=variant, gram=gram, bm=64,
                                         bk=32)
        for m, T, levels in [(100, 6, 3), (2500, 40, 2), (3, 8, 3),
                             (64, 12, 3)]:
            got = sf._rank_k_geometry(m, T, levels, "strassen", 16)
            want = jax_sf._rank_k_geometry(m, T, levels, "strassen", 16)
            assert {k: v for k, v in got.items() if k != "plan"} == \
                {k: v for k, v in want.items() if k != "plan"}
        for m, n, levels in [(2500, 10000, 2), (41, 24, 3), (5, 70, 1)]:
            assert sf.rank_k_traffic_model(m, n, levels=levels, bk=8,
                                           bn=8) == \
                jax_sf.rank_k_traffic_model(m, n, levels=levels, bk=8, bn=8)


# ---------------------------------------------------------------------------
# aat: the row gram.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,block,levels,variant,gram", [
    (257, 511, 64, 2, "strassen", "strassen"),
    (511, 257, 64, 1, "winograd", "dps"),
    (40, 72, 8, 3, "strassen", "strassen"),
])
def test_aat_plain_matches_jax_interpret(pallas_compiler_params, m, n, block,
                                         levels, variant, gram):
    a = _rand((m, n), seed=m + levels)
    kw = dict(levels=levels, variant=variant, gram=gram, bm=block, bk=block)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want, m_pad_j = jax_sf.fused_aat_packed(jnp.asarray(a),
                                                interpret=True, **kw)
        got, m_pad = sf.fused_aat_packed(_t(a), device="cpu", **kw)
    assert tuple(got.shape) == tuple(want.shape) and m_pad == m_pad_j
    assert _rel(got.numpy(), want) <= 1e-5
    dense = ops.aat_fused(_t(a), device="cpu", **kw)
    assert tuple(dense.shape) == (m, m)
    assert _rel(dense.numpy(), np.tril(a.astype(np.float64) @ a.T)) <= 1e-5


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("gram", GRAMS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_aat_plain_matches_float64_oracles(variant, gram, levels):
    a = _rand((48, 57), seed=levels + 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = sf.fused_aat(_t(a), levels=levels, variant=variant, gram=gram,
                           bm=8, bk=8, device="cpu")
    a64 = a.astype(np.float64)
    assert _rel(got.numpy(), np.tril(a64 @ a64.T)) <= 1e-5
    assert np.abs(np.triu(got.numpy(), 1)).max() == 0.0
    # the JAX interpreter on the program the executor ran (clamped level)
    geo = sf._aat_geometry(48, 57, levels, variant, 8, 8, gram=gram)
    ap = np.zeros((geo["M"], geo["N"]))
    ap[:48, :57] = a
    prog = jax_ir.compile_program("aat", geo["levels"], variant, gram=gram)
    want = jax_ir.interpret_program(prog, ap)[:48, :48]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_aat_bf16_operands_and_output():
    a = _rand((72, 40), seed=3)
    ab = _t(a).to(torch.bfloat16)
    oracle = np.tril(_np(ab) @ _np(ab).T)
    got = sf.fused_aat(ab, levels=2, bm=8, bk=8, device="cpu")
    assert got.dtype == torch.float32 and _rel(got.numpy(), oracle) <= 1e-5
    q = sf.fused_aat(_t(a), levels=2, bm=8, bk=8,
                     operand_dtype=torch.bfloat16, device="cpu")
    assert _rel(q.numpy(), oracle) <= 1e-5
    b16 = sf.fused_aat(ab, levels=1, bm=8, bk=8, out_dtype=torch.bfloat16,
                       device="cpu")
    assert b16.dtype == torch.bfloat16 and _rel(_np(b16), oracle) < 3e-2


def test_gram_of_rows_fused_runs_the_aat_kind(pallas_compiler_params):
    """The repaired default: ``ata(gram_of="rows", mode="fused")`` runs
    the aat kind (its plain version here) and gives the JAX package's
    fused result; ``mode="auto"`` on the CPU is the reference."""
    a = _rand((45, 70), seed=2)
    want = jax_ata(jnp.asarray(a), gram_of="rows", levels=2, mode="fused",
                   block=8, interpret=True)
    got = ata(_t(a), gram_of="rows", levels=2, mode="fused", block=8,
              device="cpu")
    assert tuple(got.shape) == (45, 45) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5
    auto = ata(_t(a), gram_of="rows", levels=2, leaf=8, device="cpu")
    assert _rel(auto.numpy(), want) <= 1e-5


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("entry", ["dense", "packed"])
def test_aat_grad_matches_jax(dtype, tol, entry):
    """dA of the row gram is the dense (S + S^t) A, as jax.grad of the
    JAX package's reference row gram gives it."""
    a = _rand((40, 24), seed=11)
    w = _rand((40, 40), seed=12)
    jw = jnp.asarray(np.tril(w))
    want = jax.grad(lambda x: jnp.vdot(jw, jax_ata(
        x, gram_of="rows", levels=1, leaf=8, mode="reference")))(
        jnp.asarray(a).astype(dtype))
    x = _t(a).to(getattr(torch, dtype)).requires_grad_()
    if entry == "dense":
        out = ata(x, gram_of="rows", levels=1, mode="fused", block=8,
                  device="cpu")
        loss = (_t(np.tril(w)) * out).sum()
    else:
        packed, m_pad = sf.fused_aat_packed(x, levels=1, bm=8, bk=8,
                                            device="cpu")
        wd = np.zeros((m_pad, m_pad), np.float32)
        wd[:40, :40] = np.tril(w)
        loss = (pack_tril_blocks(_t(wd), 8) * packed).sum()
    (g,) = torch.autograd.grad(loss, x)
    assert g.dtype == x.dtype and g.shape == x.shape
    assert _rel(_np(g), np.asarray(want, np.float64)) < tol


# ---------------------------------------------------------------------------
# rank_k: the accumulating update.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("levels", [0, 1, 2])
def test_rank_k_plain_matches_jax_interpret(pallas_compiler_params, levels):
    T, bn = 8, 8
    c = _rand((T * (T + 1) // 2 * bn, bn), seed=20)
    a = _rand((37, 61), seed=21)
    want = jax_sf.fused_rank_k_update(jnp.asarray(c), jnp.asarray(a),
                                      levels=levels, bk=8, interpret=True)
    got = sf.fused_rank_k_update(_t(c), _t(a), levels=levels, bk=8,
                                 device="cpu")
    assert tuple(got.shape) == tuple(want.shape) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("gram", GRAMS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_rank_k_plain_matches_float64(variant, gram, levels):
    T, bn = 8, 8
    c = _rand((T * bn, T * bn), seed=levels)
    stack = pack_tril_blocks(_t(np.tril(c)), bn)
    a = _rand((41, 57), seed=levels + 30)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = sf.fused_rank_k_update(stack, _t(a), levels=levels,
                                     variant=variant, gram=gram, bk=8,
                                     device="cpu")
    dense = unpack_tril_blocks(got, T * bn, bn, symmetrize=False).numpy()
    ap = np.zeros((41, T * bn))
    ap[:, :57] = a
    want = np.tril(c) + np.tril(ap.T @ ap)
    assert _rel(np.tril(dense), want) <= 1e-5


@pytest.mark.parametrize("levels", LEVELS)
def test_rank_k_chunked_equals_one_shot(levels):
    """Streaming rows through rank_k gives the one-shot stack (the JAX
    suite's bar, tests/test_leaf_ir.py:309-329)."""
    a = _rand((96, 64), seed=levels)
    kw = dict(levels=levels, device="cpu")
    stack = ops.ata_fused_packed(_t(a[:40]), bk=8, bn=8, **kw)
    for chunk in (a[40:41], a[41:96]):
        stack = ops.rank_k_update(stack, _t(chunk), bk=8, **kw)
    one = ops.ata_fused_packed(_t(a), bk=8, bn=8, **kw)
    np.testing.assert_allclose(stack.numpy(), one.numpy(), rtol=1e-5,
                               atol=1e-4)


def test_rank_k_bf16_chunk_and_stack():
    T, bn = 4, 8
    a = _rand((50, 30), seed=5)
    ab = _t(a).to(torch.bfloat16)
    zero = torch.zeros(T * (T + 1) // 2 * bn, bn)
    got = sf.fused_rank_k_update(zero, ab, levels=1, bk=8, device="cpu")
    want = np.tril(_np(ab).T @ _np(ab))
    dense = unpack_tril_blocks(got, T * bn, bn, symmetrize=False).numpy()
    assert got.dtype == torch.float32
    assert _rel(np.tril(dense)[:30, :30], want) <= 1e-5
    # a bf16 stack stays bf16; the chunk is quantized, the stack is not
    q = sf.fused_rank_k_update(zero.to(torch.bfloat16), _t(a), levels=1,
                               bk=8, operand_dtype=torch.bfloat16,
                               device="cpu")
    assert q.dtype == torch.bfloat16
    dense = unpack_tril_blocks(q.float(), T * bn, bn, symmetrize=False)
    assert _rel(np.tril(dense.numpy())[:30, :30], want) < 3e-2


def test_rank_k_donate_updates_in_place():
    T, bn = 4, 8
    a = _rand((24, 32), seed=6)
    stack = torch.zeros(T * (T + 1) // 2 * bn, bn)
    kept = stack
    out = ops.rank_k_update(stack, _t(a), levels=1, bk=8, device="cpu")
    assert out is kept and out.data_ptr() == kept.data_ptr()
    want = ops.rank_k_update(torch.zeros_like(kept), _t(a), levels=1, bk=8,
                             donate=False, device="cpu")
    assert torch.equal(kept, want)
    fresh = torch.zeros_like(kept)
    new = ops.rank_k_update(fresh, _t(a), levels=1, bk=8, donate=False,
                            device="cpu")
    assert new.data_ptr() != fresh.data_ptr() and not fresh.any()
    # a stack autograd tracks is never overwritten
    tracked = torch.zeros_like(kept).requires_grad_()
    with pytest.raises(ValueError, match="donate=False"):
        ops.rank_k_update(tracked, _t(a), levels=1, bk=8, device="cpu")


@pytest.mark.parametrize("levels", [0, 1, 2])
def test_rank_k_grads_match_jax(pallas_compiler_params, levels):
    """dC_in passes through packed (cast to the stack's dtype) and dA runs
    the symm kind, as jax.grad of the JAX package's update gives them."""
    T, bn = 4, 8
    c = _rand((T * (T + 1) // 2 * bn, bn), seed=40)
    a = _rand((29, 30), seed=41)
    w = _rand(c.shape, seed=42)
    jw = jnp.asarray(w)
    gc_want, ga_want = jax.grad(
        lambda s, x: jnp.vdot(jw, jax_sf.fused_rank_k_update(
            s, x, levels=levels, bk=8, interpret=True)),
        (0, 1))(jnp.asarray(c), jnp.asarray(a))
    s = _t(c).requires_grad_()
    x = _t(a).requires_grad_()
    out = ops.rank_k_update(s, x, levels=levels, bk=8, donate=False,
                            device="cpu")
    gc, ga = torch.autograd.grad((_t(w) * out).sum(), (s, x))
    assert torch.equal(gc, _t(w))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(gc_want))
    assert _rel(_np(ga), ga_want) < 1e-4
    # a donated update with an untracked stack still differentiates A
    x2 = _t(a).requires_grad_()
    out = ops.rank_k_update(_t(c.copy()), x2, levels=levels, bk=8,
                            device="cpu")
    (ga2,) = torch.autograd.grad((_t(w) * out).sum(), x2)
    assert torch.equal(ga2, ga)


def test_rank_k_shape_errors_match_jax():
    stack, a = np.zeros((24, 8), np.float32), np.zeros((5, 16), np.float32)
    bad = [(stack[0], a), (np.zeros((20, 8), np.float32), a),
           (np.zeros((16, 8), np.float32), a),
           (stack, np.zeros((5, 17), np.float32))]
    for s, x in bad:
        with pytest.raises(ValueError):
            jax_sf.fused_rank_k_update(jnp.asarray(s), jnp.asarray(x), bk=8,
                                       interpret=True)
        with pytest.raises(ValueError):
            sf.fused_rank_k_update(_t(s), _t(x), bk=8, device="cpu")


# ---------------------------------------------------------------------------
# matmul: op(A) op(B).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mkn,block,levels,variant", [
    ((33, 17, 9), 8, 2, "strassen"),
    ((70, 40, 24), 8, 2, "winograd"),
    ((100, 40, 40), 8, 1, "bb322"),
])
@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (True, True)])
def test_matmul_plain_matches_jax_interpret(pallas_compiler_params, mkn,
                                            block, levels, variant, trans_a,
                                            trans_b):
    m, k, n = mkn
    a, b = _rand((m, k), seed=m), _rand((k, n), seed=n)
    args = (_op(a, trans_a), _op(b, trans_b))
    kw = dict(levels=levels, variant=variant, bm=block, bk=block, bn=block,
              trans_a=trans_a, trans_b=trans_b)
    want = jax_sf.fused_matmul(*map(jnp.asarray, args), interpret=True, **kw)
    got = sf.fused_matmul(*map(_t, args), device="cpu", **kw)
    assert tuple(got.shape) == (m, n) == tuple(want.shape)
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("trans_a,trans_b", TRANS)
@pytest.mark.parametrize("variant", MATMUL_VARIANTS)
def test_matmul_plain_matches_float64(variant, trans_a, trans_b, levels):
    m, k, n = 200, 72, 40
    a, b = _rand((m, k), seed=levels), _rand((k, n), seed=levels + 7)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = sf.fused_matmul(_t(_op(a, trans_a)), _t(_op(b, trans_b)),
                              levels=levels, variant=variant, bm=8, bk=8,
                              bn=8, trans_a=trans_a, trans_b=trans_b,
                              device="cpu")
    assert tuple(got.shape) == (m, n)
    assert _rel(got.numpy(), a.astype(np.float64) @ b) <= 1e-5


def test_matmul_levels_clamp_per_axis():
    """The per-axis clamp keeps a tile in every leaf (bb422 splits m four
    ways) and pads each axis to its own leaf grid."""
    geo = sf._matmul_geometry(1000, 777, 555, 3, "bb422", 64, 64, 64)
    assert geo["levels"] == 2 and geo["plan"].blocks_m == 16
    assert geo["M"] % (16 * 64) == 0 and geo["K"] % (4 * 64) == 0
    assert sf._matmul_geometry(10000, 10000, 10000, 2, "strassen", 256, 256,
                               256)["M"] == 10240
    assert sf._matmul_geometry(33, 17, 9, 3, "strassen", 8, 8, 8)[
        "levels"] == 1


def test_matmul_bf16_operands():
    a, b = _rand((64, 48), seed=1), _rand((48, 40), seed=2)
    ab, bb = _t(a).to(torch.bfloat16), _t(b).to(torch.bfloat16)
    want = _np(ab) @ _np(bb)
    got = sf.fused_matmul(ab, bb, levels=2, bm=8, bk=8, bn=8, device="cpu")
    assert got.dtype == torch.float32 and _rel(got.numpy(), want) <= 1e-5
    mixed = sf.fused_matmul(_t(a), bb.T.contiguous(), trans_b=True, levels=1,
                            bm=8, bk=8, bn=8, device="cpu")
    assert _rel(mixed.numpy(), a.astype(np.float64) @ _np(bb)) <= 1e-5
    q = sf.fused_matmul(_t(a), _t(b), levels=1, bm=8, bk=8, bn=8,
                        operand_dtype=torch.bfloat16,
                        out_dtype=torch.bfloat16, device="cpu")
    assert q.dtype == torch.bfloat16 and _rel(_np(q), want) < 3e-2


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("bwd", ["fused", "dense"])
@pytest.mark.parametrize("trans_a,trans_b", TRANS)
def test_matmul_grads_match_jax(trans_a, trans_b, bwd, dtype, tol):
    """Both VJP products, over the four trans cases, against jax.grad of
    the JAX package's reference product (the suite's
    test_fused_matmul_grads_match_reference)."""
    m, k, n = 33, 17, 9
    a, b = _rand((m, k), seed=10), _rand((k, n), seed=11)
    w = _rand((m, n), seed=12)
    args = (_op(a, trans_a).copy(), _op(b, trans_b).copy())
    jw = jnp.asarray(w)
    want = jax.grad(lambda x, y: jnp.vdot(jw, jax_strassen_matmul(
        x, y, levels=2, leaf=4, mode="reference", trans_a=trans_a,
        trans_b=trans_b, out_dtype=jnp.float32)), (0, 1))(
        *(jnp.asarray(x).astype(dtype) for x in args))
    xs = [_t(x).to(getattr(torch, dtype)).requires_grad_() for x in args]
    out = strassen_matmul(*xs, levels=2, mode="fused", bwd=bwd, block=8,
                          trans_a=trans_a, trans_b=trans_b,
                          out_dtype=torch.float32, device="cpu")
    grads = torch.autograd.grad((_t(w) * out).sum(), xs)
    for g, x, wg in zip(grads, xs, want):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert _rel(_np(g), np.asarray(wg, np.float64)) < tol


def test_strassen_matmul_fused_matches_jax_fused(pallas_compiler_params):
    a, b = _rand((40, 33), seed=7), _rand((50, 33), seed=8)
    want = jax_strassen_matmul(jnp.asarray(a), jnp.asarray(b), levels=2,
                               mode="fused", block=8, trans_b=True,
                               interpret=True)
    got = strassen_matmul(_t(a), _t(b), levels=2, mode="fused", block=8,
                          trans_b=True, device="cpu")
    assert tuple(got.shape) == (40, 50)
    assert _rel(got.numpy(), want) <= 1e-5


def test_matmul_shape_errors_match_jax():
    for a, b, kw in [((4, 5), (6, 3), {}), ((5, 4), (6, 3),
                                            dict(trans_a=True)),
                     ((4, 5), (5, 3), dict(trans_b=True)), ((4,), (4, 3), {})]:
        x, y = np.zeros(a, np.float32), np.zeros(b, np.float32)
        with pytest.raises(ValueError, match="bad shapes"):
            jax_sf.fused_matmul(jnp.asarray(x), jnp.asarray(y),
                                interpret=True, **kw)
        with pytest.raises(ValueError, match="bad shapes"):
            sf.fused_matmul(_t(x), _t(y), device="cpu", **kw)
    with pytest.raises(ValueError, match="bwd"):
        sf.fused_matmul(torch.zeros(8, 8), torch.zeros(8, 8), bwd="sparse",
                        device="cpu")
    with pytest.raises(ValueError, match="expects a matrix"):
        sf.fused_aat(torch.zeros(8), device="cpu")
