"""The dps gram's programs on the op walk, on the CPU.

The dps gram's ata, aat and rank_k programs have transposed
destinations: a slot takes the op's product transposed.  For the gram
kinds that is the product at the mirror position, transposed, so
``csrc/leaf_products.cu`` runs them in pair mode, each leaf product
computed once, and its plain version ``_leaf_products_plain`` takes
``prod[mirror]^t``.  An element of a leaf block at ``(r, c)`` (in the
leaf block's coordinates) takes an op's straight slots first where
``r >= c`` and its transposed ones first where ``r < c``.

Here: the op tables, transposed slots expanded per destination, against
the destination-indexed tables (ours and the JAX package's); the walk
against the TPU kernel's destination walk ``_leaf_program_plain``
(1e-5 of max|out|, the two differing only in summation order), against
float64 (1e-4; a bf16 output 2^-8) and against the JAX fused executor
in interpret mode (1e-5, the reference tests' bar); rank_k over its own
seed; the element order, which no output tile changes; and
``product_flops`` against the walk's ``torch.bmm`` rows.  Shapes are
small with odd edges (257 x 511, 511 x 257), tiles of 64.  The CUDA
kernel is held against this plain version on the card by
``chip_smoke.py``.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.kernels import strassen_fused as jax_sf
from repro_torch.core.symmetry import pack_tril_blocks, unpack_tril_blocks
from repro_torch.kernels import ops, strassen_fused as sf
from test_torch_leaf_products import _assert_tables_equal, _slot_tables

KINDS = ("ata", "aat", "rank_k")
VARIANTS = ("strassen", "winograd", "classical")


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


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


def _shape(kind):
    """A ragged A: the gram side odd and the longer one."""
    return (511, 257) if kind == "aat" else (257, 511)


def _prepare(kind, levels, variant="strassen", block=64, seed=0,
             shape=None, stack_dtype=torch.float32):
    """(spec, padded A, seed stack or None, A, lower seed or None) of a dps
    program; rank_k updates a random lower-triangular stack."""
    a = _rand(shape or _shape(kind), seed)
    at = torch.from_numpy(a)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the fan-in clamp's notice
        if kind == "ata":
            return (*sf._prepare_ata(at, levels, variant, "dps", block,
                                     block), None, a, None)
        if kind == "aat":
            return (*sf._prepare_aat(at, levels, variant, "dps", block,
                                     block), None, a, None)
        T = -(-a.shape[1] // block)
        T = -(-T // 8) * 8                  # levels 3 need 8 | T
        low = np.tril(_rand((T * block,) * 2, seed + 1))
        stack = pack_tril_blocks(torch.from_numpy(low), block).to(
            stack_dtype)
        spec, ap = sf._prepare_rank_k(stack, at, levels, variant, "dps",
                                      block)
    return spec, ap, stack, a, low


def _dense_lower(kind, spec, packed, a):
    """The leading lower triangle the packed stack holds."""
    side = spec.q_i * spec.bi * sf.compile_program(
        spec.kind, spec.levels, spec.variant, gram="dps").blocks
    n = a.shape[0] if kind == "aat" else a.shape[1]
    if kind == "rank_k":
        n = side
    dense = unpack_tril_blocks(packed.float(), side, spec.bi,
                               symmetrize=False)
    return np.tril(dense.numpy())[:n, :n]


def _want64(kind, a, low):
    a64 = a.astype(np.float64)
    g = a64 @ a64.T if kind == "aat" else a64.T @ a64
    if kind != "rank_k":
        return np.tril(g)
    out = low.astype(np.float64)
    out[:g.shape[0], :g.shape[1]] += np.tril(g)
    return out


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("variant", ["strassen", "winograd"])
@pytest.mark.parametrize("kind", KINDS)
def test_dps_op_tables_rederive_program_tables(kind, variant, levels):
    """Each destination's slots, the ops that feed it in op order with a
    transposed slot's sides swapped, are the destination tables slot for
    slot; the first/last flags follow the element order in both halves
    of a leaf block (checked in the helper)."""
    got = _slot_tables(kind, levels, variant, gram="dps")
    _assert_tables_equal(got, sf._program_tables(kind, levels, variant,
                                                 "dps"))
    _assert_tables_equal(got, jax_sf._program_tables(kind, levels, variant,
                                                     "dps"))
    dtrn = sf._op_tables(kind, levels, variant, "dps")[10]
    assert dtrn.any()


@pytest.mark.parametrize("levels", [0, 1, 2, 3])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kind", KINDS)
def test_dps_walk_matches_destination_walk(kind, variant, levels):
    spec, ap, seed, a, low = _prepare(kind, levels, variant, seed=levels)
    got = sf._leaf_products_plain(spec, ap, ap, torch.float32, seed)
    want = sf._leaf_program_plain(spec, sf._spec_tables(spec, "cpu"), ap, ap,
                                  torch.float32, seed)
    assert got.shape == want.shape == sf._out_shape(spec)
    assert _rel(got.numpy(), want.numpy()) <= 1e-5
    assert _rel(_dense_lower(kind, spec, got, a), _want64(kind, a, low)) \
        <= 1e-4


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", KINDS)
def test_dps_walk_matches_float64(kind, out_dtype):
    """Through ``leaf_program`` on the CPU; a bf16 output is the fp32 sum
    rounded once."""
    spec, ap, seed, a, low = _prepare(kind, 2, seed=11)
    assert spec.levels == 2 and sf._pairs(spec)
    got = sf.leaf_program(spec, ap, ap, out_dtype, seed=seed)
    assert got.dtype == out_dtype
    bar = 1e-4 if out_dtype == torch.float32 else 2.0 ** -8
    assert _rel(_dense_lower(kind, spec, got, a), _want64(kind, a, low)) \
        <= bar
    full = sf.leaf_program(spec, ap, ap, torch.float32, seed=seed)
    assert torch.equal(got, full.to(out_dtype))


@pytest.mark.parametrize("kind", KINDS)
def test_dps_matches_jax_interpret(pallas_compiler_params, kind):
    a = _rand(_shape(kind), seed=5)
    kw = dict(levels=2, variant="strassen", gram="dps")
    if kind == "ata":
        want, pad_j = jax_sf.fused_ata_packed(jnp.asarray(a), bk=64, bn=64,
                                              interpret=True, **kw)
        got, pad = sf.fused_ata_packed(torch.from_numpy(a), bk=64, bn=64,
                                       device="cpu", **kw)
        assert pad == pad_j
    elif kind == "aat":
        want, pad_j = jax_sf.fused_aat_packed(jnp.asarray(a), bm=64, bk=64,
                                              interpret=True, **kw)
        got, pad = sf.fused_aat_packed(torch.from_numpy(a), bm=64, bk=64,
                                       device="cpu", **kw)
        assert pad == pad_j
    else:
        T, bn = 8, 64
        c = _rand((T * (T + 1) // 2 * bn, bn), seed=6)
        want = jax_sf.fused_rank_k_update(jnp.asarray(c), jnp.asarray(a),
                                          bk=64, interpret=True, **kw)
        got = sf.fused_rank_k_update(torch.from_numpy(c),
                                     torch.from_numpy(a), bk=64,
                                     device="cpu", **kw)
    assert tuple(got.shape) == tuple(want.shape)
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("stack_dtype", [torch.float32, torch.bfloat16])
def test_dps_rank_k_over_its_own_seed(stack_dtype):
    """The update written over its seed (``out=seed``, and through
    ``ops.rank_k_update(donate=True)``) equals the out-of-place one."""
    spec, ap, seed, a, _ = _prepare("rank_k", 2, seed=7,
                                    stack_dtype=stack_dtype)
    fresh = sf.leaf_program(spec, ap, ap, stack_dtype, seed=seed)
    inplace = seed.clone()
    got = sf.leaf_program(spec, ap, ap, stack_dtype, seed=inplace,
                          out=inplace)
    assert got.data_ptr() == inplace.data_ptr()
    assert torch.equal(inplace, fresh)
    stack = seed.clone()
    kept = ops.rank_k_update(stack, torch.from_numpy(a), levels=2, bk=64,
                             gram="dps", donate=False, device="cpu")
    donated = ops.rank_k_update(stack, torch.from_numpy(a), levels=2,
                                bk=64, gram="dps", donate=True,
                                device="cpu")
    assert donated.data_ptr() == stack.data_ptr()
    assert torch.equal(donated, kept)
    assert torch.equal(kept, fresh)


@pytest.mark.parametrize("kind", ["ata", "aat"])
def test_dps_element_order_is_independent_of_the_tile(monkeypatch, kind):
    """The order in which an element takes its contributions is fixed in
    its leaf block's coordinates, so output tiles of 8, 16 and 32 over the
    same leaf blocks give the same bits.  Each product element is made
    independent of the tiling (computed in float64, rounded once), so
    only the order of the contributions could move a bit."""
    bmm = torch.bmm
    monkeypatch.setattr(torch, "bmm",
                        lambda x, y: bmm(x.double(), y.double()).float())
    a = torch.from_numpy(_rand((96, 128) if kind == "ata" else (128, 96), 3))
    lowers = []
    for block in (8, 16, 32):
        if kind == "ata":     # output leaf blocks of 32 x 32, K blocks of 4
            spec, ap = sf._prepare_ata(a, 2, "strassen", "dps", 4, block)
        else:
            spec, ap = sf._prepare_aat(a, 2, "strassen", "dps", block, 4)
        assert spec.levels == 2 and spec.bc == 4
        assert spec.q_i * spec.bi == 32 and sf._pairs(spec)
        got = sf._leaf_products_plain(spec, ap, ap, torch.float32)
        lowers.append(torch.tril(unpack_tril_blocks(got, 128, block,
                                                    symmetrize=False)))
    assert torch.equal(lowers[0], lowers[1])
    assert torch.equal(lowers[0], lowers[2])


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_dps_product_flops_is_bmm_rows(monkeypatch, kind, levels):
    """One ``torch.bmm`` per op and K block over all q^2 positions (every
    dps op feeds a transposed or off-diagonal destination); its rows are
    ``product_flops``."""
    spec, ap, seed, _, _ = _prepare(kind, levels, block=32, seed=2)
    rows = []
    bmm = torch.bmm

    def counted(x, y):
        rows.append(x.shape[0])
        return bmm(x, y)

    monkeypatch.setattr(torch, "bmm", counted)
    sf.leaf_program(spec, ap, ap, torch.float32, seed=seed)
    q, n_ops = spec.q_i, len(sf._op_tables(kind, levels, "strassen",
                                           "dps")[0])
    assert spec.levels == levels and q > 1
    assert rows == [q * q] * (n_ops * spec.n_k)
    assert sum(rows) * 2 * spec.bi * spec.bj * spec.bc == \
        sf.product_flops(spec)


def test_dps_product_flops_main_path():
    """At 10000^2 (padded 10240, levels 2, tiles of 256, q = 10): 31 ops
    over all 100 positions, 3100 tile products of 2 * 256^2 * 2560 flops,
    1.0402e12 — the strassen gram's 3080 and 1.0335e12 within 1 %."""
    geo = sf._ata_geometry(10000, 10000, 2, "strassen", 256, 256,
                           gram="dps")
    spec = sf._bind(geo["plan"], n_out=geo["n_tri"], n_tj=0, q_i=geo["nbt"],
                    q_j=geo["nbt"], n_k=geo["n_k"], bi=256, bj=256, bc=256)
    assert (spec.q_i, spec.n_k, len(geo["plan"].ops)) == (10, 10, 31)
    flops = sf.product_flops(spec)
    assert flops == 3100 * 2 * 256 ** 2 * 2560
    assert round(flops / 1e8) == 10402
