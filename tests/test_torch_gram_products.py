"""The gram kinds (ata, aat, rank_k) on the op walk, on the CPU.

A gram program of either gram runs ``csrc/leaf_products.cu`` on the card:
each leaf product computed once per output position, written into the
packed lower-triangular stack, a position above a leaf block's diagonal
skipping the ops that feed only diagonal blocks, and rank_k's incoming
stack read where an op first feeds a destination.  Its plain version
``_leaf_products_plain`` walks the same tables the same way (the dps
gram's transposed destinations: tests/test_torch_dps_products.py).

Here: which plain version ``leaf_program`` runs for which gram; the new
walk against the destination walk over algebra x levels 0-3, with fp32
and bf16 seeds; its ``torch.bmm`` calls (one per op and K block, over the
positions the op runs at) against ``product_flops``; the JAX package's
fused executor in interpret mode for each gram kind; rank_k written over
its own seed; a bf16 output rounded once; and ``product_flops`` at the
main path.  Tolerances are the JAX suite's: 1e-5 of max|out| in fp32
(tests/test_leaf_ir.py, tests/test_fused_ata.py), the walks and the JAX
executor differing only in summation order.  The CUDA kernel is held
against this plain version on the card by ``chip_smoke.py``.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.kernels import strassen_fused as jax_sf
from repro_torch.core.symmetry import pack_tril_blocks
from repro_torch.kernels import ops, strassen_fused as sf

VARIANTS = ("strassen", "winograd", "classical")
LEVELS = (0, 1, 2, 3)
KINDS = ("ata", "aat", "rank_k")


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


def _prepare(kind, levels, variant="strassen", gram="strassen", block=8,
             seed=0, stack_dtype=torch.float32, shape=(70, 61)):
    """(spec, padded A, seed stack or None) of a gram program on a ragged
    A, 70 x 61 by default (rank_k: into a stack of 8 tiles, or as many as
    A's columns need)."""
    a = torch.from_numpy(_rand(shape, seed))
    if kind == "ata":
        return (*sf._prepare_ata(a, levels, variant, gram, block, block),
                None)
    if kind == "aat":
        return (*sf._prepare_aat(a, levels, variant, gram, block, block),
                None)
    T = max(8, -(-shape[1] // block))
    low = torch.tril(torch.from_numpy(_rand((T * block,) * 2, seed + 1)))
    stack = pack_tril_blocks(low, block).to(stack_dtype)
    spec, ap = sf._prepare_rank_k(stack, a, levels, variant, gram, block)
    return spec, ap, stack


def _case(*args, **kw):
    """:func:`_prepare` with the fan-in clamp's warning silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return _prepare(*args, **kw)


@pytest.mark.parametrize("kind", KINDS)
def test_leaf_program_routes_by_gram(monkeypatch, kind):
    """On the CPU ``leaf_program`` runs the plain version of the kernel the
    card would launch: the op walk for either gram, for dps in pair mode,
    whose programs have transposed destinations."""
    ran = []
    for name in ("_leaf_products_plain", "_leaf_program_plain"):
        fn = getattr(sf, name)
        monkeypatch.setattr(sf, name, lambda *a, _fn=fn, _name=name, **kw:
                            ran.append(_name) or _fn(*a, **kw))
    for gram, want in (("strassen", "_leaf_products_plain"),
                       ("dps", "_leaf_products_plain")):
        spec, ap, seed = _case(kind, 2, gram=gram)
        assert sf._pairs(spec) == (gram == "dps")
        ran.clear()
        sf.leaf_program(spec, ap, ap, torch.float32, seed=seed)
        assert ran == [want], (gram, ran)


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_op_walk_matches_destination_walk(variant, kind, levels):
    """The new walk against ``_leaf_program_plain``, the TPU kernel's
    destination walk, on the same tables' program: 1e-5 of max|out|."""
    spec, ap, seed = _case(kind, levels, variant, seed=levels)
    got = sf._leaf_products_plain(spec, ap, ap, torch.float32, seed)
    want = sf._leaf_program_plain(spec, sf._spec_tables(spec, "cpu"), ap, ap,
                                  torch.float32, seed)
    assert got.shape == want.shape == sf._out_shape(spec)
    assert _rel(got.numpy(), want.numpy()) <= 1e-5


@pytest.mark.parametrize("stack_dtype,out_dtype",
                         [(torch.bfloat16, torch.float32),
                          (torch.float32, torch.bfloat16),
                          (torch.bfloat16, torch.bfloat16)])
def test_rank_k_seed_and_output_dtypes(stack_dtype, out_dtype):
    """A bf16 seed under an fp32 output and the reverse: the seed upcast,
    the sum in fp32, the output rounded once, as the destination walk
    does it."""
    spec, ap, seed = _case("rank_k", 2, seed=4, stack_dtype=stack_dtype)
    got = sf.leaf_program(spec, ap, ap, out_dtype, seed=seed)
    want = sf._leaf_program_plain(spec, sf._spec_tables(spec, "cpu"), ap, ap,
                                  torch.float32, seed)
    assert got.dtype == out_dtype
    bar = 1e-5 if out_dtype == torch.float32 else 2.0 ** -8
    assert _rel(got.float().numpy(), want.numpy()) <= bar


@pytest.mark.parametrize("kind,levels,shape", [
    ("ata", 2, (70, 61)), ("aat", 2, (70, 61)), ("rank_k", 2, (70, 61)),
    ("ata", 3, (40, 130)), ("aat", 3, (130, 40)), ("rank_k", 3, (40, 128))])
def test_plain_computes_each_product_once(monkeypatch, kind, levels, shape):
    """One ``torch.bmm`` per op and K block: an op that feeds only diagonal
    leaf blocks over the q (q + 1) / 2 positions on or below their
    diagonal, every other over all q^2; its rows are ``product_flops``."""
    spec, ap, seed = _case(kind, levels, block=8, shape=shape)
    rows = []
    bmm = torch.bmm

    def counted(x, y):
        rows.append(x.shape[0])
        return bmm(x, y)

    monkeypatch.setattr(torch, "bmm", counted)
    sf.leaf_program(spec, ap, ap, torch.float32, seed=seed)
    odiag = sf._op_tables(spec.kind, spec.levels, spec.variant)[-1]
    q = spec.q_i
    assert spec.levels == levels and q > 1 and spec.n_k >= 1
    assert len(rows) == len(odiag) * spec.n_k
    want = [q * (q + 1) // 2 if diag else q * q for diag in odiag
            for _ in range(spec.n_k)]
    assert rows == want
    assert sum(rows) * 2 * spec.bi * spec.bj * spec.bc == \
        sf.product_flops(spec)
    # the destination walk computes a product once per destination it feeds
    assert sf.live_steps(spec) * 2 * spec.bi * spec.bj * spec.bc > \
        sf.product_flops(spec)


@pytest.mark.parametrize("m,n,block,levels,variant", [
    (70, 61, 8, 2, "strassen"),
    (40, 72, 8, 3, "strassen"),
    (72, 40, 8, 2, "winograd"),
])
def test_ata_matches_jax_interpret(pallas_compiler_params, m, n, block,
                                   levels, variant):
    a = _rand((m, n), seed=m + levels)
    kw = dict(levels=levels, variant=variant, bk=block, bn=block)
    want, n_pad_j = jax_sf.fused_ata_packed(jnp.asarray(a), interpret=True,
                                            **kw)
    got, n_pad = sf.fused_ata_packed(torch.from_numpy(a), device="cpu", **kw)
    assert tuple(got.shape) == tuple(want.shape) and n_pad == n_pad_j
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("m,n,block,levels,variant", [
    (61, 70, 8, 2, "strassen"),
    (72, 40, 8, 3, "classical"),
])
def test_aat_matches_jax_interpret(pallas_compiler_params, m, n, block,
                                   levels, variant):
    a = _rand((m, n), seed=m + levels)
    kw = dict(levels=levels, variant=variant, bm=block, bk=block)
    want, m_pad_j = jax_sf.fused_aat_packed(jnp.asarray(a), interpret=True,
                                            **kw)
    got, m_pad = sf.fused_aat_packed(torch.from_numpy(a), device="cpu", **kw)
    assert tuple(got.shape) == tuple(want.shape) and m_pad == m_pad_j
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("levels,variant", [(2, "strassen"), (3, "strassen"),
                                            (2, "winograd")])
def test_rank_k_matches_jax_interpret(pallas_compiler_params, levels,
                                      variant):
    T, bn = 8, 8
    c = _rand((T * (T + 1) // 2 * bn, bn), seed=20 + levels)
    a = _rand((37, 61), seed=21 + levels)
    kw = dict(levels=levels, variant=variant, bk=8)
    want = jax_sf.fused_rank_k_update(jnp.asarray(c), jnp.asarray(a),
                                      interpret=True, **kw)
    got = sf.fused_rank_k_update(torch.from_numpy(c), torch.from_numpy(a),
                                 device="cpu", **kw)
    assert tuple(got.shape) == tuple(want.shape)
    assert _rel(got.numpy(), want) <= 1e-5


def test_rank_k_over_its_own_seed_is_bit_equal():
    """The update written over its seed (``out=seed``, and through
    ``ops.rank_k_update(donate=True)``) equals the out-of-place one."""
    spec, ap, seed = _case("rank_k", 2, seed=7)
    fresh = sf.leaf_program(spec, ap, ap, torch.float32, seed=seed)
    inplace = seed.clone()
    got = sf.leaf_program(spec, ap, ap, torch.float32, seed=inplace,
                          out=inplace)
    assert got.data_ptr() == inplace.data_ptr()
    assert torch.equal(inplace, fresh)
    a = torch.from_numpy(_rand((70, 61), 7))
    stack = seed.clone()
    kept = ops.rank_k_update(stack, a, levels=2, bk=8, donate=False,
                             device="cpu")
    donated = ops.rank_k_update(stack, a, levels=2, bk=8, donate=True,
                                device="cpu")
    assert donated.data_ptr() == stack.data_ptr()
    assert torch.equal(donated, kept)


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_output_is_fp32_rounded_once(kind):
    spec, ap, seed = _case(kind, 2, seed=9)
    full = sf.leaf_program(spec, ap, ap, torch.float32, seed=seed)
    half = sf.leaf_program(spec, ap, ap, torch.bfloat16, seed=seed)
    assert half.dtype == torch.bfloat16
    assert torch.equal(half, full.to(torch.bfloat16))


def test_product_flops_main_path():
    """ata and aat at 10000^2 (padded 10240, levels 2, tiles of 256, q =
    10): 16 syrk ops over 55 tiles and 22 mm ops over 100, 3080 tile
    products of 2 * 256^2 * 2560 flops, 1.0335e12, against the
    destination walk's 1.369e12; rank_k's 2500-row chunk the same tiles
    at depth 768."""
    a_geo = sf._ata_geometry(10000, 10000, 2, "strassen", 256, 256)
    spec = sf._bind(a_geo["plan"], n_out=a_geo["n_tri"], n_tj=0,
                    q_i=a_geo["nbt"], q_j=a_geo["nbt"], n_k=a_geo["n_k"],
                    bi=256, bj=256, bc=256)
    assert (spec.q_i, spec.n_k) == (10, 10)
    flops = sf.product_flops(spec)
    assert flops == (16 * 55 + 22 * 100) * 2 * 256 ** 2 * 2560 \
        == 3080 * 2 * 256 ** 2 * 2560
    assert round(flops / 1e8) == 10335
    assert round(sf.live_steps(spec) * 2 * 256 ** 3 / 1e9) == 1369
    r_geo = sf._aat_geometry(10000, 10000, 2, "strassen", 256, 256)
    rspec = sf._bind(r_geo["plan"], n_out=r_geo["n_tri"], n_tj=0,
                     q_i=r_geo["nbt"], q_j=r_geo["nbt"], n_k=r_geo["n_k"],
                     bi=256, bj=256, bc=256)
    assert sf.product_flops(rspec) == flops
    k_geo = sf._rank_k_geometry(2500, 40, 2, "strassen", 256)
    kspec = sf._bind(k_geo["plan"], n_out=k_geo["n_tri"], n_tj=0,
                     q_i=k_geo["nbt"], q_j=k_geo["nbt"], n_k=k_geo["n_k"],
                     bi=256, bj=256, bc=256)
    assert sf.product_flops(kspec) == 3080 * 2 * 256 ** 2 * 768


def test_winograd_levels_3_clamps_for_the_gram_kinds():
    """``ata_full(levels="auto")`` asks for levels 3; winograd's gram
    program there has 16 terms a side, over ``MAX_OPERAND_TERMS``, and is
    clamped to levels 2, whose op tables fit the kernel."""
    assert sf.compile_program("ata", 3, "winograd").max_terms > \
        sf.MAX_OPERAND_TERMS
    for kind in KINDS:
        sf._CLAMP_WARNED.clear()
        with pytest.warns(UserWarning, match="clamped to levels=2"):
            spec = _prepare(kind, 3, "winograd")[0]
        assert spec.levels == 2 and spec.tmax <= sf.MAX_OPERAND_TERMS
        assert sf._op_tables(kind, 2, "winograd")[0].shape[1] == spec.tmax
