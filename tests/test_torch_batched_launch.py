"""The batched launch of the leaf program's kernel, on the CPU.

The persistent batched kernel (``leaf_products_batched_kernel``) runs
only on the card; what it walks is planned in Python and held here: the
tile rule of ``strassen_fused.batched_plan``, the (slot, position) items
its grid's strides deal out (each exactly once, heaviest first) at the
stack shapes Shampoo's statistics and the Gram service launch, the cache
of bound programs in ``batched_gram``, and ``batched_gram`` at small
versions of Shampoo's shape classes against the JAX package's (the
reference recursion, and the fused path's plain version against the JAX
kernel in interpret mode).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.gram import batched_gram as jax_batched_gram
from repro_torch.gram import batched_gram
from repro_torch.gram import engine
from repro_torch.kernels import strassen_fused as sf

SMS = 132                            # an H100 SXM's
PER_SM = {128: 1, 64: 2}             # the batched kernel's occupancy there

# (K, m, n) of Shampoo's statistics for Qwen2.5-3B at 2 layers (blocks of
# 1024), the Gram service's 256^2 stack (levels 0) and 8192^2 stack
STACKS = [(8, 1024, 1024, 1), (44, 1024, 1024, 1), (4, 256, 1024, 1),
          (4, 1024, 256, 1), (2, 2, 1024, 1), (2, 1024, 2, 1),
          (1, 2, 256, 1), (1, 256, 2, 1), (4, 256, 256, 0),
          (4, 8192, 8192, 1)]


@pytest.fixture
def pallas_compiler_params(monkeypatch):
    """The installed jax renamed ``pltpu.TPUCompilerParams`` to
    ``CompilerParams``; the JAX executor still uses the old name.  Alias
    it for the duration of one test only."""
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)


def _spec(m, n, levels, kind="ata", b=256):
    return sf._gram_spec(kind, m, n, levels, "strassen", "strassen", b, b,
                         2)[0]


def _item_ops(spec, iq, jq):
    """Live ops of an item: a position above a leaf block's diagonal skips
    the ops that feed only diagonal blocks."""
    odiag = sf._spec_op_tables(spec)[-1]
    if spec.out_tri and iq < jq:
        return int((odiag == 0).sum())
    return len(odiag)


def _greedy_loads(cost, grid):
    """Each block's ops when block b walks item b, then each block free
    first takes the next item (the kernel's counter)."""
    load = list(cost[:grid])
    for c in cost[grid:]:
        load[load.index(min(load))] += c
    return load


@pytest.mark.parametrize("K,m,n,levels", STACKS,
                         ids=[f"{k}x{m}x{n}" for k, m, n, _ in STACKS])
def test_plan_covers_every_item_once_heaviest_first(K, m, n, levels):
    """The plan's items are every (slot, position) that writes something,
    each once, heaviest first; the positions past them write nothing."""
    spec = _spec(m, n, levels)
    plan = sf.batched_plan(spec, K, SMS, PER_SM)
    tile, items, grid = plan["tile"], plan["items"], plan["grid"]
    assert 1 <= grid <= items
    every = [sf.batched_item(spec, K, tile, g)
             for g in range(sf._positions(spec, tile, K))]
    q = spec.q_i
    subs_i, subs_j = range(0, spec.bi, tile), range(0, spec.bj, tile)
    assert sorted(every) == sorted(itertools.product(
        range(K), range(q), range(q), subs_i, subs_j))
    cost = [_item_ops(spec, iq, jq) for _, iq, jq, _, _ in every]
    assert cost == sorted(cost, reverse=True)
    assert min(cost[:items]) > 0 and not any(cost[items:])
    # taken heaviest first, no block walks more than the mean plus one item
    load = _greedy_loads(cost[:items], grid)
    assert max(load) <= sum(cost) / grid + max(cost)


@pytest.mark.parametrize("K,m,n,levels,tile,items,grid", [
    (44, 1024, 1024, 1, 128, 704, 132),     # 5.3 items an SM at 128
    (8, 1024, 1024, 1, 128, 128, 128),      # 192 steps either way: 128
    (4, 8192, 8192, 1, 128, 4096, 132),
    (5, 1024, 1024, 1, 64, 320, 264),       # 138 tile-128 steps at 64
    (4, 1024, 1024, 1, 64, 256, 256),       # 104 at 64, 192 at 128
    (4, 256, 256, 0, 64, 64, 64),           # 8.6 at 64, 16 at 128
    # levels 0: the positions above a leaf block's diagonal write nothing
    (2, 2, 1024, 1, 128, 80, 80),           # 10 of 16 cells: 16 at 128
    (4, 1024, 256, 1, 64, 64, 64),
])
def test_plan_tile_rule(K, m, n, levels, tile, items, grid):
    """The tile whose busiest block takes least, in tile-128 steps: the
    greedy makespan of the items times the tile's step cost."""
    spec = _spec(m, n, levels)
    plan = sf.batched_plan(spec, K, SMS, PER_SM)
    assert (plan["tile"], plan["items"], plan["grid"]) == (tile, items, grid)
    assert plan["blocks_per_sm"] == PER_SM[tile]
    assert plan["items"] == sf._live_positions(spec, tile, K)


@pytest.mark.parametrize("K,blocks,want", [(8, 128, 192), (8, 264, 192),
                                           (44, 132, 896), (5, 264, 128)])
def test_makespan_of_greedy_takes(K, blocks, want):
    """(K, 1024^2), levels 1: heavy items of 6 ops, light of 2, 2 K blocks
    each, of 16-deep steps at 128 and 32-deep at 64."""
    spec = _spec(1024, 1024, 1)
    tile = 128 if blocks in (128, 132) else 64
    assert sf._batched_makespan(spec, K, tile, blocks) == want
    cost = [_item_ops(spec, iq, jq) * spec.n_k * (256 // sf.BATCHED_KC[tile])
            for _, iq, jq, _, _ in (sf.batched_item(spec, K, tile, g) for g in
                                    range(sf._live_positions(spec, tile, K)))]
    assert max(_greedy_loads(cost, blocks)) == want


def test_plan_tile_forced_and_refused():
    spec = _spec(1024, 1024, 1)
    assert sf.batched_plan(spec, 44, SMS, PER_SM, tile=64)["grid"] == 264
    assert sf.batched_plan(spec, 2, SMS, PER_SM, tile=128)["items"] == 32
    # 128 does not fit an SM, or does not divide the output tiles: 64
    assert sf.batched_plan(spec, 44, SMS, {128: 0, 64: 2})["tile"] == 64
    assert sf.batched_plan(_spec(1024, 1024, 1, b=192), 44, SMS,
                           PER_SM)["tile"] == 64
    with pytest.raises(ValueError, match="does not fit"):
        sf.batched_plan(spec, 8, SMS, {128: 0, 64: 0})
    with pytest.raises(ValueError, match="tile must be"):
        sf.batched_plan(spec, 8, SMS, PER_SM, tile=96)


def test_items_follow_the_cell_order():
    """Cells as the kernel's ``cell_of`` walks a packed output of q = 3:
    the six on or below the diagonal in packed order, then the three
    light ones; the slot innermost, then the sub-tile."""
    spec = _spec(1536, 1536, 1)             # leaf blocks of 768: q = 3
    assert spec.q_i == 3
    cells = [sf._cell(spec, c) for c in range(9)]
    assert cells == [(0, 0), (1, 0), (1, 1), (2, 0), (2, 1), (2, 2),
                     (0, 1), (0, 2), (1, 2)]
    assert [sf.batched_item(spec, 2, 128, g) for g in range(5)] == [
        (0, 0, 0, 0, 0), (1, 0, 0, 0, 0), (0, 0, 0, 0, 128),
        (1, 0, 0, 0, 128), (0, 0, 0, 128, 0)]


def test_batched_launch_refuses_what_it_does_not_run():
    """The batched kernel runs ata and aat with an fp32 accumulator on one
    operand type, no transposed destination."""
    sf._check_batched(_spec(64, 64, 1, "aat", b=16), torch.float32,
                      torch.float32)
    dps = sf._gram_spec("ata", 64, 64, 1, "strassen", "dps", 16, 16)[0]
    for spec, types in ((_spec(64, 64, 1, b=16), (torch.float32,
                                                  torch.bfloat16)),
                        (dps, (torch.float32,) * 2)):
        with pytest.raises(ValueError, match="batched launch runs"):
            sf._check_batched(spec, *types)


def test_bound_gram_cache_one_per_key():
    engine._BOUND_GRAMS.clear()
    kw = dict(levels=1, leaf=8, variant="strassen", block=8)
    f32 = torch.float32
    a = engine._bound_gram(3, 40, 24, out_dtype=f32, dtype=f32,
                           device="cpu", **kw)
    counts = dict(engine.BOUND_GRAM_COUNTS)
    assert engine._bound_gram(3, 40, 24, out_dtype=f32, dtype=f32,
                              device="cpu", **kw) is a
    assert engine.BOUND_GRAM_COUNTS == {**counts, "hits": counts["hits"] + 1}
    others = [engine._bound_gram(3, 40, 24, out_dtype=f32,
                                 dtype=torch.float64, device="cpu", **kw),
              engine._bound_gram(3, 40, 32, out_dtype=f32, dtype=f32,
                                 device="cpu", **kw),
              engine._bound_gram(2, 40, 24, out_dtype=f32, dtype=f32,
                                 device="cpu", **kw),
              engine._bound_gram(3, 40, 24, out_dtype=f32, dtype=f32,
                                 device="meta", **kw)]
    assert len({id(b) for b in (a, *others)}) == 5
    assert engine.BOUND_GRAM_COUNTS["binds"] == counts["binds"] + 4
    assert others[-1].device == torch.device("meta")
    assert len(engine._BOUND_GRAMS) == 5


def test_bound_gram_cache_is_bounded(monkeypatch):
    engine._BOUND_GRAMS.clear()
    monkeypatch.setattr(engine, "BOUND_GRAMS_MAX", 2)
    kw = dict(levels=1, leaf=8, variant="strassen", block=8,
              out_dtype=torch.float32, dtype=torch.float32, device="cpu")
    first = engine._bound_gram(1, 16, 8, **kw)
    engine._bound_gram(2, 16, 8, **kw)
    engine._bound_gram(1, 16, 8, **kw)               # first: most recent
    engine._bound_gram(3, 16, 8, **kw)               # drops K = 2
    assert [k[0] for k in engine._BOUND_GRAMS] == [1, 3]
    assert engine._bound_gram(1, 16, 8, **kw) is first


# small versions of Shampoo's stack classes: (K, 2, n) and (K, n, 2) (a
# stacked per-layer vector's R and L sides), (K, m, n) with m < n and m > n,
# and one block (K = 1)
SHAPES = [(3, 2, 24), (3, 24, 2), (3, 8, 24), (3, 24, 8), (1, 16, 16)]


def _stack(shape, seed=7):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_batched_gram_reference_matches_jax(shape):
    x = _stack(shape)
    got = batched_gram(torch.from_numpy(x), levels=1, leaf=8,
                       mode="reference", device="cpu")
    want = np.asarray(jax_batched_gram(jnp.asarray(x), levels=1, leaf=8,
                                       mode="reference"))
    _close(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_batched_gram_fused_matches_jax_interpret(pallas_compiler_params,
                                                  shape):
    """The fused path (the batched launch's plain version, one bound
    program over the stack) against ``jax.vmap`` over the JAX package's
    interpret-mode kernel; a second call takes the bound program from the
    cache and gives the same bits."""
    x = _stack(shape)
    before = sf.KERNEL_LAUNCHES["leaf_program/ata"]
    kw = dict(levels=1, mode="fused", block=8, device="cpu")
    got = batched_gram(torch.from_numpy(x), **kw)
    assert sf.KERNEL_LAUNCHES["leaf_program/ata"] == before     # CPU: plain
    counts = dict(engine.BOUND_GRAM_COUNTS)
    assert torch.equal(batched_gram(torch.from_numpy(x), **kw), got)
    assert engine.BOUND_GRAM_COUNTS == {**counts, "hits": counts["hits"] + 1}
    want = np.asarray(jax_batched_gram(jnp.asarray(x), levels=1,
                                       mode="fused", block=8,
                                       interpret=True))
    _close(got.numpy(), want)


@pytest.mark.parametrize("gather", [True, False])
def test_symmetric_unpack_keeps_the_mirrors_bits(monkeypatch, gather):
    """``BoundGram(..., symmetrize=True)``, by its gather (an int32 index
    kept with the program) or, past ``GATHER_MAX_EDGE``, by
    ``unpack_tril_blocks`` (each tile written once, no index kept), gives
    the bits of the JAX package's mirror ``tril(c) + tril(c, -1).T`` of
    the packed stack's dense lower tiles, -0 rounded to +0 as its adds
    round it (a packed stack holds -0 where the last op to write an
    element, of sign -1, brought +0 to an element that held nothing)."""
    from repro_torch.core.symmetry import unpack_tril_blocks
    if not gather:
        monkeypatch.setattr(sf, "GATHER_MAX_EDGE", 23)
    bound = sf.BoundGram(40, 24, batch=2, levels=1, b_out=8, b_k=8,
                         out_dtype=torch.float32, device="cpu")
    packed = torch.from_numpy(_stack((2, bound.spec.n_out * 8, 8), seed=5))
    packed[packed.abs() < 0.3] = -0.0
    bound.packed = lambda stack: packed
    c = torch.tril(unpack_tril_blocks(packed, bound.edge, 8,
                                      symmetrize=False))
    want = (c + torch.tril(c, -1).mT)[:, :24, :24]
    got = bound(torch.zeros(2, 40, 24), symmetrize=True)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if gather:
        assert bound._mirror.dtype == torch.int32
        assert bound._mirror.numel() == 24 * 24
    else:
        assert bound._mirror is None
    assert not bool((got.view(torch.int32) == -2 ** 31).any())
