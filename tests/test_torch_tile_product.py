"""The launch arithmetic of the port's shared tile products (the CUDA-core
``csrc/tile_product.cuh`` and the tensor-core ``csrc/tile_product_tc.cuh``,
behind ``csrc/syrk.cu`` and ``csrc/matmul.cu``).

The kernels run only on the card, where ``chip_smoke.py`` holds them
against their plain versions at both block tiles.  What surrounds them
is pure Python and runs here: the block tile each launch takes, the
sub-tile grid the kernels decode from ``blockIdx.y``, the packed-tile
grid of syrk, and the block and wave counts on the card's SMs for a given
number of blocks an SM.  The wrappers' ``tile`` argument is checked on
the CPU too, and the plain versions it reaches match the JAX package.
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import _launch

jax_matmul = importlib.import_module("repro.kernels.matmul")
p_matmul, p_syrk = (importlib.import_module(f"repro_torch.kernels.{name}")
                    for name in ("matmul", "syrk"))

SMS = 132                                    # an H100 SXM's SMs
EDGES = tuple(range(8, 257, 8))              # every block edge 8-256
# blocks an SM at each tile, by operand dtype, as the card's occupancy
# query gives them for the launch bounds of the dtype's core
# (``_launch.product_core``): the CUDA cores (fp32) two at 128, four at 64;
# the tensor cores (bf16 with bf16) one at 128, three at 64
PER_SM = {"float32": {128: 2, 64: 4}, "bfloat16": {128: 1, 64: 3}}
CORE = {name: _launch.product_core(getattr(torch, name), getattr(torch, name))
        for name in PER_SM}


@pytest.mark.parametrize("dtype", sorted(PER_SM))
@pytest.mark.parametrize("edge", EDGES)
def test_tile_choice_by_block_edge(edge, dtype):
    """The wrappers' tile at each block edge, on a 2560-wide leaf padded
    to the edge: 64 where a 128 sub-tile would be mostly empty (edges up
    to 64), 128 where it divides the edge, and in every case the tile of
    least busiest-SM cost, ties to 128."""
    per_sm, core = PER_SM[dtype], CORE[dtype]
    n = -(-2560 // edge) * edge
    got = p_matmul._grid(n, n, edge, edge, per_sm, SMS, core=core)
    shapes = {t: p_matmul._grid(n, n, edge, edge, per_sm, SMS, tile=t,
                                core=core)
              for t in _launch.PRODUCT_TILES}
    for t, shape in shapes.items():
        assert shape["cost"] == math.ceil(shape["blocks"] / SMS) \
            * _launch.STEP_COST[core][t]
    assert got["cost"] == min(s["cost"] for s in shapes.values())
    if shapes[128]["cost"] == shapes[64]["cost"]:
        assert got["tile"] == 128
    if edge <= 64:
        assert got["tile"] == 64
    if edge % 128 == 0:
        assert got["tile"] == 128
    assert p_syrk._grid(n, edge, per_sm, SMS, core=core)["tile"] \
        in _launch.PRODUCT_TILES


def test_tile_choice_skips_a_tile_that_cannot_launch():
    shape = p_matmul._grid(2560, 2560, 256, 256, {128: 0, 64: 3}, SMS,
                           core="cuda")
    assert shape["tile"] == 64
    with pytest.raises(RuntimeError, match="no tile"):
        p_matmul._grid(2560, 2560, 256, 256, {128: 0, 64: 0}, SMS,
                       core="cuda")
    with pytest.raises(ValueError, match="tile"):
        p_matmul._grid(2560, 2560, 256, 256, PER_SM["float32"], SMS, tile=96,
                       core="cuda")


@pytest.mark.parametrize("tile", _launch.PRODUCT_TILES)
@pytest.mark.parametrize("bm,bn", [(8, 8), (40, 40), (64, 64), (72, 136),
                                   (128, 128), (136, 200), (200, 136),
                                   (248, 256), (256, 256), (256, 40)])
def test_sub_tiles_cover_each_output_once(bm, bn, tile):
    """The sub-tiles a launch decodes from ``blockIdx.y`` cover every
    element of a (bm, bn) output tile exactly once, ragged edges too, with
    origins on the tile and extents that are multiples of 8 (a thread's
    4-wide vectors lie wholly inside or outside)."""
    n_sub = _launch.product_grid(1, bm, bn, PER_SM["float32"], SMS,
                                 tile=tile, core="cuda")["sub_tiles"]
    seen = np.zeros((bm, bn), dtype=np.int64)
    for index in range(n_sub):
        i0, j0, i_lim, j_lim = _launch.sub_tile(index, bm, bn, tile)
        assert i0 % tile == 0 and j0 % tile == 0
        assert 0 < i_lim <= tile and 0 < j_lim <= tile
        assert i_lim % 8 == 0 and j_lim % 8 == 0
        seen[i0:i0 + i_lim, j0:j0 + j_lim] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("n,bn", [(256, 256), (2560, 256), (10240, 256),
                                  (816, 136), (800, 40), (64, 8)])
def test_syrk_grid_counts_packed_tiles(n, bn):
    """One block column per packed lower-triangular tile, T(T+1)/2 of
    them, and the kernel's decode of the column index walks exactly the
    lower triangle, row-major."""
    t_blocks = n // bn
    shape = p_syrk._grid(n, bn, PER_SM["float32"], SMS, core="cuda")
    assert shape["tiles"] == t_blocks * (t_blocks + 1) // 2
    assert shape["blocks"] == shape["tiles"] * shape["sub_tiles"]
    ii, jj = p_syrk._tri_decode(torch.arange(shape["tiles"]))
    want = [(i, j) for i in range(t_blocks) for j in range(i + 1)]
    assert list(zip(ii.tolist(), jj.tolist())) == want


@pytest.mark.parametrize("kernel,n,tile,blocks,waves", [
    ("matmul", 10240, 128, 6400, 6400 / 264),
    ("matmul", 10240, 64, 25600, 25600 / 528),
    ("matmul", 2560, 128, 400, 400 / 264),
    ("matmul", 2560, 64, 1600, 1600 / 528),
    ("syrk", 10240, 128, 3280, 3280 / 264),
    ("syrk", 10240, 64, 13120, 13120 / 528),
    ("syrk", 2560, 128, 220, 220 / 264),
    ("syrk", 2560, 64, 880, 880 / 528),
])
def test_blocks_and_waves_at_the_main_path(kernel, n, tile, blocks, waves):
    """At blocks of 256: the 10240^2 operands of ``ops.matmul`` and
    ``ops.syrk`` and the reference recursion's 2560^2 leaf, with two
    blocks an SM at tile 128 and four at 64 on 132 SMs.  The default is
    tile 128 at all four (the leaf: 400 blocks fill 264 slots, 1.52
    waves)."""
    per_sm = PER_SM["float32"]
    grid = (lambda t: p_matmul._grid(n, n, 256, 256, per_sm, SMS, t,
                                     core="cuda")) \
        if kernel == "matmul" else \
        (lambda t: p_syrk._grid(n, 256, per_sm, SMS, t, core="cuda"))
    shape = grid(tile)
    assert shape["blocks"] == blocks
    assert shape["sub_tiles"] == (256 // tile) ** 2
    assert shape["waves"] == pytest.approx(waves)
    assert shape["blocks_per_sm"] == per_sm[tile] and shape["sms"] == SMS
    assert grid(None)["tile"] == 128


@pytest.mark.parametrize("tile", [None, *_launch.PRODUCT_TILES])
def test_tile_argument_on_the_cpu_matches_jax(tile):
    """The wrappers take ``tile`` on the CPU, where the plain version
    runs, and match the JAX package's kernel (1e-5 of max|out|)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((136, 272)).astype(np.float32)
    b = rng.standard_normal((272, 136)).astype(np.float32)
    want = np.asarray(jax_matmul.matmul_padded(
        jnp.asarray(a), jnp.asarray(b), bm=136, bk=136, bn=136,
        interpret=True), dtype=np.float64)
    got = p_matmul.matmul_padded(torch.from_numpy(a), torch.from_numpy(b),
                                 bm=136, bk=136, bn=136, tile=tile)
    assert np.abs(got.double().numpy() - want).max() \
        <= 1e-5 * np.abs(want).max()
    stack = p_syrk.syrk_packed(torch.from_numpy(a), bk=136, bn=136,
                               tile=tile)
    a64 = a.astype(np.float64)
    gram = a64.T @ a64
    for t, (i, j) in enumerate([(0, 0), (1, 0), (1, 1)]):
        block = gram[i * 136:(i + 1) * 136, j * 136:(j + 1) * 136]
        assert np.abs(stack[t * 136:(t + 1) * 136].double().numpy()
                      - block).max() <= 1e-5 * np.abs(gram).max()


@pytest.mark.parametrize("call", [
    lambda: p_matmul.matmul_padded(torch.ones(8, 8), torch.ones(8, 8), bm=8,
                                   bk=8, bn=8, tile=96),
    lambda: p_syrk.syrk_packed(torch.ones(8, 8), bk=8, bn=8, tile=32),
])
def test_wrappers_refuse_an_unknown_tile(call):
    with pytest.raises(ValueError, match="tile"):
        call()
