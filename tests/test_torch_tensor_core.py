"""The tensor-core core of the port's syrk and matmul kernels
(``csrc/tile_product_tc.cuh``): which operand types run on it, the tile
its launches take, their waves, and the order its blocks walk the output.

The kernels run only on the card, where ``chip_smoke.py`` holds them
against their plain versions at both block tiles (phases 3f, 3g, 3l) and
checks that the C side picks the core ``_launch.product_core`` names.
What surrounds them is pure Python and runs here.  The plain version the
16-bit pairs are held against on the card matches the JAX package's
kernel, which takes 16-bit tiles through ``jnp.dot`` with an fp32
accumulator (2^-10 of max|out| for an fp16 output, 2^-8 for bf16: one
rounding of the largest element; 1e-5 for an fp32 output).
"""
import importlib
import itertools
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
F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
# blocks an SM at each tile, as the card's occupancy query gives them for
# each core's launch bounds and shared memory (chip_smoke.py, phase 5)
PER_SM = {"tensor": {128: 1, 64: 3}, "cuda": {128: 2, 64: 4}}
BARS = {F32: 1e-5, BF16: 2.0 ** -8, F16: 2.0 ** -10}


@pytest.mark.parametrize("a,b", list(itertools.product((F32, BF16, F16),
                                                       repeat=2)))
def test_product_core_by_operand_types(a, b):
    """Both operands of one 16-bit type run on the tensor cores; fp32 and
    every mixed pair on the CUDA cores.  The output type plays no part."""
    want = "tensor" if a == b and a != F32 else "cuda"
    assert _launch.product_core(a, b) == want


def test_product_core_refuses_other_types():
    with pytest.raises(TypeError, match="float16"):
        _launch.product_core(torch.float64, torch.float64)


# (kernel, padded operand edge, K or M, block edge, output tiles, the tile
# each core picks): ops.matmul / ops.syrk at 10240^2, the recursion's
# 2560^2 leaf, and the 2560 x 256 leaves of a 10000 x 777 A (syrk on
# 2560 x 256, matmul 256 x 2560 @ 2560 x 256)
MAIN_PATH = [
    ("matmul", 10240, 256, 1600, {"tensor": 128, "cuda": 128}),
    ("syrk", 10240, 256, 820, {"tensor": 128, "cuda": 128}),
    ("matmul", 2560, 256, 100, {"tensor": 128, "cuda": 128}),
    ("syrk", 2560, 256, 55, {"tensor": 128, "cuda": 128}),
    ("matmul", 256, 256, 1, {"tensor": 64, "cuda": 64}),
    ("syrk", 256, 256, 1, {"tensor": 64, "cuda": 64}),
]


def _grid(kernel, n, block, per_sm, core, tile=None):
    if kernel == "matmul":
        return p_matmul._grid(n, n, block, block, per_sm, SMS, tile,
                              core=core)
    return p_syrk._grid(n, block, per_sm, SMS, tile, core=core)


@pytest.mark.parametrize("core", _launch.PRODUCT_CORES)
@pytest.mark.parametrize("kernel,n,block,tiles,picks", MAIN_PATH)
def test_tile_and_waves_at_the_main_path(kernel, n, block, tiles, picks,
                                         core):
    """Each core's tile at the main path's shapes, by the least busiest-SM
    cost at its own k-step cost, and its blocks and waves at one block an
    SM (tensor, tile 128) or two (CUDA cores)."""
    per_sm = PER_SM[core]
    shape = _grid(kernel, n, block, per_sm, core)
    assert shape["tile"] == picks[core] and shape["core"] == core
    assert shape["tiles"] == tiles
    for tile in _launch.PRODUCT_TILES:
        s = _grid(kernel, n, block, per_sm, core, tile)
        assert s["blocks"] == tiles * (block // tile) ** 2
        assert s["waves"] == pytest.approx(s["blocks"] / (SMS * per_sm[tile]))
        assert s["cost"] == math.ceil(s["blocks"] / SMS) \
            * _launch.STEP_COST[core][tile]
        assert s["cost"] >= shape["cost"]


def test_tensor_step_cost_is_the_bytes_a_step_moves():
    """A tensor-core block's k step moves 2 x TILE 16-bit elements from
    L2, so tile 128's step costs twice tile 64's; the 10240^2 matmul then
    takes tile 128 (49 busiest-SM blocks at 2 against 194 at 1)."""
    cost = _launch.STEP_COST["tensor"]
    assert cost[128] == 2 * cost[64]
    shape = _grid("matmul", 10240, 256, PER_SM["tensor"], "tensor")
    assert (shape["tile"], shape["cost"]) == (128, 98)
    with pytest.raises(ValueError, match="core"):
        _launch.product_grid(1, 256, 256, PER_SM["tensor"], SMS,
                             core="tensor cores")


@pytest.mark.parametrize("kernel", ["matmul", "syrk"])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_launch_shape_names_the_core(kernel, dtype, monkeypatch):
    """``*_launch_shape`` reports the core its operand types run on, with
    that core's blocks an SM and shared memory (the C entries, faked here
    as the card answers them)."""
    core = _launch.product_core(dtype, dtype)
    smem = {"tensor": {128: 132160, 64: 66624},
            "cuda": {128: 67584, 64: 34816}}[core]
    module = p_matmul if kernel == "matmul" else p_syrk
    monkeypatch.setattr(module, "_blocks_per_sm",
                        lambda *args: PER_SM[core][args[-1]])
    monkeypatch.setattr(_launch, "entry",
                        lambda *args: (lambda *codes: smem[codes[-1]]))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: type("P", (), {
                            "multi_processor_count": SMS}))
    if kernel == "matmul":
        shape = module.matmul_launch_shape(
            2560, 2560, bm=256, bn=256, a_dtype=dtype, b_dtype=dtype,
            out_dtype=F32, device="cpu")
    else:
        shape = module.syrk_launch_shape(2560, bn=256, a_dtype=dtype,
                                         out_dtype=F32, device="cpu")
    assert shape["core"] == core and shape["tile"] == 128
    assert shape["blocks_per_sm"] == PER_SM[core][128]
    assert shape["smem_bytes"] == smem[128]


@pytest.mark.parametrize("tile", _launch.PRODUCT_TILES)
@pytest.mark.parametrize("n_ti,n_tj,bm,bn", [
    (40, 40, 256, 256), (10, 10, 256, 256), (3, 5, 200, 136),
    (125, 70, 8, 8)])
def test_matmul_launch_order_covers_each_sub_tile_once(n_ti, n_tj, bm, bn,
                                                       tile):
    """The tensor-core matmul's grouped launch order visits every (output
    tile, sub-tile) of the grid exactly once, ``RASTER`` sub-tile rows at
    a time: block i lies in sub-tile rows of group i // (RASTER x the
    grid's sub-tile columns)."""
    n_sub_i, n_sub_j = -(-bm // tile), -(-bn // tile)
    got = [_launch.grouped_sub_tile(i, n_ti, n_tj, bm, bn, tile)
           for i in range(n_ti * n_tj * n_sub_i * n_sub_j)]
    want = [(ti, tj, *_launch.sub_tile(s, bm, bn, tile))
            for ti in range(n_ti) for tj in range(n_tj)
            for s in range(n_sub_i * n_sub_j)]
    assert sorted(got) == sorted(want)
    group = _launch.RASTER * n_tj * n_sub_j
    assert all((ti * n_sub_i + i0 // tile) // _launch.RASTER == i // group
               for i, (ti, _, i0, _, _, _) in enumerate(got))


@pytest.mark.parametrize("tile", _launch.PRODUCT_TILES)
@pytest.mark.parametrize("t_blocks,bn", [(40, 256), (10, 256), (6, 136),
                                         (98, 8)])
def test_syrk_launch_order_covers_each_packed_tile_once(t_blocks, bn, tile):
    """The tensor-core syrk's grouped launch order visits every lower
    packed tile (i >= j) and each of its sub-tiles exactly once."""
    n_sub = -(-bn // tile) ** 2
    got = [p_syrk._grouped_packed_tile(i, t_blocks, bn, tile)
           for i in range(t_blocks * (t_blocks + 1) // 2 * n_sub)]
    assert sorted(got) == [(i, j, s) for i in range(t_blocks)
                           for j in range(i + 1) for s in range(n_sub)]


@pytest.mark.parametrize("dtype", [BF16, F16])
@pytest.mark.parametrize("out_dtype", [None, F32])
def test_16bit_plain_version_matches_jax(dtype, out_dtype):
    """The plain version the tensor-core matmul is held against on the
    card, on 16-bit operands padded at ragged edges (K 136, not a multiple
    of the core's 64-deep chunk), against the JAX kernel in interpret
    mode."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal((136, 136)).astype(np.float32)
    b = rng.standard_normal((136, 272)).astype(np.float32)
    name = str(dtype).removeprefix("torch.")
    want = np.asarray(jax_matmul.matmul_padded(
        jnp.asarray(a, dtype=name), jnp.asarray(b, dtype=name), bm=136,
        bk=136, bn=136, out_dtype=None if out_dtype is None else jnp.float32,
        interpret=True).astype(jnp.float32), dtype=np.float64)
    got = p_matmul.matmul_padded(torch.from_numpy(a).to(dtype),
                                 torch.from_numpy(b).to(dtype), bm=136,
                                 bk=136, bn=136, out_dtype=out_dtype)
    assert got.dtype == (dtype if out_dtype is None else out_dtype)
    assert np.abs(got.double().numpy() - want).max() \
        <= BARS[got.dtype] * np.abs(want).max()
