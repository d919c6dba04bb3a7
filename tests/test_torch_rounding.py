"""The port's rounding, held against the JAX package on the CPU.

The fp64 accumulator against the JAX executor under x64; the rounding
points the TPU kernel's destination walk shares with the op walk; the
element types the card's wrapper takes; the stochastic rounding's bits
against the JAX package's given the same noise, its determinism, its
mean and its straight-through gradient.  The quantizer and the operand
types are in ``tests/test_torch_precision.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.kernels import strassen_fused as jax_sf
from repro_torch.core import ata
from repro_torch.kernels import _launch, ops, strassen_fused as sf


@pytest.fixture(autouse=True)
def _one_torch_thread():
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
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


def test_fp64_accumulator_matches_jax_x64(pallas_compiler_params):
    a = _rand((40, 24), 7).astype(np.float64)
    kw = dict(levels=1, bk=8, bn=8, acc_dtype="float64")
    got = sf.fused_ata(torch.from_numpy(a), device="cpu", **kw)
    assert got.dtype == torch.float64
    with jax.enable_x64(True):
        want = np.asarray(jax_sf.fused_ata(jnp.asarray(a), interpret=True,
                                           **kw))
    assert want.dtype == np.float64
    assert _rel(got.numpy(), want) <= 1e-5
    # fp64 input, fp32 default accumulator: fp64 output of fp32 arithmetic
    out = ata(torch.from_numpy(a), mode="fused", device="cpu")
    assert out.dtype == torch.float64
    assert _rel(out.numpy(), np.tril(a.T @ a)) <= 1e-5


@pytest.mark.parametrize("levels", [0, 1])
@pytest.mark.parametrize("acc, value", [("float64", 2 + 2.0 ** -29),
                                        ("float32", 2.0)])
@pytest.mark.parametrize("kind", ["ata", "aat"])
def test_fp64_accumulator_keeps_what_fp32_loses(pallas_compiler_params, kind,
                                                acc, value, levels):
    """K blocks whose parts are 1 and 2^-30 in turn: summed in fp64 the
    2^-30s stay, summed in fp32 they are lost.  The port gives the JAX
    executor's bits under x64 either way."""
    a = np.zeros((4 * 8, 16))
    a[0::16], a[8::16] = 1.0, 2.0 ** -15
    x = a if kind == "ata" else a.T.copy()
    kw = dict(levels=levels, acc_dtype=acc)
    kw.update(bk=8, bn=8) if kind == "ata" else kw.update(bm=8, bk=8)
    port = sf.fused_ata if kind == "ata" else sf.fused_aat
    ref = jax_sf.fused_ata if kind == "ata" else jax_sf.fused_aat
    got = port(torch.from_numpy(x), device="cpu", **kw).numpy()
    with jax.enable_x64(True):
        want = np.asarray(ref(jnp.asarray(x), interpret=True, **kw))
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.tril(np.full((16, 16), value)))


def test_kernel_path_takes_every_type():
    """What the card's wrapper checks before a launch: the dtype codes of
    every operand type, seed and output, and the argument check that
    once refused an fp16 or fp64 operand or output (it raised TypeError
    for anything but fp32 and bf16)."""
    assert {_launch.LEAF_DTYPE_CODES[t] for t in (
        torch.float32, torch.bfloat16, torch.float16, torch.float8_e4m3fn,
        torch.float8_e5m2, torch.float64)} == set(range(6))
    assert _launch.ACC_CODES == {"float32": 0, "bfloat16": 1, "float64": 2}
    a = torch.zeros(32, 16)
    for dt in (torch.float16, torch.float64, torch.float8_e4m3fn):
        spec, ap = sf._prepare_ata(a.to(dt) if dt != torch.float8_e4m3fn
                                   else a, 1, "strassen", "strassen", 8, 8,
                                   operand_dtype=None if dt !=
                                   torch.float8_e4m3fn else dt)
        for out in (torch.float32, torch.float16, torch.float64,
                    torch.bfloat16):
            sf._check_kernel_args(spec, ap, ap, out, None, None)
    with pytest.raises(TypeError):
        sf._check_kernel_args(spec, ap, ap, torch.int32, None, None)
    with pytest.raises(TypeError):
        ai = torch.zeros(spec.n_k * spec.bc * 2, 16, dtype=torch.int32)
        sf._check_kernel_args(spec, ai, ai, torch.float32, None, None)
    # the stored types: fp64 as fp32, a pair no library has as fp32
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    assert sf._kernel_types(torch.float64, torch.float64, "float32") == \
        (f32, f32)
    assert sf._kernel_types(f16, f32, "float32") == (f32, f32)
    assert sf._kernel_types(f32, bf16, "float32") == (f32, bf16)
    assert sf._kernel_types(f32, bf16, "bfloat16") == (f32, f32)
    assert sf._products_library("float32", f16) == "leaf_products_lowp"
    assert sf._products_library("float64", f32) == "leaf_products_acc"
    assert sf._products_library("float32", bf16) == "leaf_products"
    # fp8 tiles 40 columns wide are stored 48 wide, so that every TMA box
    # starts on 16 bytes and every row is a multiple of 16 bytes
    x = sf._quantize(torch.randn(8, 120), torch.float8_e4m3fn)
    wide, pitch = sf._tma_layout(x, 40)
    assert pitch == 48 and wide.shape == (8, 144) and wide.dtype == x.dtype
    tiles = wide.view(torch.uint8).reshape(8, 3, 48)
    assert torch.equal(tiles[:, :, :40].reshape(8, 120),
                       x.view(torch.uint8))
    assert not tiles[:, :, 40:].any()
    stack, _ = sf._tma_layout(x[:, :40].contiguous(), None)   # a tri stack
    assert stack.shape == (8, 48)
    assert sf._tma_layout(x[:, :96].contiguous(), 48)[1] == 48
    kept, pitch = sf._tma_layout(torch.zeros(8, 40), 40)     # not fp8
    assert pitch == 40 and kept.shape == (8, 40)


def test_destination_walk_follows_the_accumulator():
    """The TPU kernel's walk (the oracle the card's kernel is also held
    against) rounds where the op walk does, to within their reordering:
    bf16 within 2^-7, fp64 within 1e-6."""
    a = torch.from_numpy(_rand((64, 48), 3))
    for acc, bar in (("bfloat16", 2.0 ** -7), ("float64", 1e-6)):
        for gram in ("strassen", "dps"):
            spec, ap = sf._prepare_ata(a, 2, "strassen", gram, 8, 8,
                                       acc_dtype=acc)
            ops_ = sf._leaf_products_plain(spec, ap, ap, torch.float64)
            walk = sf._leaf_program_plain(spec, sf._spec_tables(spec, "cpu"),
                                          ap, ap, torch.float64)
            assert _rel(ops_.numpy(), walk.numpy()) <= bar


def test_sr_apply_bit_equal_to_jax():
    """Given the same 16-bit noise, the port's rounding gives the JAX
    package's bits: negatives, carries into the exponent (and to inf),
    subnormals, non-finite values."""
    rng = np.random.default_rng(4)
    x = np.concatenate([
        rng.standard_normal(2000).astype(np.float32) * 3,
        np.array([1 + 2 ** -8 - 2 ** -20, -(1 + 2 ** -8 - 2 ** -20),
                  (2 - 2 ** -23), -(2 - 2 ** -23), 3.3895e38, -3.3895e38,
                  1e-40, -1e-40, 0.0, -0.0, np.inf, -np.inf, np.nan,
                  -np.nan], np.float32)])
    bits = rng.integers(0, 1 << 16, x.shape).astype(np.uint16)
    bits[2000:2008] = 0xFFFF
    want = np.asarray(jax_sf._sr_apply(jnp.asarray(x), jnp.asarray(bits)))
    got = sf._sr_apply(torch.from_numpy(x),
                       torch.from_numpy(bits.astype(np.int32)))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                          want.view(np.uint16))


def test_sr_deterministic_per_seed():
    a = torch.from_numpy(_rand((96, 64), 9))
    kw = dict(levels=1, bk=32, bn=32, out_dtype=torch.bfloat16,
              device="cpu")
    o1 = ops.ata_fused(a, sr_seed=7, **kw)
    o2 = ops.ata_fused(a, sr_seed=7, **kw)
    o3 = ops.ata_fused(a, sr_seed=8, **kw)
    assert o1.dtype == torch.bfloat16
    assert torch.equal(o1, o2) and not torch.equal(o1, o3)
    # every output a bf16 neighbour of the fp32 result
    core = ops.ata_fused(a, levels=1, bk=32, bn=32, device="cpu")
    assert (o1.float() - core).abs().max() <= \
        core.abs().max() * 2.0 ** -7


def test_sr_mean_unbiased():
    """The JAX suite's bar (``tests/test_properties.py``): a value 1/8 of
    the way between two bf16 neighbours rounds up about 1/8 of the time,
    so the mean of 2^14 draws sits within 1e-4 of it."""
    val = 1.0 + 2.0 ** -10
    xs = torch.full((1 << 14,), val)
    r = sf.stochastic_round_bf16(xs, torch.Generator().manual_seed(0)) \
        .double()
    assert set(r.unique().tolist()) == {1.0, 1.0 + 2.0 ** -7}
    assert abs(float(r.mean()) - val) < 1e-4


def test_sr_gradient_straight_through():
    x = torch.from_numpy(_rand((4, 5), 1)).requires_grad_()
    g = torch.from_numpy(_rand((4, 5), 2)).to(torch.bfloat16)
    out = sf.stochastic_round_bf16(x, torch.Generator().manual_seed(1))
    (dx,) = torch.autograd.grad(out, x, g)
    assert dx.dtype == torch.float32 and torch.equal(dx, g.float())
    # through the entry: the fp32 core's gradient on the same cotangent
    a = torch.from_numpy(_rand((48, 32), 3))
    kw = dict(levels=1, bk=16, bn=16, device="cpu")
    x = a.clone().requires_grad_()
    out = sf.fused_ata(x, out_dtype=torch.bfloat16, sr_seed=3, **kw)
    gb = torch.from_numpy(_rand(tuple(out.shape), 4)).to(torch.bfloat16)
    (got,) = torch.autograd.grad(out, x, gb)
    x = a.clone().requires_grad_()
    (want,) = torch.autograd.grad(sf.fused_ata(x, **kw), x, gb.float())
    assert torch.equal(got, want)
