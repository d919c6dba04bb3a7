"""The port's precision axes, held against the JAX package on the CPU.

The quantizer against ``jnp.astype`` bit for bit; each operand type and
kind of the fused path (the plain version here; the CUDA kernel is held
against it on the card by ``chip_smoke.py``) against the JAX executor in
interpret mode on the same input (<= 1e-5 of max|out|) and against the
quantized float64 oracle (<= 1e-4); an e4m3fn NaN where the JAX
executor has it; the bf16 accumulator within 2^-7 of the JAX
executor's output and no farther from float64 than 1.5 times its error.
The fp64 accumulator and stochastic rounding are in
``tests/test_torch_rounding.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.kernels import strassen_fused as jax_sf
from repro_torch.core.symmetry import pack_tril_blocks, unpack_tril_blocks
from repro_torch.gram.verify import default_rtol, freivalds_gram
from repro_torch.kernels import ops, strassen_fused as sf


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


OPERAND_TYPES = ["float16", "float8_e4m3fn", "float8_e5m2", "float64"]
BITS = {1: (np.uint8, torch.uint8), 2: (np.uint16, torch.int16),
        4: (np.uint32, torch.int32)}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


def _quantized(x, od):
    """The float64 values of ``x`` stored as ``od``, by ``jnp.astype``."""
    return np.asarray(jnp.asarray(x).astype(jnp.dtype(od))
                      .astype(jnp.float32), np.float64)


def _edge_values():
    """The edges of the quantizer: e4m3fn's tie at 464 and overflow past
    it, infinities, NaNs of both signs, subnormals, ties, zeros; and a
    wide-range sample."""
    edges = np.array([464, -464, 480, -480, 448, 449, 456, 463.99997,
                      464.00003, np.inf, -np.inf, np.nan, -np.nan,
                      2 ** -10, 3 * 2 ** -10, 2 ** -9 * 1.5, 2 ** -17,
                      2 ** -16 * 1.5, 1e-40, -1e-40, 2 ** -24, 65520, 65504,
                      57344, 61440, 1 + 2 ** -8, 1 + 3 * 2 ** -8, 0.0, -0.0,
                      3.0e38], np.float32)
    rng = np.random.default_rng(0)
    wide = rng.standard_normal(4096) * np.exp(rng.uniform(-30, 12, 4096))
    return np.concatenate([edges, wide.astype(np.float32)])


@pytest.mark.parametrize("od", OPERAND_TYPES + ["bfloat16", "float32"])
def test_quantize_bit_equal_to_jnp_astype(od):
    x = _edge_values()
    want = np.asarray(jnp.asarray(x).astype(jnp.dtype(od)))
    got = sf._quantize(torch.from_numpy(x), getattr(torch, od))
    if od == "float64":         # jax's x32 stores fp64 as fp32, as the port
        assert got.dtype == torch.float32
    np_bits, t_bits = BITS[want.dtype.itemsize]
    assert np.array_equal(got.view(t_bits).numpy().view(np_bits),
                          want.view(np_bits))


def test_torch_saturates_where_jax_gives_nan():
    """Why the port does not call ``.to`` alone for e4m3fn."""
    x = torch.tensor([480.0, 1000.0, float("inf")])
    assert torch.isfinite(x.to(torch.float8_e4m3fn).float()).all()
    assert torch.isnan(sf._quantize(x, torch.float8_e4m3fn).float()).all()


def _port_and_jax(kind, gram, od, acc="float32", seed=0):
    """One call of ``kind`` through the port (the plain version) and the
    JAX executor in interpret mode on the same small input; returns both
    outputs and the float64 oracle of the quantized operands."""
    a = _rand((40, 24), seed)
    aj, at = jnp.asarray(a), torch.from_numpy(a)
    port_kw = dict(levels=1, operand_dtype=od, acc_dtype=acc, device="cpu")
    jax_kw = dict(levels=1, operand_dtype=od, acc_dtype=acc, interpret=True)
    aq = _quantized(a, od) if od is not None else a.astype(np.float64)
    if kind == "ata":
        got = sf.fused_ata(at, gram=gram, bk=8, bn=8, **port_kw)
        want = jax_sf.fused_ata(aj, gram=gram, bk=8, bn=8, **jax_kw)
        oracle = np.tril(aq.T @ aq)
    elif kind == "aat":
        got = sf.fused_aat(at, gram=gram, bm=8, bk=8, **port_kw)
        want = jax_sf.fused_aat(aj, gram=gram, bm=8, bk=8, **jax_kw)
        oracle = np.tril(aq @ aq.T)
    elif kind == "rank_k":
        low = np.tril(_rand((24, 24), seed + 1))
        stack = np.asarray(pack_tril_blocks(torch.from_numpy(low), 8))
        got = sf.fused_rank_k_update(torch.from_numpy(stack), at, gram=gram,
                                     bk=8, **port_kw)
        want = jax_sf.fused_rank_k_update(jnp.asarray(stack), aj, gram=gram,
                                          bk=8, **jax_kw)
        oracle = low + np.tril(aq.T @ aq)
        got = torch.tril(unpack_tril_blocks(got, 24, 8, symmetrize=False))
        want = np.tril(np.asarray(unpack_tril_blocks(
            torch.from_numpy(np.array(want, np.float32)), 24, 8,
            symmetrize=False)))
    elif kind == "symm":
        low = np.tril(_rand((24, 24), seed + 1))
        stack = np.asarray(pack_tril_blocks(torch.from_numpy(low), 8))
        got = sf.fused_symm_matmul(at, torch.from_numpy(stack), bm=8,
                                   diag_sym=True, **port_kw)
        want = jax_sf.fused_symm_matmul(aj, jnp.asarray(stack), bm=8,
                                        diag_sym=True, **jax_kw)
        sq = _quantized(low, od) if od is not None else low
        oracle = aq @ (sq + sq.T)
    else:
        b = _rand((24, 32), seed + 1)
        got = sf.fused_matmul(at, torch.from_numpy(b), bm=8, bk=8, bn=8,
                              **port_kw)
        want = jax_sf.fused_matmul(aj, jnp.asarray(b), bm=8, bk=8, bn=8,
                                   **jax_kw)
        bq = _quantized(b, od) if od is not None else b
        oracle = aq @ bq
    return got, np.asarray(want, np.float64), oracle


KIND_GRAMS = [("ata", "strassen"), ("ata", "dps"), ("aat", "strassen"),
              ("aat", "dps"), ("rank_k", "strassen"), ("rank_k", "dps"),
              ("symm", "strassen"), ("matmul", "strassen")]


@pytest.mark.parametrize("od", OPERAND_TYPES)
@pytest.mark.parametrize("kind,gram", KIND_GRAMS)
def test_operand_types_match_jax(pallas_compiler_params, kind, gram, od):
    got, want, oracle = _port_and_jax(kind, gram, od)
    got = got.float().numpy()
    assert _rel(got, want) <= 1e-5
    assert _rel(got, oracle) <= 1e-4


@pytest.mark.parametrize("od", ["bfloat16", "float8_e4m3fn", "float8_e5m2",
                                "float16"])
def test_operand_tile_parity_512(od):
    """The JAX suite's bar (``tests/test_pipeline_precision.py``) on the
    port alone: within 1e-4 of the quantized float64 oracle, and the
    Freivalds identity against the original A at ``default_rtol(od)``."""
    a = torch.from_numpy(_rand((512, 512), 11))
    got = ops.ata_fused(a, levels=2, bk=128, bn=128, operand_dtype=od,
                        device="cpu").double().numpy()
    aq = sf._quantize(a, getattr(torch, od)).double().numpy()
    want = np.tril(aq.T @ aq)
    assert _rel(got, want) < 1e-4
    ok, err = freivalds_gram(a, got, probes=4, full=False,
                             rtol=default_rtol(od))
    assert ok, (od, err)


@pytest.mark.parametrize("kind,gram", [("ata", "strassen"), ("ata", "dps"),
                                       ("aat", "strassen"),
                                       ("rank_k", "strassen"),
                                       ("matmul", "strassen")])
def test_bf16_accumulator_matches_jax(pallas_compiler_params, kind, gram):
    got, want, oracle = _port_and_jax(kind, gram, None, acc="bfloat16",
                                      seed=5)
    got = got.float().numpy()
    assert _rel(got, want) <= 2.0 ** -7
    assert _rel(got, oracle) <= 1.5 * _rel(want, oracle)
    assert _rel(got, oracle) > 1e-5         # it really rounded in bf16


def test_e4m3_nan_pattern_matches_jax(pallas_compiler_params):
    """An input past e4m3fn's range is NaN once quantized, and Strassen's
    signed sums spread it through whole tiles: the NaNs of the port's
    output lie where the JAX executor's do."""
    a = _rand((40, 24), 9)
    a[13, 5] = 500.0
    kw = dict(levels=1, bk=8, bn=8, operand_dtype="float8_e4m3fn")
    got = sf.fused_ata(torch.from_numpy(a), device="cpu", **kw).numpy()
    want = np.asarray(jax_sf.fused_ata(jnp.asarray(a), interpret=True, **kw))
    assert np.isnan(want).any() and not np.isnan(want).all()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    assert _rel(got[fin], want[fin]) <= 1e-5
