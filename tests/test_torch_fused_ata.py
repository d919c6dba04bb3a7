"""The port's fused ata executor, run as its plain version on the CPU.

Held against the JAX package's fused executor in interpret mode (a few
cases: interpret mode is slow), against the float64 oracles
``np.tril(a.T @ a)`` and JAX ``leaf_ir.interpret_program`` over the
algebra x gram x levels grid, and against the JAX host-side contracts
(fan-in clamp, pipeline depth range, traffic model).  The CUDA kernel
itself is held against this plain version on the card by
``chip_smoke.py``.  Tolerances are those of tests/test_fused_ata.py:
1e-5 of max|C| in fp32, 1e-4 where that file uses it, 3e-2 for bf16
input.
"""
import warnings

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.core import leaf_ir as jax_ir
from repro.kernels import strassen_fused as jax_sf
from repro_torch.kernels import strassen_fused as sf


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
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


def _oracle(a):
    af = np.asarray(a, np.float64)
    return np.tril(af.T @ af)


@pytest.mark.parametrize("m,n,block,levels,variant,gram", [
    (257, 511, 64, 0, "strassen", "strassen"),
    (257, 511, 64, 1, "strassen", "strassen"),
    (257, 511, 64, 2, "strassen", "strassen"),
    (257, 511, 64, 3, "strassen", "strassen"),
    (512, 512, 128, 2, "strassen", "strassen"),
    (257, 511, 64, 2, "winograd", "strassen"),
    (257, 511, 64, 2, "strassen", "dps"),
])
def test_plain_executor_matches_jax_interpret(pallas_compiler_params, m, n,
                                              block, levels, variant, gram):
    a = _rand((m, n), seed=levels + m)
    kw = dict(levels=levels, variant=variant, gram=gram, bk=block, bn=block)
    want, n_pad_j = jax_sf.fused_ata_packed(jnp.asarray(a), interpret=True,
                                            **kw)
    got, n_pad = sf.fused_ata_packed(torch.from_numpy(a), device="cpu", **kw)
    assert tuple(got.shape) == tuple(want.shape) and n_pad == n_pad_j
    want = np.asarray(want, np.float64)
    assert _rel(got.numpy(), want) <= 1e-5
    dense = sf.fused_ata(torch.from_numpy(a), device="cpu", **kw)
    assert dense.shape == (n, n)
    assert _rel(dense.numpy(), _oracle(a)) <= 1e-5


@pytest.mark.parametrize("levels", [0, 1, 2, 3])
@pytest.mark.parametrize("gram", ["strassen", "dps"])
@pytest.mark.parametrize("variant", ["strassen", "winograd", "classical"])
def test_plain_executor_matches_float64_oracles(variant, gram, levels):
    a = _rand((57, 48), seed=levels)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the fan-in clamp's warning
        got = sf.fused_ata(torch.from_numpy(a), levels=levels,
                           variant=variant, gram=gram, bk=8, bn=8,
                           device="cpu")
    assert _rel(got.numpy(), _oracle(a)) <= 1e-5
    assert np.abs(np.triu(got.numpy(), 1)).max() == 0.0
    # the JAX interpreter on the program the executor ran (clamped level)
    lv = sf._ata_geometry(57, 48, levels, variant, 8, 8, gram=gram)["levels"]
    prog = jax_ir.compile_program("ata", lv, variant, gram=gram)
    b = 2 ** lv
    ap = np.zeros((-(-57 // (8 * b)) * 8 * b, -(-48 // (8 * b)) * 8 * b))
    ap[:57, :48] = a
    want = jax_ir.interpret_program(prog, ap)[:48, :48]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_bf16_input_gives_fp32_output():
    a = _rand((128, 64), seed=3)
    ab = torch.from_numpy(a).to(torch.bfloat16)
    got = sf.fused_ata(ab, levels=2, bk=16, bn=16, device="cpu")
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), _oracle(ab.float().numpy())) < 3e-2
    got16 = sf.fused_ata(ab, levels=1, bk=16, bn=16,
                         out_dtype=torch.bfloat16, device="cpu")
    assert got16.dtype == torch.bfloat16
    # bf16 operand tiles from an fp32 input: the quantized float64 oracle
    q = sf.fused_ata(torch.from_numpy(a), levels=2, bk=16, bn=16,
                     operand_dtype=torch.bfloat16, device="cpu")
    assert _rel(q.numpy(), _oracle(ab.float().numpy())) <= 1e-5


def test_fan_in_clamp_matches_jax():
    """winograd at levels 3 clamps to the same level as in JAX, with one
    warning per distinct clamp."""
    sf._CLAMP_WARNED.clear()
    jax_sf._CLAMP_WARNED.clear()
    for mod in (sf, jax_sf):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            geo = mod._ata_geometry(1 << 12, 1 << 12, 3, "winograd", 256,
                                    256)
            mod._ata_geometry(1 << 12, 1 << 12, 3, "winograd", 256, 256)
        msgs = [str(w.message) for w in caught
                if "MAX_OPERAND_TERMS" in str(w.message)]
        assert len(msgs) == 1 and "clamped to levels=2" in msgs[0]
        assert geo["levels"] == 2
        assert geo["plan"].max_terms <= mod.MAX_OPERAND_TERMS
    assert sf._ata_geometry(1 << 12, 1 << 12, 3, "strassen", 256,
                            256)["levels"] == 3


def test_pipeline_depth_accepted_and_bounded():
    a = torch.from_numpy(_rand((40, 24), seed=5))
    outs = [sf.fused_ata(a, levels=2, bk=8, bn=8, pipeline_depth=d,
                         device="cpu") for d in (1, 2, 3)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    with pytest.raises(ValueError):
        sf.fused_ata(a, levels=2, bk=8, bn=8, pipeline_depth=5, device="cpu")


@pytest.mark.parametrize("m,n,block,levels", [(257, 511, 64, 2),
                                              (512, 512, 128, 2),
                                              (10000, 10000, 256, 2)])
def test_traffic_model_matches_jax(m, n, block, levels):
    kw = dict(levels=levels, bk=block, bn=block)
    assert sf.ata_traffic_model(m, n, **kw) == \
        jax_sf.ata_traffic_model(m, n, **kw)


def test_unported_knobs_raise(pallas_compiler_params):
    """The knobs this test once found refused run now, against the JAX
    executor on the same input: fp8 operand tiles, a bf16 accumulator
    (its rounding within 2^-7 of max|C|) and stochastic rounding (a bf16
    output only); the JAX package's ValueErrors stay."""
    a_np = _rand((16, 16), seed=1)
    a = torch.from_numpy(a_np)
    kw = dict(levels=1, bk=8, bn=8)
    got = sf.fused_ata(a, operand_dtype="float8_e4m3fn", device="cpu", **kw)
    want = jax_sf.fused_ata(jnp.asarray(a_np), interpret=True,
                            operand_dtype="float8_e4m3fn", **kw)
    assert _rel(got.numpy(), np.asarray(want, np.float64)) <= 1e-5
    with pytest.raises(ValueError):
        sf.fused_ata(a, operand_dtype="int8", device="cpu")
    got = sf.fused_ata(a, acc_dtype=torch.bfloat16, device="cpu", **kw)
    want = jax_sf.fused_ata(jnp.asarray(a_np), interpret=True,
                            acc_dtype="bfloat16", **kw)
    assert _rel(got.numpy(), np.asarray(want, np.float64)) <= 2.0 ** -7
    with pytest.raises(ValueError, match="bfloat16"):
        sf.fused_ata(a, sr_seed=0, device="cpu")
    sr = sf.fused_ata(a, sr_seed=0, out_dtype=torch.bfloat16, device="cpu")
    assert sr.dtype == torch.bfloat16
    assert _rel(sr.float().numpy(), _oracle(a_np)) <= 2.0 ** -7
    # the gradient flows through the fused path (the symm kind)
    x = a.clone().requires_grad_()
    (g,) = torch.autograd.grad(sf.fused_ata(x, device="cpu").sum(), x)
    assert g.shape == x.shape and bool(torch.isfinite(g).all())
    with torch.no_grad():
        sf.fused_ata(a.clone().requires_grad_(), bk=8, bn=8, device="cpu")
