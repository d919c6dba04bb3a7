"""fp16 operands in the port's single-purpose kernels (syrk, matmul,
combine, flash attention), run as their plain versions on the CPU and
held against the JAX package, which takes fp16 through ``jnp.dot`` with
an fp32 accumulator and returns the promoted dtype.

The same inputs, made with numpy from a seed, go through the JAX package
(Pallas in interpret mode; syrk under the per-test ``TPUCompilerParams``
alias) and through the port with ``device="cpu"``.  The CUDA kernels'
fp16 instantiations are held against these plain versions on the card
by ``chip_smoke.py`` (phase 3l).

Tolerances, of max|out| of the JAX result:
- an fp16 output of a product (matmul, syrk, the recursion): 2^-10,
  one fp16 rounding of the largest element (the fp32 sums run in
  another order, so an element may round to its other neighbour);
- an fp32 output (mixed operands promote to fp32): 1e-5;
- combine: bit-equal (every add rounded in fp16, in the same order);
- flash attention: 2^-9, the fp16 output's rounding plus ``p`` rounded
  to fp16 before ``P V`` at other kv tiles (512 in the JAX package, 128
  in the port's kernel).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import repro.core as jax_core
from repro.kernels import ops as jax_ops
from repro_torch.core import ata
from repro_torch.kernels import _launch, ops

p_fa = importlib.import_module("repro_torch.kernels.flash_attention")

F16_BAR, F32_BAR, FLASH_F16_BAR = 2.0 ** -10, 1e-5, 2.0 ** -9


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
    ``CompilerParams``; the JAX syrk kernel still uses the old name.
    Alias it for the duration of one test only."""
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)


def _both(shape, seed, dtype="float16"):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (both round fp32 to the nearest even)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(getattr(jnp, dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))


def _check(got, want, bar):
    """``got`` (torch) against ``want`` (JAX): same shape and dtype, and
    within ``bar`` of max|want|."""
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    g = got.double().numpy()
    w = np.asarray(want).astype(np.float64)
    assert np.abs(g - w).max() <= bar * max(np.abs(w).max(), 1.0)


@pytest.mark.parametrize("m,k,n", [(32, 32, 32), (100, 70, 50),
                                   (257, 129, 65), (16, 512, 16)])
def test_matmul_fp16_matches_jax(m, k, n):
    (ja, ta), (jb, tb) = _both((m, k), 1), _both((k, n), 2)
    want = jax_ops.matmul(ja, jb, bm=32, bk=32, bn=32, interpret=True)
    got = ops.matmul(ta, tb, bm=32, bk=32, bn=32, device="cpu")
    assert got.dtype == torch.float16
    _check(got, want, F16_BAR)


@pytest.mark.parametrize("dta,dtb", [("float16", "bfloat16"),
                                     ("bfloat16", "float16"),
                                     ("float16", "float32"),
                                     ("float32", "float16")])
def test_matmul_mixed_operands_promote_as_jax(dta, dtb):
    """fp16 with bf16 gives fp32, as ``jnp.promote_types``; fp16 with fp32
    gives fp32."""
    (ja, ta), (jb, tb) = _both((64, 48), 3, dta), _both((48, 40), 4, dtb)
    want = jax_ops.matmul(ja, jb, bm=16, bk=16, bn=16, interpret=True)
    got = ops.matmul(ta, tb, bm=16, bk=16, bn=16, device="cpu")
    assert got.dtype == torch.float32 == torch.promote_types(ta.dtype,
                                                             tb.dtype)
    _check(got, want, F32_BAR)


@pytest.mark.parametrize("out_dtype", ["float16", "float32", "bfloat16"])
def test_matmul_padded_fp16_output(out_dtype):
    """``matmul_padded`` rounds the fp32 accumulator once into any of the
    three output types, fp16 included."""
    (ja, ta), (jb, tb) = _both((64, 32), 5), _both((32, 48), 6, "float32")
    p_matmul = importlib.import_module("repro_torch.kernels.matmul")
    j_matmul = importlib.import_module("repro.kernels.matmul")
    want = j_matmul.matmul_padded(ja, jb, bm=16, bk=16, bn=16,
                                  out_dtype=getattr(jnp, out_dtype),
                                  interpret=True)
    got = p_matmul.matmul_padded(ta, tb, bm=16, bk=16, bn=16,
                                 out_dtype=getattr(torch, out_dtype))
    _check(got, want, F32_BAR if out_dtype == "float32" else
           2.0 ** -8 if out_dtype == "bfloat16" else F16_BAR)


@pytest.mark.parametrize("m,n", [(64, 64), (100, 40), (33, 65), (256, 128)])
def test_syrk_fp16_matches_jax(pallas_compiler_params, m, n):
    ja, ta = _both((m, n), 7)
    want = jax_ops.syrk(ja, bk=32, bn=32, interpret=True)
    got = ops.syrk(ta, bk=32, bn=32, device="cpu")
    assert got.dtype == torch.float16
    _check(got, want, F16_BAR)
    want = jax_ops.syrk_packed(ja, bk=32, bn=32, interpret=True)
    got = ops.syrk_packed(ta, bk=32, bn=32, device="cpu")
    _check(got, want, F16_BAR)


@pytest.mark.parametrize("m,n", [(64, 64), (32, 96), (100, 50), (256, 256)])
def test_combine_fp16_bit_equal_to_jax(m, n):
    pairs = [_both((m, n), 10 + i) for i in range(7)]
    want = jax_ops.strassen_combine(*(j for j, _ in pairs), bm=32, bn=32,
                                    interpret=True)
    got = ops.strassen_combine(*(t for _, t in pairs), bm=32, bn=32,
                               device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == torch.float16
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("b,sq,skv,h,hkv,d,kw", [
    (2, 64, 64, 4, 4, 32, {}),
    (2, 64, 64, 8, 2, 32, {}),
    (1, 128, 128, 4, 1, 16, {}),
    (1, 160, 160, 4, 2, 64, {"window": 40}),
    (1, 64, 64, 2, 2, 32, {"softcap": 30.0}),
])
def test_flash_fp16_matches_jax(b, sq, skv, h, hkv, d, kw):
    """``flash_mha`` on (B, S, H, D) fp16 operands: fp16 out, as the JAX
    kernel's q dtype, at fp16's bar."""
    jq, tq = _both((b, sq, h, d), 20)
    jk, tk = _both((b, skv, hkv, d), 21)
    jv, tv = _both((b, skv, hkv, d), 22)
    want = jax_ops.flash_mha(jq, jk, jv, interpret=True, **kw)
    got = ops.flash_mha(tq, tk, tv, device="cpu", **kw)
    assert got.dtype == torch.float16
    _check(got, want, FLASH_F16_BAR)


def test_flash_fp16_runs_the_tensor_core_tiles():
    """fp16 takes bf16's tiles (the tensor-core kernel's), which the plain
    version's online softmax follows; fp32 keeps kv tiles of 64 (its q
    tile is 128 rows)."""
    for d in p_fa.HEAD_DIMS:
        assert p_fa.kv_tile(torch.float16, d) == \
            p_fa.kv_tile(torch.bfloat16, d)
        assert p_fa.q_tile(torch.float16, d) == \
            p_fa.q_tile(torch.bfloat16, d) == 128
    assert p_fa.kv_tile(torch.float32, 128) == 64
    assert p_fa.q_tile(torch.float32, 128) == 128
    # mixed dtypes stay refused: the kernel takes q, k and v of one dtype
    q = torch.zeros(1, 2, 32, 32, dtype=torch.float16)
    with pytest.raises(TypeError, match="one dtype"):
        p_fa.flash_attention(q, q.bfloat16(), q)


@pytest.mark.parametrize("levels", [0, 1, 2])
def test_ata_fp16_with_kernel_leaves_matches_jax(pallas_compiler_params,
                                                 levels):
    """The reference recursion on fp16 A with every leaf a kernel's plain
    version: fp32 out (the promoted dtype), as the JAX package's."""
    ja, ta = _both((130, 75), 40 + levels)
    from repro.kernels import pallas_base_matmul, pallas_base_syrk
    want = jax_core.ata(
        ja, levels=levels, leaf=32,
        base_syrk=pallas_base_syrk(bk=32, bn=32, interpret=True),
        base_matmul=pallas_base_matmul(32, 32, 32, interpret=True))
    before = dict(_launch.KERNEL_LAUNCHES)
    got = ata(ta, levels=levels, leaf=32,
              base_syrk=ops.kernel_base_syrk(32, 32),
              base_matmul=ops.kernel_base_matmul(32, 32, 32), device="cpu")
    _check(got, want, F16_BAR)
    assert _launch.KERNEL_LAUNCHES == before
    # the default hooks' blocks too
    got = ata(ta, levels=levels, leaf=32, base_syrk=ops.kernel_base_syrk(),
              base_matmul=ops.kernel_base_matmul(), device="cpu")
    _check(got, want, F16_BAR)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float8_e4m3fn,
                                   torch.int32])
def test_other_types_stay_refused(dtype):
    """fp64, fp8 and integer operands stay refused with TypeError (the
    deliberate differences on record), before any padding or launch."""
    x = torch.ones(8, 8).to(dtype)
    p_matmul = importlib.import_module("repro_torch.kernels.matmul")
    p_syrk = importlib.import_module("repro_torch.kernels.syrk")
    p_combine = importlib.import_module("repro_torch.kernels.combine")
    for call in (lambda: p_matmul.matmul_padded(x, x, bm=8, bk=8, bn=8),
                 lambda: p_syrk.syrk_packed(x, bk=8, bn=8),
                 lambda: p_combine.strassen_combine(*[x] * 7, bm=8, bn=8),
                 lambda: p_fa.flash_attention(*[x.view(1, 1, 8, 8)] * 3)):
        with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
            call()
