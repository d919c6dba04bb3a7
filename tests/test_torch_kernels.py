"""The port's syrk, matmul, combine and transpose kernels and the
reference recursion's kernel leaves, run as their plain versions on the
CPU.

The port's counterpart of tests/test_kernels.py.  The same inputs, made
with numpy from a seed, go through the JAX package (Pallas in interpret
mode; syrk under the per-test ``TPUCompilerParams`` alias) and through
the port with ``device="cpu"``.  The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``.

Tolerances, of max|out| of the JAX result:
- fp32 products (matmul, syrk, the recursions): 1e-5 (the fp32 bar of
  the JAX fused suite; the sums run in another order);
- bf16 outputs: 2^-8 (one bf16 rounding);
- combine in fp32: 1e-6 (the same adds in the same order: 0 expected);
- transpose: exact.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import repro.core as jax_core
from repro.kernels import ops as jax_ops
from repro_torch.core import ata, strassen_matmul, tri_coords, tri_count
from repro_torch.kernels import _launch, ops, ref

# Both packages export the ops functions under the kernel modules' names
# (``kernels.matmul`` is the function), so the modules are reached
# through importlib.
jax_matmul, jax_syrk, jax_combine, jax_transpose = (
    importlib.import_module(f"repro.kernels.{name}")
    for name in ("matmul", "syrk", "combine", "transpose"))
p_matmul, p_syrk, p_combine, p_transpose = (
    importlib.import_module(f"repro_torch.kernels.{name}")
    for name in ("matmul", "syrk", "combine", "transpose"))

F32_BAR, BF16_BAR, COMBINE_F32_BAR = 1e-5, 2.0 ** -8, 1e-6

SHAPES_MM = [
    (32, 32, 32), (64, 128, 32), (100, 70, 50), (256, 256, 256),
    (257, 129, 65), (16, 512, 16),
]
SHAPES_SYRK = [(64, 64), (128, 32), (96, 96), (100, 40), (33, 65),
               (256, 128)]
SHAPES_2D = [(64, 64), (32, 96), (100, 50), (256, 256)]
DTYPES = ("float32", "bfloat16")


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


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (both round fp32 to bf16 to nearest even)."""
    return jnp.asarray(x).astype(getattr(jnp, dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy().astype(np.float64)
    return np.asarray(x).astype(np.float64)


def _check(got, want, bar):
    """``got`` (torch) against ``want`` (JAX): same shape and dtype, and
    within ``bar`` of max|want|."""
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    g, w = _np(got), _np(want)
    assert np.abs(g - w).max() <= bar * max(np.abs(w).max(), 1.0)


def _bar(dtype):
    return F32_BAR if dtype == "float32" else BF16_BAR


# -- the entry points of ops.py against the JAX package's ------------------

@pytest.mark.parametrize("m,k,n", SHAPES_MM)
@pytest.mark.parametrize("dtype", DTYPES)
def test_matmul_matches_jax(m, k, n, dtype):
    (ja, ta), (jb, tb) = (_both(_rand((m, k), 1), dtype),
                          _both(_rand((k, n), 2), dtype))
    want = jax_ops.matmul(ja, jb, bm=32, bk=32, bn=32, interpret=True)
    got = ops.matmul(ta, tb, bm=32, bk=32, bn=32, device="cpu")
    _check(got, want, _bar(dtype))


@pytest.mark.parametrize("m,n", SHAPES_SYRK)
@pytest.mark.parametrize("dtype", DTYPES)
def test_syrk_packed_matches_jax(pallas_compiler_params, m, n, dtype):
    ja, ta = _both(_rand((m, n), 3), dtype)
    want = jax_ops.syrk_packed(ja, bk=32, bn=32, interpret=True)
    got = ops.syrk_packed(ta, bk=32, bn=32, device="cpu")
    _check(got, want, _bar(dtype))


@pytest.mark.parametrize("m,n", SHAPES_SYRK)
def test_syrk_dense_matches_jax(pallas_compiler_params, m, n):
    ja, ta = _both(_rand((m, n), 4), "float32")
    for symmetrize in (False, True):
        want = jax_ops.syrk(ja, bk=32, bn=32, symmetrize=symmetrize,
                            interpret=True)
        got = ops.syrk(ta, bk=32, bn=32, symmetrize=symmetrize, device="cpu")
        _check(got, want, F32_BAR)
    assert torch.equal(got, got.T)


@pytest.mark.parametrize("m,n", SHAPES_2D)
@pytest.mark.parametrize("dtype", DTYPES)
def test_combine_matches_jax(m, n, dtype):
    pairs = [_both(_rand((m, n), 10 + i), dtype) for i in range(7)]
    want = jax_ops.strassen_combine(*(j for j, _ in pairs), bm=32, bn=32,
                                    interpret=True)
    got = ops.strassen_combine(*(t for _, t in pairs), bm=32, bn=32,
                               device="cpu")
    bar = COMBINE_F32_BAR if dtype == "float32" else BF16_BAR
    for g, w in zip(got, want, strict=True):
        _check(g, w, bar)
    for g, w in zip(got, ref.strassen_combine_ref(*(t for _, t in pairs))):
        assert torch.equal(g, w)


@pytest.mark.parametrize("m,n", [(32, 32), (64, 128), (100, 70), (257, 65)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_transpose_matches_jax(m, n, dtype):
    if dtype == "int32":
        x = np.arange(m * n, dtype=np.int32).reshape(m, n)
        ja, ta = jnp.asarray(x), torch.from_numpy(x)
    else:
        ja, ta = _both(_rand((m, n), 6), dtype)
    want = jax_ops.transpose(ja, bm=32, bn=32, interpret=True)
    got = ops.transpose(ta, bm=32, bn=32, device="cpu")
    _check(got, want, 0.0)
    assert torch.equal(got, ref.transpose_ref(ta))


# -- the kernel modules' padded functions and their out_dtype ---------------

@pytest.mark.parametrize("a_dtype,b_dtype,out_dtype", [
    ("float32", "float32", None), ("bfloat16", "bfloat16", None),
    ("bfloat16", "float32", None), ("bfloat16", "bfloat16", "float32"),
    ("float32", "float32", "bfloat16")])
def test_matmul_padded_matches_jax(a_dtype, b_dtype, out_dtype):
    (ja, ta), (jb, tb) = (_both(_rand((96, 64), 20), a_dtype),
                          _both(_rand((64, 160), 21), b_dtype))
    want = jax_matmul.matmul_padded(
        ja, jb, bm=32, bk=32, bn=32, interpret=True,
        out_dtype=out_dtype and getattr(jnp, out_dtype))
    got = p_matmul.matmul_padded(
        ta, tb, bm=32, bk=32, bn=32,
        out_dtype=out_dtype and getattr(torch, out_dtype))
    _check(got, want, _bar(str(want.dtype)))


@pytest.mark.parametrize("a_dtype,out_dtype", [
    ("float32", None), ("bfloat16", None), ("bfloat16", "float32"),
    ("float32", "bfloat16")])
def test_syrk_packed_module_matches_jax(pallas_compiler_params, a_dtype,
                                        out_dtype):
    ja, ta = _both(_rand((64, 96), 22), a_dtype)
    want = jax_syrk.syrk_packed(
        ja, bk=32, bn=32, interpret=True,
        out_dtype=out_dtype and getattr(jnp, out_dtype))
    got = p_syrk.syrk_packed(ta, bk=32, bn=32,
                             out_dtype=out_dtype and getattr(torch, out_dtype))
    _check(got, want, _bar(str(want.dtype)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_combine_and_transpose_modules_match_jax(dtype):
    pairs = [_both(_rand((64, 96), 30 + i), dtype) for i in range(7)]
    want = jax_combine.strassen_combine(*(j for j, _ in pairs), bm=32, bn=32,
                                        interpret=True)
    got = p_combine.strassen_combine(*(t for _, t in pairs), bm=32, bn=32)
    for g, w in zip(got, want, strict=True):
        _check(g, w, COMBINE_F32_BAR if dtype == "float32" else BF16_BAR)
    ja, ta = pairs[0]
    want = jax_transpose.transpose_padded(ja, bm=32, bn=32, interpret=True)
    _check(p_transpose.transpose_padded(ta, bm=8, bn=32), want, 0.0)


# -- the packed layout and its decode --------------------------------------

def test_syrk_saves_upper_blocks():
    """The packed output has T(T+1)/2 tiles: upper tiles never exist."""
    a = torch.from_numpy(_rand((64, 128), 5))
    packed = ops.syrk_packed(a, bk=32, bn=32, device="cpu")
    t = 128 // 32
    assert packed.shape == (tri_count(t) * 32, 32)
    assert torch.allclose(packed, ref.syrk_packed_ref(a, 32), atol=1e-4)


def test_tri_decode_matches_tri_coords():
    """Every packed index a grid below 5000 tiles reaches decodes to its
    (i, j), as an int and as a tensor."""
    t = torch.arange(5000)
    i, j = p_syrk._tri_decode(t)
    want = tri_coords(100)[:5000].long()
    assert torch.equal(torch.stack([i, j], 1), want)
    for k in (0, 1, 2, 4999):
        assert [int(v) for v in p_syrk._tri_decode(k)] == want[k].tolist()


def test_pad_to_never_passes_a_view():
    """A view that needs no padding comes back as a contiguous, 16-byte
    aligned copy (a kernel reads its operand by pointer)."""
    base = torch.arange(4096.0).reshape(64, 64)
    for view in (base.T, base[:, :32], torch.arange(80.0)[1:65].reshape(8, 8)):
        out = ops._pad_to(view, (8, 8))
        assert out.is_contiguous() and out.data_ptr() % 16 == 0
        assert torch.equal(out, view)
    assert ops._pad_to(base, (8, 8)) is base
    padded = ops._pad_to(base[:60, :63], (32, 16))
    assert padded.shape == (64, 64) and torch.equal(padded[:60, :63],
                                                    base[:60, :63])
    assert not padded[60:].any() and not padded[:, 63:].any()


# -- the slice as a whole: the reference recursion with kernel leaves ------

@pytest.mark.parametrize("levels", [0, 1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ata_with_kernel_leaves_matches_jax(pallas_compiler_params, levels,
                                            dtype):
    ja, ta = _both(_rand((130, 75), 40 + levels), dtype)
    from repro.kernels import pallas_base_matmul, pallas_base_syrk
    want = jax_core.ata(
        ja, levels=levels, leaf=32,
        base_syrk=pallas_base_syrk(bk=32, bn=32, interpret=True),
        base_matmul=pallas_base_matmul(32, 32, 32, interpret=True))
    before = dict(_launch.KERNEL_LAUNCHES)
    got = ata(ta, levels=levels, leaf=32,
              base_syrk=ops.kernel_base_syrk(32, 32),
              base_matmul=ops.kernel_base_matmul(32, 32, 32), device="cpu")
    _check(got, want, _bar(dtype))
    # the plain versions run on the CPU: no kernel launch is counted
    assert _launch.KERNEL_LAUNCHES == before


@pytest.mark.parametrize("levels,trans_a", [(1, False), (2, False),
                                            (2, True)])
def test_strassen_matmul_with_kernel_leaf_matches_jax(levels, trans_a):
    x, y = _rand((90, 75), 50), _rand((75, 66), 51)
    if trans_a:
        x = np.ascontiguousarray(x.T)
    from repro.kernels import pallas_base_matmul
    want = jax_core.strassen_matmul(
        jnp.asarray(x), jnp.asarray(y), levels=levels, leaf=16,
        trans_a=trans_a, base_matmul=pallas_base_matmul(32, 32, 32,
                                                        interpret=True))
    got = strassen_matmul(torch.from_numpy(x), torch.from_numpy(y),
                          levels=levels, leaf=16, trans_a=trans_a,
                          base_matmul=ops.kernel_base_matmul(32, 32, 32),
                          device="cpu")
    _check(got, want, F32_BAR)


# -- what the kernels refuse ------------------------------------------------

def test_kernel_leaves_refuse_grad():
    """The kernels are forward-only, as the JAX package's Pallas leaves:
    with grad mode on, an input that requires grad is refused; under
    no_grad it runs, and the plain torch leaves stay differentiable."""
    x = torch.from_numpy(_rand((64, 48), 60)).requires_grad_()
    m = [torch.from_numpy(_rand((32, 32), 61 + i)) for i in range(7)]
    m[3].requires_grad_()
    calls = (lambda: ops.matmul(x, x.T, device="cpu"),
             lambda: ops.syrk(x, device="cpu"),
             lambda: ops.syrk_packed(x, device="cpu"),
             lambda: ops.strassen_combine(*m, bm=32, bn=32, device="cpu"),
             lambda: ops.transpose(x, device="cpu"),
             lambda: ata(x, levels=1, leaf=16,
                         base_syrk=ops.kernel_base_syrk(16, 16), device="cpu"),
             lambda: ata(x, levels=1, leaf=16,
                         base_matmul=ops.kernel_base_matmul(16, 16, 16),
                         device="cpu"),
             lambda: strassen_matmul(x, x.T, levels=1, leaf=16,
                                     base_matmul=ops.kernel_base_matmul(),
                                     device="cpu"))
    for call in calls:
        with pytest.raises(RuntimeError, match="forward-only"):
            call()
    with torch.no_grad():
        for call in calls:
            call()
    (g,) = torch.autograd.grad(ata(x, levels=1, leaf=16, device="cpu").sum(),
                               x)
    assert g.shape == x.shape and bool(torch.isfinite(g).all())


def _f(shape, dtype=torch.float32):
    return torch.ones(shape, dtype=dtype)


@pytest.mark.parametrize("call,error,match", [
    (lambda: p_matmul.matmul_padded(_f((8, 8), torch.float8_e4m3fn),
                                    _f((8, 8)), bm=8, bk=8, bn=8),
     TypeError, "float32, bfloat16 or float16"),
    (lambda: ops.matmul(_f((8, 8), torch.float64), _f((8, 8), torch.float64),
                        device="cpu"), TypeError,
     "float32, bfloat16 or float16"),
    (lambda: ops.syrk(_f((8, 8), torch.int32), device="cpu"), TypeError,
     "float32, bfloat16 or float16"),
    (lambda: ops.strassen_combine(*[_f((8, 8), torch.float64)] * 7, bm=8,
                                  bn=8, device="cpu"), TypeError,
     "float32, bfloat16 or float16"),
    (lambda: p_combine.strassen_combine(
        *[_f((8, 8))] * 6, _f((8, 8), torch.bfloat16), bm=8, bn=8),
     TypeError, "one dtype"),
    (lambda: ops.transpose(_f((8, 8), torch.float64), device="cpu"),
     TypeError, "2- or 4-byte"),
    (lambda: ops.transpose(torch.ones(8, 8, dtype=torch.uint8), device="cpu"),
     TypeError, "2- or 4-byte"),
    (lambda: p_matmul.matmul_padded(_f((8, 8)), _f((8, 8)), bm=8, bk=8, bn=8,
                                    out_dtype=torch.int32), TypeError,
     "float32, bfloat16 or float16"),
    (lambda: ops.matmul(_f((8, 8)), _f((8, 8)), bm=12, device="cpu"),
     ValueError, "multiples of 8"),
    (lambda: ops.syrk(_f((8, 8)), bk=4, bn=8, device="cpu"), ValueError,
     "multiples of 8"),
    (lambda: ops.transpose(_f((8, 8)), bm=0, device="cpu"), ValueError,
     "multiples of 8"),
    (lambda: ops.matmul(_f((8, 8)), _f((9, 8)), device="cpu"), ValueError,
     "takes \\(m, k\\)"),
    (lambda: ops.matmul(_f((8,)), _f((8, 8)), device="cpu"), ValueError,
     "takes \\(m, k\\)"),
    (lambda: p_matmul.matmul_padded(_f((8, 8)), _f((16, 8)), bm=8, bk=8,
                                    bn=8), ValueError, "non-empty"),
    (lambda: p_matmul.matmul_padded(_f((8, 8)), _f((8, 8)), bm=16, bk=8,
                                    bn=8), ValueError, "padded"),
    (lambda: p_syrk.syrk_packed(_f((8, 12)), bk=8, bn=8), ValueError,
     "padded"),
    (lambda: p_transpose.transpose_padded(_f((8, 12)), bm=8, bn=8),
     ValueError, "padded"),
    (lambda: p_combine.strassen_combine(*[_f((8, 8))] * 6, _f((8, 16)),
                                        bm=8, bn=8), ValueError, "padded"),
    (lambda: ops.syrk(_f((8, 8, 8)), device="cpu"), ValueError, "2-d"),
    (lambda: ops.matmul(_f((8, 8)), _f((8, 8)), device="meta"), ValueError,
     "cuda or cpu"),
])
def test_shape_and_dtype_errors(call, error, match):
    with pytest.raises(error, match=match):
        call()
