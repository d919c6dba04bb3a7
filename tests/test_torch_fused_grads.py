"""The port's backward of the fused ata path, on the CPU.

The gradient of ``ata`` / ``ata_full`` / ``ops.ata_fused_packed`` runs
the symm kind of the leaf program (``dA = A (S + S^t)`` from the packed
cotangent).  Here the plain version of that kind is held against the
JAX package's ``fused_symm_matmul`` in interpret mode and the float64
oracles, its tables and host-side helpers against the JAX package's,
and ``torch.autograd.grad`` against ``jax.grad`` of the JAX reference
recursion on the same numpy inputs.  Tolerances are those of
tests/test_fused_grads.py: 1e-5 for the symm product, 1e-4 (fp32) and
5e-2 (bf16) for gradients, 1e-5 for the 512^2 acceptance.  The CUDA
kernel is held against this plain version on the card by
``chip_smoke.py``.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.core import ata as jax_ata, ata_full as jax_ata_full
from repro.core import leaf_ir as jax_ir
from repro.core import schedule as jax_schedule
from repro.core.symmetry import pack_tril_blocks as jax_pack
from repro.kernels import strassen_fused as jax_sf
from repro_torch.core import ata, ata_full, schedule
from repro_torch.core.symmetry import pack_tril_blocks, unpack_tril_blocks
from repro_torch.kernels import ops, strassen_fused as sf


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


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-9)


def _np(t):
    return t.detach().double().numpy()


def _sym(s):
    return np.tril(s) + np.tril(s, -1).T


# ---------------------------------------------------------------------------
# The symm kind: plain executor, tables, dense oracle.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("diag_sym", [False, True])
@pytest.mark.parametrize("levels", [0, 1, 2])
@pytest.mark.parametrize("m,n,bs", [(32, 32, 8), (24, 48, 8), (16, 16, 16)])
def test_symm_plain_matches_jax_interpret(pallas_compiler_params, m, n, bs,
                                          levels, diag_sym):
    rng = np.random.RandomState(levels + m)
    x = rng.randn(m, n).astype(np.float32)
    s = rng.randn(n, n)
    # diag_sym reads S block-lower (diagonal tiles full); otherwise the
    # stack holds the symmetric completion
    op = np.tril(s) if diag_sym else _sym(s)
    stack = np.asarray(jax_pack(jnp.asarray(op, jnp.float32), bs))
    want = jax_sf.fused_symm_matmul(jnp.asarray(x), jnp.asarray(stack),
                                    levels=levels, bm=8, diag_sym=diag_sym,
                                    interpret=True)
    got = sf.fused_symm_matmul(torch.from_numpy(x),
                               torch.from_numpy(stack.copy()), levels=levels,
                               bm=8, diag_sym=diag_sym, device="cpu")
    assert tuple(got.shape) == tuple(want.shape) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5
    dense = op + op.T if diag_sym else op
    assert _rel(got.numpy()[:, :n], x.astype(np.float64) @ dense) <= 1e-5


@pytest.mark.parametrize("levels", [0, 1, 2, 3])
@pytest.mark.parametrize("variant", ["strassen", "winograd", "classical"])
def test_symm_tables_match_jax(variant, levels):
    ours = sf.leaf_ir.compile_program("symm", levels, variant)
    ref = jax_ir.compile_program("symm", levels, variant)
    assert (ours.max_terms, ours.max_contributions, ours.n_dests()) == \
        (ref.max_terms, ref.max_contributions, ref.n_dests())
    got = sf._program_tables("symm", levels, variant)
    want = jax_sf._program_tables("symm", levels, variant)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("variant", ["strassen", "winograd", "classical"])
def test_evaluate_symm_plan_matches_jax(variant):
    rng = np.random.RandomState(3)
    for levels in (1, 2):
        B = 1 << levels
        x = rng.randn(B * 3, B * 2)
        s = rng.randn(B * 2, B * 2)
        got = schedule.evaluate_symm_plan(schedule.plan_symm(levels, variant),
                                          x, np.tril(s))
        want = jax_schedule.evaluate_symm_plan(
            jax_schedule.plan_symm(levels, variant), x, np.tril(s))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, x @ _sym(s), rtol=1e-9, atol=1e-9)


def test_symm_bf16_operands_and_depths():
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randn(40, 32).astype(np.float32))
    s = np.tril(rng.randn(32, 32)).astype(np.float32)
    stack = pack_tril_blocks(torch.from_numpy(s), 8)
    outs = [sf.fused_symm_matmul(x.to(torch.bfloat16), stack, levels=2, bm=8,
                                 diag_sym=True, pipeline_depth=d,
                                 device="cpu") for d in (1, 2, 3)]
    assert outs[0].dtype == torch.float32
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    xq = x.to(torch.bfloat16).double().numpy()
    assert _rel(outs[0].numpy(), xq @ (s + s.T)) <= 1e-5
    got = ops.symm_matmul(x, stack, levels=1, bm=8, diag_sym=True,
                          operand_dtype=torch.bfloat16, device="cpu")
    assert _rel(got.numpy(), xq @ (s + s.T)) <= 1e-2


def test_symm_refuses_bad_stacks():
    x = torch.ones(8, 16)
    with pytest.raises(ValueError, match="tile stack"):
        sf.fused_symm_matmul(x, torch.ones(20, 8), device="cpu")
    with pytest.raises(ValueError, match="not triangular"):
        sf.fused_symm_matmul(x, torch.ones(16, 8), device="cpu")
    with pytest.raises(ValueError, match="stack spans"):
        sf.fused_symm_matmul(torch.ones(8, 24), torch.ones(24, 8),
                             device="cpu")
    with pytest.raises(ValueError, match="bad ranks"):
        sf.fused_symm_matmul(torch.ones(8), torch.ones(24, 8), device="cpu")


# ---------------------------------------------------------------------------
# Host-side helpers of the backward.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,n_pad,bn", [(37, 48, 8), (32, 32, 8), (5, 16, 8),
                                        (64, 64, 64)])
def test_pack_cotangent_matches_jax(n, n_pad, bn):
    g = np.random.RandomState(n).randn(n, n).astype(np.float32)
    got = sf._pack_cotangent(torch.from_numpy(g), n, n_pad, bn)
    want = jax_sf._pack_cotangent(jnp.asarray(g), n, n_pad, bn)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,n,levels,cot", [(257, 511, 2, "dense"),
                                            (512, 512, 1, "packed"),
                                            (10000, 10000, 2, "packed"),
                                            (10000, 10000, 3, "dense")])
def test_bwd_traffic_model_matches_jax(m, n, levels, cot):
    kw = dict(levels=levels, bk=64 if m < 1000 else 256,
              bn=64 if m < 1000 else 256, cotangent=cot)
    assert sf.ata_bwd_traffic_model(m, n, **kw) == \
        jax_sf.ata_bwd_traffic_model(m, n, **kw)


def test_bwd_traffic_acceptance_4096():
    """The numbers of tests/test_fused_grads.py's 4096^2 acceptance."""
    model = sf.ata_bwd_traffic_model(4096, 4096, levels=2, bk=256, bn=256,
                                     cotangent="dense")
    fused_b = model["intermediate_bytes"]
    dense_b = model["dense_baseline"]["intermediate_bytes"]
    assert dense_b >= 2 * fused_b > 0
    assert fused_b <= model["packed_stack_bytes"] < 4096 * 4096 * 4
    packed = sf.ata_bwd_traffic_model(4096, 4096, levels=2, bk=256, bn=256,
                                      cotangent="packed")
    assert packed["intermediate_bytes"] == 0
    assert packed["intermediate_ratio_dense_over_fused"] is None
    assert model["write_bytes"] == 4096 * 4096 * 4
    plan = schedule.plan_symm(model["levels"], "strassen")
    T = 4096 // 256
    assert model["grid_steps"] == T * T * plan.max_contributions \
        * (T // plan.blocks)


def test_symm_live_steps():
    """At the main path (10240^2 padded, bm = bs = 256, levels 2) the symm
    kind runs 144 contributions per 16 destinations' worth of tiles."""
    geo = sf._symm_geometry(10240, 40, 2, "strassen", 256)
    spec = sf._bind(geo["plan"], n_out=40 * 40, n_tj=40, q_i=geo["nbm"],
                    q_j=geo["q"], n_k=geo["q"], bi=256, bj=256, bc=256,
                    diag_sym=True)
    assert sf.live_steps(spec) == 144 * 10 * 10 * 10


# ---------------------------------------------------------------------------
# Gradient parity against jax.grad of the JAX reference recursion.
# ---------------------------------------------------------------------------

def _jax_grad(a, w, dtype, **kw):
    def loss(x):
        return jnp.vdot(jnp.asarray(w), jax_ata(
            x, mode="reference", out_dtype=jnp.float32, **kw))
    return np.asarray(jax.grad(loss)(jnp.asarray(a).astype(dtype)),
                      np.float64)


def _torch_grad(a, w, dtype, fn=ata, **kw):
    x = torch.from_numpy(a).to(dtype).requires_grad_()
    out = fn(x, out_dtype=torch.float32, device="cpu", **kw)
    (g,) = torch.autograd.grad((torch.from_numpy(w) * out).sum(), x)
    assert g.dtype == dtype and g.shape == x.shape
    assert bool(torch.isfinite(g).all())
    return _np(g)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-2)])
@pytest.mark.parametrize("levels", [0, 1, 2, 3])
def test_grad_matches_jax_reference(dtype, tol, levels):
    rng = np.random.RandomState(levels)
    a = rng.randn(64, 64).astype(np.float32)
    w = rng.randn(64, 64).astype(np.float32)
    want = _jax_grad(a, w, getattr(jnp, dtype), levels=levels, leaf=8)
    got = _torch_grad(a, w, getattr(torch, dtype), levels=levels, leaf=8,
                      mode="fused", block=8)
    assert _rel(got, want) < tol


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-2)])
@pytest.mark.parametrize("levels", [1, 2])
def test_grad_rectangular(dtype, tol, levels):
    """257 x 511 pads forward and backward: the packed cotangent spans
    the padded 512 grid."""
    rng = np.random.RandomState(2 + levels)
    a = rng.randn(257, 511).astype(np.float32)
    w = rng.randn(511, 511).astype(np.float32)
    want = _jax_grad(a, w, getattr(jnp, dtype), levels=levels, leaf=32)
    got = _torch_grad(a, w, getattr(torch, dtype), levels=levels, leaf=32,
                      mode="fused", block=64)
    assert _rel(got, want) < tol


def test_grad_ata_full_matches_jax_reference():
    rng = np.random.RandomState(9)
    a = rng.randn(48, 40).astype(np.float32)
    w = rng.randn(40, 40).astype(np.float32)

    def loss(x):
        return jnp.vdot(jnp.asarray(w), jax_ata_full(
            x, levels="auto", leaf=8, mode="reference"))
    want = np.asarray(jax.grad(loss)(jnp.asarray(a)), np.float64)
    got = _torch_grad(a, w, torch.float32, fn=ata_full, levels="auto",
                      leaf=8, mode="fused", block=8)
    assert _rel(got, want) < 1e-4


def test_grad_diagonal_factor():
    """S + S^t doubles the diagonal of the tril cotangent: the derivative
    of d/dA vdot(W, tril(A^t A))."""
    rng = np.random.RandomState(5)
    a = rng.randn(24, 16).astype(np.float32)
    w = rng.randn(16, 16).astype(np.float32)
    want = np.asarray(jax.grad(lambda x: jnp.vdot(
        jnp.asarray(w), jnp.tril(x.T @ x)))(jnp.asarray(a)), np.float64)
    got = _torch_grad(a, w, torch.float32, levels=1, leaf=8, mode="fused",
                      block=8)
    assert _rel(got, want) < 1e-4


def test_fused_and_dense_bwd_agree():
    rng = np.random.RandomState(4)
    a = rng.randn(96, 64).astype(np.float32)
    w = rng.randn(64, 64).astype(np.float32)
    fused = _torch_grad(a, w, torch.float32, levels=2, mode="fused",
                        block=16, bwd="fused")
    dense = _torch_grad(a, w, torch.float32, levels=2, mode="fused",
                        block=16, bwd="dense")
    assert _rel(fused, dense) < 1e-5
    with pytest.raises(ValueError, match="bwd"):
        ata(torch.from_numpy(a), mode="fused", bwd="sparse", device="cpu")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("bwd", ["fused", "dense"])
def test_packed_cotangent_grad(dtype, tol, bwd):
    """The packed entry's backward against the dense mask oracle: the
    stack is the block-lower triangle with full diagonal tiles."""
    rng = np.random.RandomState(6)
    a = rng.randn(48, 32).astype(np.float32)
    n, bn = 32, 8
    x = torch.from_numpy(a).to(dtype).requires_grad_()
    p = ops.ata_fused_packed(x, levels=1, bk=bn, bn=bn,
                             out_dtype=torch.float32, bwd=bwd, device="cpu")
    (gp,) = torch.autograd.grad((p * p).sum(), x)
    assert gp.dtype == dtype
    mask = np.zeros((n, n), np.float32)
    for i in range(n // bn):
        mask[i * bn:(i + 1) * bn, :(i + 1) * bn] = 1.0

    def loss_dense(z):
        zf = z.astype(jnp.float32)
        c = (zf.T @ zf) * mask
        return (c * c).sum()
    want = jax.grad(loss_dense)(jnp.asarray(a).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32))
    assert _rel(_np(gp), want) < tol


def test_acceptance_512_grad_parity_dense_and_packed():
    """512^2 fp32: the dense and packed entries' fused backward against
    the port's own reference-mode autograd, <= 1e-5."""
    rng = np.random.RandomState(20)
    n = 512
    a = torch.from_numpy(rng.randn(n, n).astype(np.float32))
    w = torch.from_numpy(rng.randn(n, n).astype(np.float32))
    x = a.clone().requires_grad_()
    (g_ref,) = torch.autograd.grad(
        (w * ata(x, levels=2, leaf=64, mode="reference", device="cpu")).sum(),
        x)
    (g_fused,) = torch.autograd.grad(
        (w * ata(x, levels=2, mode="fused", block=128, device="cpu")).sum(), x)
    assert _rel(_np(g_fused), _np(g_ref)) < 1e-5
    wp = pack_tril_blocks(torch.tril(w), 128)
    (g_packed,) = torch.autograd.grad(
        (wp * ops.ata_fused_packed(x, levels=2, bk=128, bn=128,
                                   device="cpu")).sum(), x)
    assert _rel(_np(g_packed), _np(g_ref)) < 1e-5


def test_operand_dtype_quantizes_the_forward_only():
    """As in the JAX package: the saved primal is the unquantized A, so
    dA = A (S + S^t) uses the fp32 A."""
    rng = np.random.RandomState(7)
    a = rng.randn(32, 32).astype(np.float32)
    w = rng.randn(32, 32).astype(np.float32)
    got = _torch_grad(a, w, torch.float32, levels=1, mode="fused", block=8,
                      operand_dtype=torch.bfloat16)
    s = np.tril(w).astype(np.float64)
    assert _rel(got, a.astype(np.float64) @ (s + s.T)) <= 1e-5


def test_symm_levels_clamp_like_jax():
    """The symm geometry clamps levels to divisors of T and to the
    fan-in, as the JAX package's does."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for m, T, levels, variant in [(100, 6, 3, "strassen"),
                                      (64, 8, 3, "winograd"),
                                      (33, 12, 2, "classical")]:
            got = sf._symm_geometry(m, T, levels, variant, 8)
            want = jax_sf._symm_geometry(m, T, levels, variant, 8)
            assert {k: v for k, v in got.items() if k != "plan"} == \
                {k: v for k, v in want.items() if k != "plan"}


def test_unported_kinds_refuse_on_every_device(pallas_compiler_params):
    """Every program kind of the leaf program is ported, and so are the
    precision knobs of the new kinds that this test once found refused:
    on the CPU fp8 operand tiles match the JAX executor on the same
    input, an fp64 accumulator the float64 oracle; without a card the
    entry points still refuse to run, and ``sr_seed`` still wants a bf16
    output."""
    prog = sf.leaf_ir.compile_program("aat", 1)
    spec = sf._bind(prog, n_out=3, n_tj=0, q_i=1, q_j=1, n_k=1, bi=8, bj=8,
                    bc=8)
    x = torch.from_numpy(np.random.RandomState(3).randn(16, 16)
                         .astype(np.float32))
    packed = sf.leaf_program(spec, x, x, torch.float32)
    got = torch.tril(unpack_tril_blocks(packed, 16, 8, symmetrize=False))
    x64 = _np(x)
    assert _rel(_np(got), np.tril(x64 @ x64.T)) <= 1e-5
    stack = torch.zeros(24, 8)
    xj, sj = jnp.asarray(x64, jnp.float32), jnp.zeros((24, 8), jnp.float32)
    cases = ((sf.fused_aat, (x,), jax_sf.fused_aat, (xj,),
              dict(bm=8, bk=8), np.tril(x64 @ x64.T)),
             (sf.fused_rank_k_update, (stack, x), jax_sf.fused_rank_k_update,
              (sj, xj), dict(bk=8), np.tril(x64.T @ x64)),
             (sf.fused_matmul, (x, x), jax_sf.fused_matmul, (xj, xj),
              dict(bm=8, bk=8, bn=8), x64 @ x64))
    for fn, args, jfn, jargs, blocks, oracle in cases:
        got = fn(*args, operand_dtype="float8_e4m3fn", levels=1,
                 device="cpu", **blocks)
        want = jfn(*jargs, operand_dtype="float8_e4m3fn", levels=1,
                   interpret=True, **blocks)
        assert _rel(_np(got), np.asarray(want, np.float64)) <= 1e-5
        got = fn(*args, acc_dtype="float64", levels=1, device="cpu",
                 **blocks)
        if fn is sf.fused_rank_k_update:    # the zero stack's update
            got = torch.tril(unpack_tril_blocks(got, 16, 8,
                                                symmetrize=False))
        assert _rel(_np(got), oracle) <= 1e-5
        if not torch.cuda.is_available():
            for kw in (dict(operand_dtype="float8_e4m3fn"),
                       dict(acc_dtype="float64")):
                with pytest.raises(RuntimeError, match="no CUDA device"):
                    fn(*args, **kw)
    for device in ("cpu", "cuda"):
        with pytest.raises((ValueError, RuntimeError),
                           match="bfloat16|no CUDA device"):
            sf.fused_aat(x, sr_seed=0, device=device)
