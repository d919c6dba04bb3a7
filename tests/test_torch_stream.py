"""The port's streaming Gram accumulators (``repro_torch.gram.stream``)
against the JAX package's on the CPU.

The same inputs, made with numpy from a seed, stream through the JAX
package (its reference recursion, or the fused Pallas executor in
interpret mode under the per-test ``TPUCompilerParams`` alias) and
through the port with ``device="cpu"`` (the reference recursion under
``mode="auto"``, the fused path's plain executor under ``mode="fused"``
and for the tile-stack stream).  The fused kernels themselves stream on
the card in ``chip_smoke.py`` (phase 4j).

Tolerances, of max|C|: against the float64 one-shot Gram, 5e-5 in fp32
and 5e-2 for bf16 chunks (the JAX suite's ``tests/test_gram_stream.py``
bars); against the JAX package's own stream, 1e-5 in fp32 (sums in
another order) and 2^-7 for bf16 chunks, whose fp32 sums both packages
round in their own order; gradients 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro import gram as jgram
from repro.gram import stream as jstream
from repro_torch import gram
from repro_torch.gram import stream
from repro_torch.gram.verify import VerificationError


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
    ``CompilerParams``; the JAX fused executor still uses the old name.
    Alias it for the duration of one test only."""
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _oracle(a):
    a64 = np.asarray(a, np.float64)
    return a64.T @ a64


def _rel(got, want):
    got = got.double().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


CHUNKINGS = [
    [(0, 96)],                       # one shot through the stream
    [(0, 32), (32, 64), (64, 96)],   # even chunks
    [(0, 40), (40, 89), (89, 96)],   # ragged, incl. a 7-row tail
    [(0, 1), (1, 2), (2, 96)],       # degenerate 1-row chunks
]


@pytest.mark.parametrize("dtype,tol,jax_tol", [("float32", 5e-5, 1e-5),
                                               ("bfloat16", 5e-2, 2 ** -7)])
@pytest.mark.parametrize("levels", [0, 1, 2])
@pytest.mark.parametrize("chunks", CHUNKINGS)
def test_stream_matches_one_shot_and_jax(dtype, tol, jax_tol, levels,
                                         chunks):
    """Every chunking against the float64 one-shot Gram at the JAX suite's
    bars; the ragged chunking also against the JAX package's own stream,
    state and result (its jitted update compiles for each chunk shape, so
    the other three are left to the oracle)."""
    m, n = 96, 24
    a32 = _rand((m, n), 0)
    ja = jnp.asarray(a32).astype(getattr(jnp, dtype))
    ta = torch.from_numpy(a32).to(getattr(torch, dtype))
    st = gram.stream_init(n, device="cpu")
    for lo, hi in chunks:
        st = gram.stream_update(st, ta[lo:hi], levels=levels, leaf=8)
    assert st.packed.dtype == torch.float32 and st.rows.dtype == torch.int32
    assert int(st.rows) == m
    got = gram.stream_finalize(st)
    assert _rel(got, _oracle(np.asarray(ja, np.float64))) < tol
    if chunks == CHUNKINGS[2]:
        jst = jgram.stream_init(n)
        for lo, hi in chunks:
            jst = jgram.stream_update(jst, ja[lo:hi], levels=levels, leaf=8)
        assert int(jst.rows) == m
        assert _rel(got, jgram.stream_finalize(jst)) <= jax_tol
        assert _rel(st.packed, jst.packed) <= jax_tol


def test_stream_finalize_tril_only():
    a = _rand((20, 10), 2)
    st = gram.stream_update(gram.stream_init(10, device="cpu"), a, levels=1,
                            leaf=4)
    low = gram.stream_finalize(st, symmetrize=False)
    assert float(torch.triu(low, 1).abs().max()) == 0.0
    full = gram.stream_finalize(st)
    assert torch.equal(full, full.T)
    jst = jgram.stream_update(jgram.stream_init(10), jnp.asarray(a),
                              levels=1, leaf=4)
    for sym in (False, True):
        assert _rel(gram.stream_finalize(st, symmetrize=sym),
                    jgram.stream_finalize(jst, symmetrize=sym)) <= 1e-5
    out = gram.stream_finalize(st, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16


def test_stream_state_is_packed():
    """The accumulator holds n(n+1)/2 words — the paper's storage bound —
    not a dense n^2 buffer; the stack stream holds T(T+1)/2 tiles."""
    st = gram.stream_init(64, device="cpu")
    assert tuple(st.packed.shape) == (64 * 65 // 2,)
    assert st.n == 64 and st.rows.shape == ()
    ss = gram.stack_init(40, block=16, device="cpu")
    js = jgram.stack_init(40, block=16)
    assert tuple(ss.stack.shape) == js.stack.shape == (6 * 16, 16)
    assert ss.n_padded == js.n_padded == 48 and ss.block == 16
    assert gram.stack_init(40, device="cpu").block == 256


def test_stream_rejects_mismatched_chunk():
    st = gram.stream_init(8, device="cpu")
    with pytest.raises(ValueError, match="n=8"):
        gram.stream_update(st, torch.zeros(4, 9))
    with pytest.raises(ValueError, match="n=8"):
        gram.stream_update(st, torch.zeros(8))
    ss = gram.stack_init(8, block=8, device="cpu")
    with pytest.raises(ValueError, match="n_padded=8"):
        gram.stack_update(ss, torch.zeros(4, 9))


def test_normalized_second_moment():
    """C / rows is the running second moment — the typical consumer
    reading (preconditioners, whitening)."""
    a = _rand((200, 12), 3)
    st = gram.stream_init(12, device="cpu")
    for lo in range(0, 200, 50):
        st = gram.stream_update(st, a[lo:lo + 50], levels=1, leaf=4)
    c = gram.stream_finalize(st).double().numpy() / int(st.rows)
    np.testing.assert_allclose(c, _oracle(a) / 200, rtol=1e-4, atol=1e-5)


def test_fused_stream_matches_jax_fused_interpret(pallas_compiler_params):
    """The port's fused path (its plain executor on the CPU) against the
    JAX package's fused Pallas path in interpret mode, chunk by chunk:
    the port's counterpart of ``test_stream_matches_ata_full_fused_
    interpret``."""
    a = _rand((64, 32), 1)
    st, jst = gram.stream_init(32, device="cpu"), jgram.stream_init(32)
    for lo, hi in [(0, 48), (48, 64)]:
        st = gram.stream_update(st, a[lo:hi], levels=1, mode="fused",
                                block=16)
        jst = jgram.stream_update(jst, jnp.asarray(a[lo:hi]), levels=1,
                                  mode="fused", block=16, interpret=True)
        assert _rel(st.packed, jst.packed) <= 1e-5
    got = gram.stream_finalize(st)
    assert _rel(got, _oracle(a)) < 5e-5
    assert _rel(got, jgram.stream_finalize(jst)) <= 1e-5


@pytest.mark.parametrize("levels,block", [(2, 8), ("auto", 16)])
def test_stack_update_matches_jax(pallas_compiler_params, levels, block):
    """The tile-stack stream, one accumulating launch a chunk, against the
    JAX package's (fused, interpret) at <= 1e-5, and its dense finalize
    against the packed stream's."""
    a = _rand((70, 40), 4)
    ss = gram.stack_init(40, block=block, device="cpu")
    js = jgram.stack_init(40, block=block)
    st = gram.stream_init(40, device="cpu")
    for lo, hi in [(0, 30), (30, 63), (63, 70)]:
        ss = gram.stack_update(ss, a[lo:hi], levels=levels, leaf=8,
                               block=block)
        js = jgram.stack_update(js, jnp.asarray(a[lo:hi]), levels=levels,
                                leaf=8, block=block, interpret=True)
        st = gram.stream_update(st, a[lo:hi], levels=1, leaf=8)
        assert _rel(ss.stack, js.stack) <= 1e-5
    assert int(ss.rows) == int(js.rows) == 70
    for sym in (False, True):
        got = gram.stack_finalize(ss, 40, symmetrize=sym)
        assert got.shape == (40, 40)
        assert _rel(got, jgram.stack_finalize(js, 40, symmetrize=sym)) <= 1e-5
        assert _rel(got, gram.stream_finalize(st, symmetrize=sym)) <= 1e-5
    assert gram.stack_finalize(ss).shape == (ss.n_padded, ss.n_padded)


def test_updates_are_in_place_without_grad():
    """Where no input requires grad, both layouts add into the state they
    are given (the JAX package donates it); the rows count is a new 0-d
    int32 tensor."""
    a = torch.from_numpy(_rand((16, 8), 5))
    st0 = gram.stream_init(8, device="cpu")
    st1 = gram.stream_update(st0, a, levels=0)
    assert st1.packed.data_ptr() == st0.packed.data_ptr()
    assert int(st0.rows) == 0 and int(st1.rows) == 16
    ss0 = gram.stack_init(8, block=8, device="cpu")
    ss1 = gram.stack_update(ss0, a, levels=0)
    assert ss1.stack.data_ptr() == ss0.stack.data_ptr()
    # a chunk that requires grad: out of place, the state untouched
    x = a.clone().requires_grad_()
    st2 = gram.stream_update(st1, x, levels=0)
    ss2 = gram.stack_update(ss1, x, levels=0)
    assert st2.packed.data_ptr() != st1.packed.data_ptr()
    assert ss2.stack.data_ptr() != ss1.stack.data_ptr()
    assert torch.equal(st2.packed, 2 * st1.packed)
    assert torch.equal(ss2.stack, 2 * ss1.stack)


def test_fused_update_keeps_its_gather_index_with_the_state():
    """The fused update builds its gather index once for a stream updated
    in place, rebuilds it for another block edge, builds none to keep for
    an out-of-place update, and frees it with the state's buffer."""
    a = torch.from_numpy(_rand((40, 20), 6))
    kw = {"levels": 1, "mode": "fused"}
    held = len(stream._GATHER_INDEX)
    st = gram.stream_init(20, device="cpu")
    st = gram.stream_update(st, a[:16], block=8, **kw)
    idx = stream._GATHER_INDEX[st.packed][1]
    st = gram.stream_update(st, a[16:30], block=8, **kw)
    assert stream._GATHER_INDEX[st.packed][1] is idx
    st = gram.stream_update(st, a[30:], block=16, **kw)
    assert stream._GATHER_INDEX[st.packed][0] == 16
    assert len(stream._GATHER_INDEX) == held + 1
    assert _rel(gram.stream_finalize(st), _oracle(a)) < 5e-5
    x = a[:8].clone().requires_grad_()
    st2 = gram.stream_update(st, x, block=8, **kw)
    assert st2.packed not in stream._GATHER_INDEX
    del st, st2
    assert len(stream._GATHER_INDEX) == held


def test_entry_points_run_on_the_card_unless_asked():
    """``init`` and ``stack_init`` place the state on the card by default:
    without one they raise rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the state goes there")
    for fn in (gram.stream_init, gram.stack_init):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(8)


def test_finalize_guard_raises_on_poisoned_state():
    st = gram.stream_update(gram.stream_init(8, device="cpu"),
                            np.ones((4, 8), np.float32), levels=0)
    gram.stream_finalize(st, guard=True)       # clean state passes
    bad = stream.GramStream(packed=st.packed.clone(), rows=st.rows)
    bad.packed[3] = float("nan")
    with pytest.raises(VerificationError, match="non-finite"):
        gram.stream_finalize(bad, guard=True)
    neg = stream.GramStream(packed=st.packed.clone(), rows=st.rows)
    neg.packed[2] = -5.0                        # the diagonal entry (1, 1)
    with pytest.raises(VerificationError, match="negative diagonal"):
        gram.stream_finalize(neg, guard=True)
    with pytest.raises(jgram.VerificationError, match="negative diagonal"):
        jstream.finalize(jstream.GramStream(packed=jnp.asarray(neg.packed),
                                            rows=jnp.asarray(neg.rows)),
                         guard=True)


def test_stack_finalize_guard_raises_on_poisoned_state():
    ss = gram.stack_update(gram.stack_init(8, block=8, device="cpu"),
                           np.ones((4, 8), np.float32), levels=0)
    gram.stack_finalize(ss, 8, guard=True)
    bad = stream.GramStackStream(stack=ss.stack.clone(), rows=ss.rows)
    bad.stack[5, 1] = float("inf")
    with pytest.raises(VerificationError, match="non-finite"):
        gram.stack_finalize(bad, 8, guard=True)
    neg = stream.GramStackStream(stack=ss.stack.clone(), rows=ss.rows)
    neg.stack[3, 3] = -5.0
    with pytest.raises(VerificationError, match="negative diagonal"):
        gram.stack_finalize(neg, 8, guard=True)


@pytest.mark.parametrize("mode", ["fused", "reference"])
def test_stream_update_gradient_matches_jax(mode):
    """``torch.autograd.grad`` through a packed update (the fused path:
    the ata kind's backward behind the gather) against ``jax.grad`` of
    the same loss through the JAX package's reference stream."""
    n = 32
    a = _rand((40, n), 8)
    w = _rand((n * (n + 1) // 2,), 9)
    x = torch.from_numpy(a).requires_grad_()
    st = gram.stream_update(gram.stream_init(n, device="cpu"), x, levels=1,
                            leaf=8, mode=mode, block=8)
    (g,) = torch.autograd.grad((torch.from_numpy(w) * st.packed).sum(), x)

    def loss(y):
        s = jgram.stream_update(jgram.stream_init(n), y, levels=1, leaf=8,
                                mode="reference")
        return jnp.vdot(jnp.asarray(w), s.packed)

    want = jax.grad(loss)(jnp.asarray(a))
    assert _rel(g, want) <= 1e-5
    wd = np.zeros((n, n))
    wd[np.tril_indices(n)] = w
    assert _rel(g, a.astype(np.float64) @ (wd + wd.T)) <= 1e-5


def test_stack_update_gradient_matches_jax(pallas_compiler_params):
    """``torch.autograd.grad`` through a stack update (the rank_k kind, not
    donated) against ``jax.grad`` through the JAX package's
    (fused, interpret): the stack's cotangent passes through, dA = A (S +
    S^t) with S the block-lower cotangent stack."""
    n, block = 24, 8
    a = _rand((40, n), 10)
    ss = gram.stack_init(n, block=block, device="cpu")
    wp = _rand(tuple(ss.stack.shape), 11)
    s0 = ss.stack.clone().requires_grad_()
    x = torch.from_numpy(a).requires_grad_()
    out = gram.stack_update(stream.GramStackStream(stack=s0, rows=ss.rows),
                            x, levels=1, block=block)
    assert out.stack.data_ptr() != s0.data_ptr()
    g_stack, g = torch.autograd.grad((torch.from_numpy(wp) * out.stack).sum(),
                                     (s0, x))
    assert torch.equal(g_stack, torch.from_numpy(wp))

    def loss(y):
        s = jgram.stack_update(jgram.stack_init(n, block=block), y, levels=1,
                               block=block, interpret=True)
        return jnp.vdot(jnp.asarray(wp), s.stack)

    want = jax.grad(loss)(jnp.asarray(a))
    assert _rel(g, want) <= 1e-5
