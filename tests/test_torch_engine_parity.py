"""The port's Gram service against the JAX package's, on the CPU.

Both engines serve the same traces in sync mode (``device="cpu"`` for
the port; the JAX engine on its CPU platform, where ``mode="auto"`` is
the reference recursion in both): the same results within the reference
suite's bars, the same bucket keys and labels, the same ``served_by``,
ticks and bindings (the JAX engine's compilations).  Under the same
seeded fault profile the two take the same rungs: the port calls the
fault hooks in the JAX engine's order on arrays of the same shapes, so
each hook's random draws, and with them every firing, agree.
``batched_gram`` and its gradient are held against the JAX package's
and ``jax.grad``; the fused path's batched launch (its plain version)
against the JAX package's interpret-mode kernel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.gram import GramEngine as JaxGramEngine
from repro.gram import batched_gram as jax_batched_gram
from repro.launch import gram_serve as jax_gram_serve
from repro.runtime import faults as jax_faults
from repro_torch.gram import GramEngine, batched_gram
from repro_torch.launch import gram_serve
from repro_torch.runtime import faults


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()


@pytest.fixture
def pallas_compiler_params(monkeypatch):
    """The installed jax renamed ``pltpu.TPUCompilerParams`` to
    ``CompilerParams``; the JAX executor still uses the old name.  Alias
    it for the duration of one test only."""
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)


def _engines(**kw):
    return GramEngine(device="cpu", **kw), JaxGramEngine(**kw)


def _mixed_trace(seed=0, requests=16):
    """16 requests: column and row grams, fp32 and bf16 (the bf16 numpy
    array the JAX package hands out, which the port takes as it is)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(requests):
        shape = (int(rng.integers(5, 40)), int(rng.integers(5, 30)))
        a = rng.standard_normal(shape).astype(np.float32)
        if i % 4 >= 2:
            a = np.asarray(jnp.asarray(a).astype(jnp.bfloat16))
        out.append((a, "rows" if i % 2 else "cols", bool(i % 3)))
    return out


def _oracle(a, gram_of):
    a64 = np.asarray(a, np.float32).astype(np.float64)
    return a64 @ a64.T if gram_of == "rows" else a64.T @ a64


def _serve(eng, trace):
    uids = [eng.submit(a, gram_of=g, full=full).uid for a, g, full in trace]
    done = {r.uid: r for r in eng.run_to_completion()}
    return [done[u] for u in uids]


def _outcome(r):
    return (r.status, r.served_by, r.attempts, r.degraded, r.shape,
            r.gram_of)


def test_mixed_trace_matches_the_jax_engine():
    trace = _mixed_trace()
    mine, theirs = _engines(slots=4, levels=1, leaf=8, min_bucket=16)
    got, want = _serve(mine, trace), _serve(theirs, trace)
    for (a, g, full), r, w in zip(trace, got, want):
        assert _outcome(r) == _outcome(w)
        wres = np.asarray(w.result, np.float64)
        assert r.result.dtype == np.float32
        assert r.result.shape == wres.shape
        oracle = _oracle(a, g)
        if not full:
            oracle = np.tril(oracle)
        scale = np.abs(oracle).max()
        # the reference suite's bars against float64: 1e-5 of max|C|
        # for fp32 and bf16 operands alike (fp32 arithmetic on exact
        # bf16 values), and the two engines within them of each other
        assert np.abs(r.result - oracle).max() <= 1e-5 * scale
        assert np.abs(r.result - wres).max() <= 1e-5 * scale
        if not full:
            assert np.abs(np.triu(r.result, 1)).max() == 0.0
    s_mine, s_theirs = mine.stats(), theirs.stats()
    assert s_mine["buckets"] == s_theirs["buckets"]
    for k in ("served", "failed", "ticks", "compile_count",
              "degraded_served", "retries"):
        assert s_mine[k] == s_theirs[k], k
    assert len({b[2] for b in s_mine["buckets"]}) == 2
    assert len({b[3] for b in s_mine["buckets"]}) == 2


@pytest.mark.parametrize("shape,dtype,gram_of,od", [
    ((100, 60), np.float32, "cols", None),
    ((5, 3), np.float32, "rows", None),
    ((129, 1), "bfloat16", "cols", None),
    ((40, 24), np.float32, "cols", "float8_e4m3fn"),
    ((40, 24), np.float32, "rows", "bfloat16"),
])
def test_bucket_keys_and_labels_match(shape, dtype, gram_of, od):
    mine, theirs = _engines(min_bucket=16)
    dt = jnp.bfloat16 if dtype == "bfloat16" else dtype
    key = mine._bucket_key(shape, jnp.dtype(dt).name, gram_of, od)
    assert key == theirs._bucket_key(shape, jnp.dtype(dt), gram_of, od)
    assert mine._blabel(key) == theirs._blabel(key)
    assert mine._drift_key(key) == theirs._drift_key(key)
    assert mine._is_distributed(key) == theirs._is_distributed(key)
    assert mine._bucket_config(key, 3) == theirs._bucket_config(key, 3)
    assert mine._work_units(key) == theirs._work_units(key)


def test_times_faults_take_the_same_rungs():
    """exec failures and poisoned outputs with firing budgets (``times=``)
    and a breaker that trips on every failure: the same sequence of
    firings (with the poisoned tiles), attempts, rungs, quarantines and
    ``served_by``."""
    trace = _mixed_trace(seed=1, requests=10)
    kw = dict(slots=2, levels=1, leaf=8, min_bucket=16, verify=2,
              max_retries=5, breaker_threshold=1, verify_seed=3)
    mine, theirs = _engines(**kw)

    def specs(mod):
        return (mod.FaultSpec("exec_fail", times=3,
                              site="gram.engine.exec.local.*"),
                mod.FaultSpec("poison_output", times=2),
                mod.FaultSpec("poison_output", value=4.0, times=1),
                mod.FaultSpec("poison_operand", times=1))

    with faults.inject(*specs(faults), seed=9) as reg:
        got = _serve(mine, trace)
    with jax_faults.inject(*specs(jax_faults), seed=9) as jreg:
        want = _serve(theirs, trace)
    assert [_outcome(r) for r in got] == [_outcome(w) for w in want]
    assert [(e.kind, e.site, e.detail) for e in reg.events] == \
        [(e.kind, e.site, e.detail) for e in jreg.events]
    assert len(reg.events) == 7
    assert {k: (h.rung, h.failures, h.successes, h.quarantined)
            for k, h in mine._health.items()} == \
        {k: (h.rung, h.failures, h.successes, h.quarantined)
         for k, h in theirs._health.items()}
    s_mine, s_theirs = mine.stats(), theirs.stats()
    for k in ("served", "failed", "degraded_served", "retries",
              "guard_failures", "quarantined", "compile_count"):
        assert s_mine[k] == s_theirs[k], k
    assert s_mine["guard_failures"] >= 2 and s_mine["degraded_served"] > 0


def test_gram_serve_fault_drill_matches_the_jax_driver(capsys):
    """``launch.gram_serve`` with a rate profile (the JAX suite's drill,
    ``--faults 'poison_output:rate=0.1;exec_fail:rate=0.05' --verify
    2``): the same served, failed, degraded, retried and vetoed counts,
    the same buckets and ticks, on the same seed."""
    argv = ["--requests", "16", "--faults",
            "poison_output:rate=0.1;exec_fail:rate=0.05", "--verify", "2",
            "--seed", "0", "--max-dim", "96"]
    s_mine = gram_serve.main(argv + ["--device", "cpu"])
    s_theirs = jax_gram_serve.main(argv)
    out = capsys.readouterr().out
    for k in ("served", "failed", "degraded_served", "retries",
              "guard_failures", "ticks", "compile_count", "buckets",
              "quarantined"):
        assert s_mine[k] == s_theirs[k], (k, s_mine[k], s_theirs[k])
    assert s_mine["served"] == 16 and s_mine["retries"] > 0
    assert out.count("served 16 gram requests") == 2


def _blocks(seed=2, k=3, m=40, n=24):
    return np.random.default_rng(seed).standard_normal((k, m, n)).astype(
        np.float32)


@pytest.mark.parametrize("levels,leaf", [(1, 8), (2, 8), ("auto", 16)])
def test_batched_gram_matches_jax(levels, leaf):
    x = _blocks()
    got = batched_gram(torch.from_numpy(x), levels=levels, leaf=leaf,
                       device="cpu")
    want = np.asarray(jax_batched_gram(jnp.asarray(x), levels=levels,
                                       leaf=leaf))
    assert got.shape == want.shape == (3, 24, 24)
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * scale
    np.testing.assert_array_equal(got.numpy(), got.numpy().swapaxes(1, 2))


def test_batched_gram_fused_matches_jax_interpret(pallas_compiler_params):
    """The fused path: the port's batched launch (its plain version, one
    call over the stack) against the JAX package's ``jax.vmap`` over its
    interpret-mode kernel."""
    from repro_torch.kernels import strassen_fused as sf
    x = _blocks(seed=3, k=2)
    before = sf.KERNEL_LAUNCHES["leaf_program/ata"]
    got = batched_gram(torch.from_numpy(x), levels=1, mode="fused",
                       block=16, device="cpu")
    assert sf.KERNEL_LAUNCHES["leaf_program/ata"] == before  # CPU: plain
    want = np.asarray(jax_batched_gram(jnp.asarray(x), levels=1,
                                       mode="fused", block=16,
                                       interpret=True))
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * scale


@pytest.mark.parametrize("mode", ["reference", "fused"])
def test_batched_gram_gradient_matches_jax_grad(mode):
    """A stack that requires grad runs one differentiable ``ata_full`` a
    slot (on the fused path, whose backward is the symm kind): the
    gradient of a weighted sum against ``jax.grad`` of the JAX
    package's ``batched_gram`` (its reference path: the JAX fused kernel
    has no CPU backward to compare here that runs under jax 0.9.0)."""
    x = _blocks(seed=4)
    w = np.random.default_rng(5).standard_normal((3, 24, 24)).astype(
        np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = batched_gram(xt, levels=1, leaf=8, mode=mode, block=16,
                       device="cpu")
    (out * torch.from_numpy(w)).sum().backward()

    def loss(b):
        return jnp.sum(jax_batched_gram(b, levels=1, leaf=8) * w)
    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    scale = np.abs(want).max()
    assert np.abs(xt.grad.numpy() - want).max() <= 1e-5 * scale


@pytest.mark.parametrize("mode", ["reference", "fused"])
@pytest.mark.parametrize("dtype,out_dtype", [("float32", None),
                                             ("bfloat16", None),
                                             ("float32", "bfloat16")])
def test_batched_gram_of_an_empty_stack(mode, dtype, out_dtype):
    """A (0, m, n) stack gives an empty (0, n, n) of the output type on
    both paths, as the JAX package's reference mode returns it."""
    x = np.zeros((0, 40, 24), np.float32)
    want = jax_batched_gram(jnp.asarray(x).astype(getattr(jnp, dtype)),
                            mode="reference", out_dtype=out_dtype)
    got = batched_gram(torch.zeros((0, 40, 24), dtype=getattr(torch, dtype)),
                       mode=mode, out_dtype=out_dtype, device="cpu")
    assert tuple(got.shape) == tuple(want.shape) == (0, 24, 24)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
