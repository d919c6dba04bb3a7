"""The port's ``GramEngine`` in sync mode, its degradation ladder under
injected faults, and the batched launch's plain version, on the CPU.

The port's counterparts of ``tests/test_gram_engine.py`` (among them
``test_engine_fused_interpret_mode``, which fails on the JAX side under
jax 0.9.0: here the fused path's plain executor through the batcher,
against float64) and of the engine cases of ``tests/test_gram_chaos.py``,
each at the JAX suite's sizes and bars, with ``device="cpu"``.  The
distributed routing runs in ``tests/test_torch_engine_dist.py``'s gloo
world, the async and overload cases in
``tests/test_torch_engine_async.py``, the parity with the JAX engine in
``tests/test_torch_engine_parity.py``.
"""
import warnings
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from repro_torch.gram import (GramEngine, batched_gram, bucket_shape,
                              freivalds_gram)
from repro_torch.gram import autotune as gram_autotune
from repro_torch.kernels import strassen_fused as sf
from repro_torch.runtime import faults
from repro_torch.runtime.faults import FaultSpec


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


def _engine(**kw):
    kw.setdefault("device", "cpu")
    return GramEngine(**kw)


def _mixed_trace(rng, requests, min_dim=5, max_dim=200):
    shapes = [(int(rng.integers(min_dim, max_dim)),
               int(rng.integers(min_dim, max_dim // 2)))
              for _ in range(requests)]
    return [(s, rng.standard_normal(s).astype(np.float32)) for s in shapes]


def _chaos_trace(rng, requests, lo=5, hi=60):
    shapes = [(int(rng.integers(lo, hi)), int(rng.integers(lo, hi // 2 + 2)))
              for _ in range(requests)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _rel(got, a, rows=False):
    a = a.astype(np.float64)
    want = a @ a.T if rows else a.T @ a
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


# ---------------------------------------------------------------------------
# tests/test_gram_engine.py
# ---------------------------------------------------------------------------

def test_engine_serves_mixed_trace_correctly():
    rng = np.random.default_rng(0)
    eng = _engine(slots=4, levels=1, leaf=8, min_bucket=16)
    trace = _mixed_trace(rng, 20, max_dim=100)
    uid_to_a = {eng.submit(a).uid: a for _, a in trace}
    finished = eng.run_to_completion()
    assert len(finished) == 20
    for r in finished:
        assert _rel(r.result, uid_to_a[r.uid]) < 1e-5, (r.uid, r.shape)
        assert isinstance(r.result, np.ndarray)
        assert r.result.dtype == np.float32
        np.testing.assert_allclose(r.result, r.result.T, rtol=1e-6)


def test_engine_64_request_trace_bounded_recompiles():
    """A 64-request mixed-shape trace binds at most once per distinct
    shape bucket, and batches: fewer ticks than requests."""
    rng = np.random.default_rng(1)
    eng = _engine(slots=4, levels=1, leaf=8, min_bucket=16)
    trace = _mixed_trace(rng, 64)
    buckets = {eng._bucket_key(a.shape, a.dtype) for _, a in trace}
    for _, a in trace:
        eng.submit(a)
    finished = eng.run_to_completion()
    assert len(finished) == 64
    assert eng.compile_count <= len(buckets)
    assert eng.ticks < 64
    stats = eng.stats()
    assert stats["p50_latency_s"] is not None
    assert stats["p99_latency_s"] >= stats["p50_latency_s"]


def test_engine_partial_batch_padding():
    rng = np.random.default_rng(2)
    eng = _engine(slots=8, levels=0, min_bucket=16)
    a = rng.standard_normal((30, 12)).astype(np.float32)
    eng.submit(a)
    (r,) = eng.run_to_completion()
    assert _rel(r.result, a) < 1e-5
    assert eng.compile_count == 1


def test_engine_tril_only_result():
    rng = np.random.default_rng(3)
    eng = _engine(slots=2, levels=0, min_bucket=16)
    a = rng.standard_normal((20, 10)).astype(np.float32)
    eng.submit(a, full=False)
    (r,) = eng.run_to_completion()
    assert np.abs(np.triu(r.result, 1)).max() == 0.0


@pytest.mark.parametrize("gram_of", ["cols", "rows"])
def test_engine_fused_mode_through_the_batcher(gram_of):
    """The counterpart of the JAX suite's failing
    ``test_engine_fused_interpret_mode``: ``mode="fused"`` through the
    engine's batcher, one bound program for the bucket, the batched
    launch's plain version on the CPU, against float64 (the row gram
    too)."""
    rng = np.random.default_rng(4)
    eng = _engine(slots=2, levels=1, mode="fused", block=16, min_bucket=32)
    arrays = [rng.standard_normal((40, 24)).astype(np.float32)
              for _ in range(2)]
    uids = [eng.submit(a, gram_of=gram_of).uid for a in arrays]
    finished = {r.uid: r for r in eng.run_to_completion()}
    for uid, a in zip(uids, arrays):
        assert finished[uid].served_by == "local"
        assert _rel(finished[uid].result, a, gram_of == "rows") < 1e-4
    assert eng.compile_count == 1
    (exe,) = eng._executables.values()
    assert isinstance(exe, sf.BoundGram) and exe.batch == 2
    assert exe.kind == ("ata" if gram_of == "cols" else "aat")


def test_engine_same_bucket_rejoins_executable():
    rng = np.random.default_rng(5)
    eng = _engine(slots=2, levels=0, min_bucket=16)
    for _ in range(3):
        eng.submit(rng.standard_normal((16, 16)).astype(np.float32))
        eng.run_to_completion()
    assert eng.compile_count == 1
    assert eng.served == 3


def test_engine_oldest_head_served_before_longer_queue():
    rng = np.random.default_rng(7)
    eng = _engine(slots=4, levels=0, min_bucket=16)
    rare = eng.submit(rng.standard_normal((100, 50)).astype(np.float32)).uid
    for _ in range(3):
        eng.submit(rng.standard_normal((16, 16)).astype(np.float32))
    first_tick = eng.step()
    assert [r.uid for r in first_tick] == [rare]
    eng2 = _engine(slots=2, levels=0, min_bucket=16)
    old = eng2.submit(rng.standard_normal((100, 50)).astype(np.float32)).uid
    full = [eng2.submit(rng.standard_normal((16, 16)).astype(np.float32)).uid
            for _ in range(2)]
    assert {r.uid for r in eng2.step()} == set(full)
    assert [r.uid for r in eng2.step()] == [old]


def test_bucket_shape_pow2_and_floor():
    assert bucket_shape(100, 60) == (128, 64)
    assert bucket_shape(5, 3) == (32, 32)
    assert bucket_shape(128, 128) == (128, 128)
    assert bucket_shape(129, 1, min_side=16) == (256, 16)


def test_engine_rejects_bad_request():
    eng = _engine()
    with pytest.raises(ValueError):
        eng.submit(np.zeros((3, 4, 5), np.float32))
    with pytest.raises(ValueError):
        eng.submit(np.zeros((4, 4), np.float32), gram_of="diag")


def test_engine_serves_row_gram_buckets():
    rng = np.random.default_rng(9)
    eng = _engine(slots=2, levels=1, leaf=8, min_bucket=16)
    a = rng.standard_normal((40, 24)).astype(np.float32)
    u_rows = eng.submit(a, gram_of="rows").uid
    u_cols = eng.submit(a).uid
    done = {r.uid: r for r in eng.run_to_completion()}
    assert done[u_rows].result.shape == (40, 40)
    assert done[u_cols].result.shape == (24, 24)
    assert _rel(done[u_rows].result, a, rows=True) < 1e-5
    assert _rel(done[u_cols].result, a) < 1e-5
    assert eng.compile_count == 2
    eng.submit(a, gram_of="rows", full=False)
    (r,) = eng.run_to_completion()[-1:]
    assert np.abs(np.triu(r.result, 1)).max() == 0.0


def test_engine_infeasible_dist_scheme_stays_local():
    mesh = NS(shape={"data": 2, "model": 3}, axis_names=("data", "model"))
    eng = _engine(mesh=mesh, dist_scheme="ring", dist_threshold=1,
                  min_bucket=16)
    assert not eng._is_distributed((64, 64, "float32", "cols"))
    eng_auto = _engine(mesh=mesh, dist_scheme="auto", dist_threshold=1,
                       min_bucket=16)
    assert eng_auto._is_distributed((64, 64, "float32", "cols"))


def test_engine_no_mesh_never_distributes():
    rng = np.random.default_rng(9)
    eng = _engine(slots=2, levels=0, min_bucket=16, dist_threshold=1)
    eng.submit(rng.standard_normal((64, 32)).astype(np.float32))
    eng.run_to_completion()
    assert eng.stats()["dist_served"] == 0
    assert eng.stats()["distributed_buckets"] == []


def test_engine_bf16_requests_bucket_separately():
    """dtype is part of the bucket key: same shape, a bf16 tensor (or
    the bf16 numpy array the JAX package hands out) -> two programs,
    both correct, the bf16 one into fp32."""
    rng = np.random.default_rng(6)
    eng = _engine(slots=2, levels=0, min_bucket=16)
    a32 = rng.standard_normal((24, 16)).astype(np.float32)
    a16 = torch.from_numpy(a32).bfloat16()
    u32 = eng.submit(a32).uid
    u16 = eng.submit(a16).uid
    done = {r.uid: r for r in eng.run_to_completion()}
    assert eng.compile_count == 2
    assert _rel(done[u32].result, a32) < 1e-5
    assert done[u16].result.dtype == np.float32
    assert _rel(done[u16].result, a32) < 5e-2
    assert sorted(k[2] for k in eng.stats()["buckets"]) == [
        "bfloat16", "float32"]


def test_engine_stages_every_bucket_in_one_buffer():
    """Many buckets, fp32 and bf16, share one staging buffer sized to the
    largest batch served; a small bucket after the largest leaves it as
    it is, each batch's unused slots and pads are zero, and ``shutdown``
    frees it."""
    rng = np.random.default_rng(7)
    eng = _engine(slots=2, levels=0, min_bucket=16)
    shapes = [(20, 10), (70, 40), (130, 20), (40, 130), (9, 9), (33, 65)]
    uids = {}
    for s in shapes:
        a = rng.standard_normal(s).astype(np.float32)
        uids[eng.submit(a).uid] = a
        uids[eng.submit(torch.from_numpy(a).bfloat16()).uid] = a
    done = eng.run_to_completion()
    assert len(done) == 2 * len(shapes) and len(eng.stats()["buckets"]) > 6
    for r in done:
        assert _rel(r.result, uids[r.uid]) < 5e-2
    largest = max(2 * M * N * 4 for M, N in
                  (eng._bucket_key(s, np.float32)[:2] for s in shapes))
    assert eng._staging.numel() == largest
    a = rng.standard_normal((5, 3)).astype(np.float32)
    clean = eng._clean_stack(eng._bucket_key(a.shape, a.dtype),
                             [(1, NS(shape=a.shape, a=torch.from_numpy(a)))])
    assert eng._staging.numel() == largest
    assert torch.equal(clean[1, :5, :3], torch.from_numpy(a))
    assert not clean[0].any() and not clean[1, 5:].any() \
        and not clean[1, :, 3:].any()
    eng.shutdown()
    assert eng._staging is None


def test_engine_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the engine runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GramEngine()
    assert _engine().device == torch.device("cpu")


# ---------------------------------------------------------------------------
# tests/test_gram_chaos.py: the engine under injected faults
# ---------------------------------------------------------------------------

def test_failing_executable_drains_queue_as_failed():
    rng = np.random.default_rng(0)
    eng = _engine(slots=2, levels=0, min_bucket=16, max_retries=1)
    uids = [eng.submit(a).uid for a in _chaos_trace(rng, 6)]
    with faults.inject(FaultSpec("exec_fail", site="gram.engine.exec*")):
        finished = eng.run_to_completion()
    assert not eng.waiting
    assert {r.uid for r in finished} == set(uids)
    for r in finished:
        assert r.status == "failed" and r.result is None
        assert "InjectedFault" in r.error
    assert eng.stats()["failed"] == 6
    a = rng.standard_normal((20, 10)).astype(np.float32)
    uid = eng.submit(a).uid
    (r,) = eng.step()
    assert r.uid == uid and r.status == "ok"


def test_step_survives_real_exception_not_just_injected():
    eng = _engine(slots=2, levels=0, min_bucket=16, max_retries=0)
    eng.submit(np.ones((16, 16), np.float32))
    eng._local_executable = lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("launch died"))
    (r,) = eng.run_to_completion()
    assert r.status == "failed" and "launch died" in r.error


def test_ten_percent_fault_trace_serves_everything_clean():
    rng = np.random.default_rng(1)
    arrays = _chaos_trace(rng, 24)
    eng = _engine(slots=4, levels=1, leaf=8, min_bucket=16, verify=2,
                  max_retries=6, breaker_threshold=2, verify_seed=5)
    uid_to_a = {eng.submit(a).uid: a for a in arrays}
    specs = [
        FaultSpec("poison_output", rate=0.10),              # NaN tiles
        FaultSpec("poison_output", rate=0.10, value=2.5),   # silent finite
        FaultSpec("exec_fail", rate=0.10, site="gram.engine.exec*"),
    ]
    with faults.inject(*specs, seed=7) as reg:
        finished = eng.run_to_completion()
    assert len(reg.events) > 0
    assert len(finished) == len(arrays)
    for r in finished:
        assert r.status == "ok", (r.uid, r.error)
        assert np.isfinite(r.result).all()
        passed, err = freivalds_gram(
            uid_to_a[r.uid], r.result, probes=4,
            rng=np.random.default_rng(100 + r.uid))
        assert passed, (r.uid, err)
    stats = eng.stats()
    assert stats["served"] == len(arrays) and stats["failed"] == 0
    assert stats["retries"] > 0


def test_guard_vetoes_silent_corruption_and_recovers():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((16, 16)).astype(np.float32)
    eng = _engine(slots=1, levels=0, min_bucket=16, verify=2, max_retries=3)
    eng.submit(a)
    with faults.inject(FaultSpec("poison_output", value=5.0, times=1)):
        (r,) = eng.run_to_completion()
    assert r.status == "ok"
    assert eng.stats()["guard_failures"] == 1
    want = a.astype(np.float64).T @ a.astype(np.float64)
    np.testing.assert_allclose(r.result, want, rtol=1e-4, atol=1e-4)


def test_finite_default_guard_catches_nan_without_probes():
    rng = np.random.default_rng(3)
    eng = _engine(slots=2, levels=0, min_bucket=16)    # verify="finite"
    eng.submit(rng.standard_normal((20, 10)).astype(np.float32))
    with faults.inject(FaultSpec("poison_output", times=1)):
        (r,) = eng.run_to_completion()
    assert r.status == "ok" and np.isfinite(r.result).all()
    assert eng.stats()["guard_failures"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_poisoned_operand_is_caught_and_retried_from_the_clean_copy(dtype):
    """``poison_operand`` overwrites a tile of the staged stack's copy
    (bf16 through an fp32 copy on the host): the NaN guard vetoes, and
    the retry starts from the clean stack, which the fault never
    touched."""
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32))
    a = a.to(dtype)
    eng = _engine(slots=1, levels=0, min_bucket=16)
    eng.submit(a)
    with faults.inject(FaultSpec("poison_operand", times=1)) as reg:
        (r,) = eng.run_to_completion()
    assert reg.count("poison_operand") == 1
    assert r.status == "ok" and r.attempts == 2
    assert eng.stats()["guard_failures"] == 1
    clean = eng._staging.view(dtype)
    assert torch.isfinite(clean.float()).all()
    assert _rel(r.result, a.float().numpy()) < 1e-5


def test_breaker_escalates_to_reference_mode():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((20, 10)).astype(np.float32)
    eng = _engine(slots=2, levels=1, leaf=8, min_bucket=16, max_retries=4,
                  breaker_threshold=1)
    eng.submit(a)
    with faults.inject(FaultSpec("exec_fail", times=2,
                                 site="gram.engine.exec*")):
        (r,) = eng.run_to_completion()
    assert r.status == "ok" and r.degraded
    assert r.served_by == "local:rung2"
    assert r.attempts == 3
    key = (32, 16, "float32", "cols", "native")
    assert eng._health[key].rung == 2
    assert len(eng._health[key].quarantined) == 2
    assert eng.stats()["quarantined"][str(key)]
    want = a.astype(np.float64).T @ a.astype(np.float64)
    np.testing.assert_allclose(r.result, want, rtol=1e-4, atol=1e-4)


def test_fused_bucket_degrades_to_the_reference_and_classical_rungs():
    """On the fused path, rungs 2 and 3 are the reference recursion (then
    classical): the rung's program is another binding, the result the
    same Gram."""
    rng = np.random.default_rng(10)
    a, b = (rng.standard_normal((40, 24)).astype(np.float32)
            for _ in range(2))
    eng = _engine(slots=2, levels=1, mode="fused", block=16, min_bucket=32,
                  max_retries=6, breaker_threshold=1)
    eng.submit(a)
    (r,) = eng.run_to_completion()
    assert r.served_by == "local" and _rel(r.result, a) < 1e-5
    eng.submit(b)
    # the hook fires before the program is looked up: rungs 0, 1 and 2
    # fail without binding, rung 3 binds the classical recursion
    with faults.inject(FaultSpec("exec_fail", times=3,
                                 site="gram.engine.exec*")):
        (r,) = eng.run_to_completion()[-1:]
    assert r.status == "ok" and r.served_by == "local:rung3"
    assert _rel(r.result, b) < 1e-5
    kinds = sorted(type(e).__name__ for e in eng._executables.values())
    assert kinds == ["BoundGram", "function"]
    assert eng.compile_count == 2


def test_rung_is_sticky_but_counts_reset_on_success():
    rng = np.random.default_rng(5)
    eng = _engine(slots=2, levels=0, min_bucket=16, max_retries=4,
                  breaker_threshold=1)
    eng.submit(rng.standard_normal((16, 16)).astype(np.float32))
    with faults.inject(FaultSpec("exec_fail", times=1,
                                 site="gram.engine.exec*")):
        eng.run_to_completion()
    key = (16, 16, "float32", "cols", "native")
    assert eng._health[key].rung == 1
    assert eng._health[key].consecutive_failures == 0
    uid = eng.submit(rng.standard_normal((16, 16)).astype(np.float32)).uid
    (r,) = eng.run_to_completion()[-1:]
    assert r.uid == uid and r.status == "ok" and r.degraded


def test_deadline_fails_fast():
    rng = np.random.default_rng(6)
    eng = _engine(slots=2, levels=0, min_bucket=16)
    ok_uid = eng.submit(rng.standard_normal((16, 16)).astype(np.float32)).uid
    late = eng.submit(rng.standard_normal((16, 16)).astype(np.float32),
                      deadline_s=0.0).uid
    done = {r.uid: r for r in eng.run_to_completion()}
    assert done[ok_uid].status == "ok"
    assert done[late].status == "failed"
    assert "deadline" in done[late].error


def test_exec_delay_injection_slows_but_serves():
    rng = np.random.default_rng(7)
    eng = _engine(slots=2, levels=0, min_bucket=16)
    eng.submit(rng.standard_normal((16, 16)).astype(np.float32))
    with faults.inject(FaultSpec("exec_delay", delay=0.05, times=1)):
        (r,) = eng.run_to_completion()
    assert r.status == "ok"
    assert r.latency_s >= 0.05


def test_truncated_autotune_cache_warns_once_and_serves(tmp_path,
                                                        monkeypatch):
    p = tmp_path / "gram_autotune.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(p))
    gram_autotune._save_entry("k", {"mode": "reference"}, p)
    raw = p.read_text()
    p.write_text(raw[:len(raw) // 2])
    gram_autotune._memo.clear()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert gram_autotune.load_cache(p) == {}
        assert gram_autotune.load_cache(p) == {}
    assert len([x for x in w if "corrupt" in str(x.message)]) == 1
    eng = _engine(slots=2, levels=0, min_bucket=16)
    eng.submit(np.ones((16, 16), np.float32))
    (r,) = eng.run_to_completion()
    assert r.status == "ok"
    gram_autotune._save_entry("k2", {"mode": "reference"}, p)
    assert "k2" in gram_autotune.load_cache(p)


def test_measured_autotune_winner_drives_the_bucket(tmp_path, monkeypatch):
    """A measured fused winner in the cache sets the bucket's mode,
    levels and block at rung 0 (the engine left them open); rung 1
    quarantines it."""
    p = tmp_path / "gram_autotune.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(p))
    key = gram_autotune._key("cpu", "float32", "ata", 64, 32)
    gram_autotune._save_entry(key, {"mode": "fused", "levels": 1,
                                    "variant": "strassen", "bk": 16,
                                    "bm": 16, "bn": 16,
                                    "source": "measured"}, p)
    gram_autotune._memo.clear()
    eng = _engine(slots=2, levels="auto", min_bucket=16)
    k = eng._bucket_key((40, 20), "float32")
    cfg = eng._bucket_config(k, 0)
    assert (cfg["mode"], cfg["levels"], cfg["block"]) == ("fused", 1, 16)
    assert eng._bucket_config(k, 1)["mode"] == "auto"
    a = np.random.default_rng(11).standard_normal((40, 20)).astype(
        np.float32)
    eng.submit(a)
    (r,) = eng.run_to_completion()
    assert r.status == "ok" and _rel(r.result, a) < 1e-5
    (exe,) = eng._executables.values()
    assert isinstance(exe, sf.BoundGram) and exe.b_out == 16


# ---------------------------------------------------------------------------
# The batched launch's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["ata", "aat"])
@pytest.mark.parametrize("levels", [1, 2])
def test_batched_plain_is_k_single_walks(kind, levels):
    """A batched ``leaf_program`` on the CPU is K single
    ``_leaf_products_plain`` walks, bit for bit, and a zero slot (the
    engine's padding) yields exact zeros."""
    rng = np.random.default_rng(12 + levels)
    x = torch.from_numpy(rng.standard_normal((3, 72, 56)).astype(
        np.float32))
    x[1] = 0.0
    prep = sf._prepare_ata if kind == "ata" else sf._prepare_aat
    spec, _ = prep(x[0], levels, "strassen", "strassen", 8, 8)
    stack = torch.stack([prep(x[k], levels, "strassen", "strassen", 8,
                              8)[1] for k in range(3)])
    got = sf.leaf_program(spec, stack, stack, torch.float32)
    assert got.shape == (3, *sf._out_shape(spec))
    for k in range(3):
        want = sf._leaf_products_plain(spec, stack[k], stack[k],
                                       torch.float32)
        assert torch.equal(got[k], want), k
    assert not got[1].any()


@pytest.mark.parametrize("gram_of", ["cols", "rows"])
def test_bound_gram_against_single_and_float64(gram_of):
    """``BoundGram``: pad once, bind once, one (plain) launch; each slot's
    lower triangle equal to the single fused gram's and within 1e-5 of
    float64, its full gram the symmetric one; the packed stack's slots
    bit-equal to the single packed forms'."""
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.standard_normal((4, 50, 30)).astype(
        np.float32))
    bound = sf.BoundGram(50, 30, batch=4, gram_of=gram_of, levels=1,
                         b_out=16, b_k=16, out_dtype=torch.float32,
                         device="cpu")
    got = bound(x)
    single = sf.fused_ata if gram_of == "cols" else sf.fused_aat
    blk = dict(bk=16, bn=16) if gram_of == "cols" else dict(bm=16, bk=16)
    for k in range(4):
        assert torch.equal(got[k], single(x[k], levels=1, device="cpu",
                                          **blk))
        assert _rel(got[k].numpy() + np.tril(got[k].numpy(), -1).T,
                    x[k].numpy(), gram_of == "rows") < 1e-5
    full = bound(x, symmetrize=True)
    assert torch.equal(full, got + torch.tril(got, -1).mT)
    packed_single = sf.fused_ata_packed if gram_of == "cols" \
        else sf.fused_aat_packed
    packed = bound.packed(x)
    one, edge1 = packed_single(x[2], levels=1, device="cpu", **blk)
    assert edge1 == bound.edge and torch.equal(packed[2], one)


def test_batched_gram_refuses_bad_stacks():
    x = torch.ones(2, 16, 8, requires_grad=True)
    bound = sf.BoundGram(16, 8, batch=2, levels=1, b_out=8, b_k=8,
                         out_dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="forward-only"):
        bound(x)
    with pytest.raises(ValueError, match="bound to"):
        bound(torch.ones(3, 16, 8))
    with pytest.raises(ValueError, match=r"\(K, m, n\)"):
        batched_gram(torch.ones(16, 8), device="cpu")
    with pytest.raises(ValueError, match="gram_of"):
        sf.BoundGram(16, 8, batch=2, gram_of="diag", out_dtype=torch.float32,
                     device="cpu")
