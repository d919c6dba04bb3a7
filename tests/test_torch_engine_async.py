"""The port's async Gram serving (DESIGN.md §15): futures, the
background scheduler, admission control and CoDel shedding, EDF and
weighted-fair scheduling, cancellation races, shutdown, the backoff cap,
and overload with fault chaos combined.

The port's counterparts of ``tests/test_gram_async.py`` and
``tests/test_gram_overload.py``, with ``device="cpu"``.  Every wait is
bounded (``result(timeout=)``, ``drain(timeout=)``) and every engine
whose scheduler was started is shut down in a ``finally``.
"""
import threading
import time
from concurrent.futures import CancelledError

import numpy as np
import pytest

from repro_torch.gram import (EngineShutdown, GramEngine, GramFuture,
                              GramServeError, Overloaded)
from repro_torch.obs import trace
from repro_torch.obs.trace import Tracer
from repro_torch.runtime import faults
from repro_torch.runtime.faults import FaultSpec

TERMINAL = {"ok", "failed", "shed", "cancelled"}


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


def _a(rng, m=20, n=10):
    return rng.standard_normal((m, n)).astype(np.float32)


def _engine(**kw):
    kw.setdefault("slots", 2)
    kw.setdefault("levels", 0)
    kw.setdefault("min_bucket", 16)
    kw.setdefault("device", "cpu")
    return GramEngine(**kw)


# ---------------------------------------------------------------------------
# Futures
# ---------------------------------------------------------------------------

def test_submit_returns_future_and_result_matches_sync_semantics():
    rng = np.random.default_rng(0)
    eng = _engine()
    a = _a(rng)
    fut = eng.submit(a)
    assert isinstance(fut, GramFuture)
    assert not fut.done() and not fut.cancelled()
    eng.run_to_completion()
    assert fut.done()
    np.testing.assert_allclose(fut.result(timeout=1), a.T @ a, atol=1e-3)
    assert fut.exception(timeout=1) is None
    assert fut.request.status == "ok"


def test_future_timeout_and_done_callbacks_fire_exactly_once():
    rng = np.random.default_rng(1)
    eng = _engine()
    fut = eng.submit(_a(rng))
    with pytest.raises(TimeoutError):
        fut.result(timeout=0.01)
    calls = []
    fut.add_done_callback(lambda f: calls.append(f.uid))
    eng.run_to_completion()
    # registered-after-done callbacks run immediately
    fut.add_done_callback(lambda f: calls.append(-f.uid - 1))
    assert calls == [fut.uid, -fut.uid - 1]


def test_failed_request_raises_gram_serve_error_through_future():
    rng = np.random.default_rng(2)
    eng = _engine(max_retries=0, verify="off")
    fut = eng.submit(_a(rng, 16, 16))
    with faults.inject(FaultSpec("exec_fail", site="gram.engine.exec*")):
        eng.run_to_completion()
    with pytest.raises(GramServeError):
        fut.result(timeout=1)
    assert fut.request.status == "failed"


def test_serve_is_a_thin_sync_wrapper():
    rng = np.random.default_rng(3)
    eng = _engine()
    a = _a(rng, 24, 12)
    np.testing.assert_allclose(eng.serve(a, timeout=5), a.T @ a, atol=1e-3)
    assert eng.stats()["served"] == 1


# ---------------------------------------------------------------------------
# Background scheduler
# ---------------------------------------------------------------------------

def test_background_scheduler_serves_without_stepping():
    rng = np.random.default_rng(4)
    eng = _engine().start()
    try:
        arrays = [_a(rng) for _ in range(8)]
        futs = [eng.submit(a) for a in arrays]
        for f, a in zip(futs, arrays):
            np.testing.assert_allclose(f.result(timeout=30), a.T @ a,
                                       atol=1e-3)
        assert eng.drain(timeout=5)
        assert eng.stats()["scheduler_running"]
    finally:
        eng.shutdown()
    assert not eng.stats()["scheduler_running"]


def test_start_is_idempotent_and_restartable_after_shutdown():
    rng = np.random.default_rng(5)
    eng = _engine().start()
    assert eng.start() is eng
    eng.shutdown()
    eng.start()
    try:
        assert eng.submit(_a(rng)).result(timeout=30) is not None
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------

def test_global_queue_bound_sheds_with_overloaded():
    rng = np.random.default_rng(6)
    eng = _engine(max_queue=3)
    futs = [eng.submit(_a(rng)) for _ in range(5)]
    shed = [f for f in futs if f.done()]
    assert len(shed) == 2                   # 3 admitted, 2 shed at submit
    for f in shed:
        with pytest.raises(Overloaded):
            f.result(timeout=1)
        assert f.request.status == "shed"
    eng.run_to_completion()
    s = eng.stats()
    assert s["served"] == 3 and s["shed"] == 2
    assert s["queue_peak"] <= 3


def test_per_bucket_bound_sheds_only_that_bucket():
    rng = np.random.default_rng(7)
    eng = _engine(max_queue_per_bucket=2)
    small = [eng.submit(_a(rng, 16, 16)) for _ in range(4)]
    big = eng.submit(_a(rng, 64, 32))       # different bucket: admitted
    assert sum(f.done() for f in small) == 2
    assert not big.done()
    eng.run_to_completion()
    assert big.request.status == "ok"


def test_tenant_quota_sheds_flooder_not_neighbor():
    rng = np.random.default_rng(8)
    eng = _engine(tenant_quota=2)
    flood = [eng.submit(_a(rng), tenant="abuser") for _ in range(6)]
    good = eng.submit(_a(rng), tenant="good")
    assert sum(f.done() for f in flood) == 4
    assert not good.done()
    eng.run_to_completion()
    s = eng.stats()
    assert s["tenants"]["abuser"]["shed"] == 4
    assert s["tenants"]["good"]["shed"] == 0
    assert good.request.status == "ok"


def test_block_admission_waits_then_sheds_on_timeout():
    rng = np.random.default_rng(9)
    eng = _engine(max_queue=1, admission="block", block_timeout_s=0.05)
    eng.submit(_a(rng))
    t0 = time.perf_counter()
    fut = eng.submit(_a(rng))
    waited = time.perf_counter() - t0
    assert waited >= 0.05
    with pytest.raises(Overloaded, match="timeout"):
        fut.result(timeout=1)


def test_block_admission_succeeds_when_scheduler_frees_space():
    rng = np.random.default_rng(10)
    eng = _engine(max_queue=1, admission="block",
                  block_timeout_s=10.0).start()
    try:
        arrays = [_a(rng) for _ in range(6)]
        futs = [eng.submit(a) for a in arrays]
        for f, a in zip(futs, arrays):
            np.testing.assert_allclose(f.result(timeout=30), a.T @ a,
                                       atol=1e-3)
        assert eng.stats()["shed"] == 0
    finally:
        eng.shutdown()


def test_codel_sheds_unmeetable_deadlines_not_newest():
    """Once the engine has measured a batch, requests whose deadline the
    queue ahead already blows are shed at submit — the newest arrival
    with a generous deadline is still admitted."""
    rng = np.random.default_rng(11)
    eng = _engine(slots=2)
    # prime the service-time estimator with a slow measured batch
    eng.submit(_a(rng))
    with faults.inject(FaultSpec("exec_delay", delay=0.05,
                                 site="gram.engine.exec*", times=1)):
        eng.run_to_completion()
    assert eng.stats()["sec_per_work_unit"] is not None
    # backlog: 2 fill the first batch (queue ahead = 0 batches), the
    # tight-deadline 3rd is unmeetable, a deadline-less 4th still admits
    f1 = eng.submit(_a(rng), deadline_s=30.0)
    f2 = eng.submit(_a(rng), deadline_s=30.0)
    doomed = eng.submit(_a(rng), deadline_s=1e-4)
    newest = eng.submit(_a(rng))
    assert doomed.done()
    with pytest.raises(Overloaded, match="unmeetable"):
        doomed.result(timeout=1)
    assert not newest.done()
    eng.run_to_completion()
    assert [f.request.status for f in (f1, f2, newest)] == ["ok"] * 3


# ---------------------------------------------------------------------------
# Deadline- and tenant-aware scheduling
# ---------------------------------------------------------------------------

def test_edf_within_bucket_serves_tightest_deadline_first():
    rng = np.random.default_rng(12)
    eng = _engine(slots=2)
    loose = [eng.submit(_a(rng), deadline_s=100.0) for _ in range(2)]
    tight = [eng.submit(_a(rng), deadline_s=1.0) for _ in range(2)]
    done = eng.step()                       # one batch of 2
    assert {r.uid for r in done} == {f.uid for f in tight}
    assert all(not f.done() for f in loose)


def test_priority_beats_deadline_beats_fifo():
    rng = np.random.default_rng(13)
    eng = _engine(slots=1)
    fifo = eng.submit(_a(rng))
    dead = eng.submit(_a(rng), deadline_s=50.0)
    prio = eng.submit(_a(rng), priority=1)
    order = [eng.step()[0].uid for _ in range(3)]
    assert order == [prio.uid, dead.uid, fifo.uid]


def test_wfq_interleaves_tenants_instead_of_draining_flood_first():
    rng = np.random.default_rng(14)
    eng = _engine(slots=2)
    # the abuser floods one bucket first; the good tenant's two requests
    # land in another bucket afterwards
    ab = [eng.submit(_a(rng, 16, 16), tenant="abuser") for _ in range(8)]
    good = [eng.submit(_a(rng, 64, 32), tenant="good") for _ in range(2)]
    eng.step()                              # abuser (both vtimes equal)
    eng.step()                              # WFQ: good's turn
    assert all(f.done() for f in good), \
        "good tenant waited behind the whole flood"
    assert sum(f.done() for f in ab) == 2
    eng.run_to_completion()
    s = eng.stats()
    assert s["tenants"]["abuser"]["served"] == 8
    assert s["tenants"]["good"]["served"] == 2


def test_tenant_weights_bias_the_interleave():
    rng = np.random.default_rng(15)
    eng = _engine(slots=2, tenant_weights={"heavy": 4.0, "light": 1.0})
    heavy = [eng.submit(_a(rng, 16, 16), tenant="heavy")
             for _ in range(8)]
    light = [eng.submit(_a(rng, 64, 32), tenant="light")
             for _ in range(8)]
    # after 3 batches the 4x-weighted tenant should have served more
    for _ in range(3):
        eng.step()
    assert sum(f.done() for f in heavy) > sum(f.done() for f in light)
    eng.run_to_completion()


def test_tenant_max_inflight_caps_a_batch_share():
    rng = np.random.default_rng(16)
    eng = _engine(slots=4, tenant_max_inflight=2)
    [eng.submit(_a(rng), tenant="abuser") for _ in range(4)]
    good = eng.submit(_a(rng), tenant="good")
    done = eng.step()                       # 2 abuser + 1 good, not 4 abuser
    by_tenant = {}
    for r in done:
        by_tenant[r.tenant] = by_tenant.get(r.tenant, 0) + 1
    assert by_tenant == {"abuser": 2, "good": 1}
    assert good.done()
    eng.run_to_completion()


# ---------------------------------------------------------------------------
# Cancellation races + shutdown
# ---------------------------------------------------------------------------

def test_cancel_queued_request_is_terminal_and_counted():
    rng = np.random.default_rng(17)
    eng = _engine()
    fut = eng.submit(_a(rng))
    assert fut.cancel()
    assert fut.cancelled() and fut.done()
    with pytest.raises(CancelledError):
        fut.result(timeout=1)
    assert not fut.cancel()                 # second cancel: already done
    assert eng.run_to_completion() is not None
    s = eng.stats()
    assert s["cancelled"] == 1 and s["served"] == 0
    assert s["queue_depth"] == 0


def test_cancel_race_with_inflight_batch_delivers_or_cancels_exactly_once():
    """Hammer cancel() from threads while the scheduler drains slow
    batches: every future must end exactly once — delivered (cancel
    returned False) or cancelled (never both, never dropped)."""
    rng = np.random.default_rng(18)
    eng = _engine(slots=2).start()
    outcomes = []
    lock = threading.Lock()
    try:
        with faults.inject(FaultSpec("exec_delay", delay=0.02,
                                     site="gram.engine.exec*")):
            futs = [eng.submit(_a(rng)) for _ in range(24)]
            for f in futs:
                f.add_done_callback(
                    lambda g: (lock.__enter__(),
                               outcomes.append(g.uid),
                               lock.__exit__(None, None, None)))

            def hammer(fs):
                for f in fs:
                    f.cancel()
                    time.sleep(0.002)
            threads = [threading.Thread(target=hammer, args=(futs[i::3],))
                       for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
            assert eng.drain(timeout=60)
    finally:
        eng.shutdown()
    # exactly-once: every future terminal, one callback each
    assert all(f.done() for f in futs)
    assert sorted(outcomes) == sorted(f.uid for f in futs)
    statuses = {f.request.status for f in futs}
    assert statuses <= {"ok", "cancelled"}
    for f in futs:
        if f.request.status == "ok":
            assert not f.cancelled() and f.result(timeout=1) is not None
        else:
            assert f.cancelled()
    s = eng.stats()
    assert s["served"] + s["cancelled"] == 24


def test_shutdown_with_nonempty_queue_fails_pending_futures_no_hang():
    rng = np.random.default_rng(19)
    eng = _engine(slots=2).start()
    try:
        with faults.inject(FaultSpec("exec_delay", delay=0.05,
                                     site="gram.engine.exec*")):
            futs = [eng.submit(_a(rng)) for _ in range(12)]
            t0 = time.perf_counter()
            n_failed = eng.shutdown(timeout=30)
            assert time.perf_counter() - t0 < 30
    finally:
        eng.shutdown()
    assert n_failed > 0, "queue drained before shutdown could test it"
    for f in futs:
        assert f.done(), "shutdown left a future hanging"
        if f.request.status == "failed":
            with pytest.raises(EngineShutdown):
                f.result(timeout=1)
    # submits after shutdown fail fast, exceptionally
    late = eng.submit(_a(rng))
    with pytest.raises(EngineShutdown):
        late.result(timeout=1)


# ---------------------------------------------------------------------------
# Backoff cap regression (deadline_s=None must not sleep unboundedly)
# ---------------------------------------------------------------------------

def test_backoff_capped_for_deadline_less_requests():
    rng = np.random.default_rng(20)
    eng = _engine(backoff_s=0.01, max_backoff_s=0.02, max_retries=3,
                  verify="off")
    fut = eng.submit(_a(rng, 16, 16))       # no deadline
    t0 = time.perf_counter()
    with faults.inject(FaultSpec("exec_fail", site="gram.engine.exec*")):
        eng.run_to_completion()
    wall = time.perf_counter() - t0
    assert fut.request.status == "failed"
    # uncapped exponential would be 0.01*(1+2+4) = 70ms minimum and
    # grows without bound at higher retry budgets; capped is <= 3*20ms
    # plus execution overhead
    assert wall < 1.0, f"backoff not capped: {wall:.2f}s for 3 retries"


def test_backoff_unit_cap_direct():
    eng = _engine(backoff_s=0.01, max_backoff_s=0.05)
    fut = eng.submit(np.ones((16, 16), np.float32))
    t0 = time.perf_counter()
    eng._backoff(attempt=20, batch=[fut.request])   # uncapped: ~2.9h
    assert time.perf_counter() - t0 < 1.0
    eng.run_to_completion()


# ---------------------------------------------------------------------------
# Overload observability: admit/shed/deadline_miss instants + ring reuse
# ---------------------------------------------------------------------------

def test_overload_trace_has_admit_shed_and_deadline_miss_instants():
    rng = np.random.default_rng(21)
    tracer = trace.set_tracer(Tracer(enabled=True))
    try:
        eng = _engine(max_queue_per_bucket=2)
        futs = [eng.submit(_a(rng), tenant="t0") for _ in range(4)]
        late = eng.submit(_a(rng, 64, 32), tenant="t1", deadline_s=0.0)
        time.sleep(0.002)
        eng.run_to_completion()
        by_name = {}
        for e in tracer.events():
            by_name.setdefault(e.name, []).append(e)
        admits = by_name.get("admit", [])
        sheds = by_name.get("shed", [])
        misses = by_name.get("deadline_miss", [])
        assert {e.trace_id for e in admits} == {futs[0].uid, futs[1].uid,
                                                late.uid}
        assert {e.trace_id for e in sheds} == {futs[2].uid, futs[3].uid}
        assert [e.trace_id for e in misses] == [late.uid]
        # the instants carry tenant + bucket labels (the "why was this
        # shed" story in Perfetto) and the shed reason
        for e in admits + sheds + misses:
            assert e.attrs["tenant"] in ("t0", "t1")
            assert "x" in e.attrs["bucket"]
        assert all(e.attrs["reason"] == "bucket_full" for e in sheds)
        # deadline_miss is stamped at the deadline, not at detection
        assert misses[0].t0 <= time.perf_counter()
    finally:
        trace.set_tracer(None)


def test_operand_ring_reuses_buffers_in_steady_state():
    rng = np.random.default_rng(22)
    eng = _engine(slots=2, ring_depth=4)
    for _ in range(6):                      # 3 waves through one bucket
        futs = [eng.submit(_a(rng)) for _ in range(2)]
        eng.run_to_completion()
        assert all(f.request.status == "ok" for f in futs)
    ring = eng.stats()["ring"]
    assert ring["hits"] == 12 and ring["misses"] == 0
    # ring exhaustion falls back to allocation, never an error
    futs = [eng.submit(_a(rng)) for _ in range(6)]
    eng.run_to_completion()
    assert all(f.request.status == "ok" for f in futs)
    assert eng.stats()["ring"]["misses"] == 2


# ---------------------------------------------------------------------------
# tests/test_gram_overload.py: overload and fault chaos combined
# ---------------------------------------------------------------------------

def _flood(eng, rng, n, **kw):
    return [eng.submit(rng.standard_normal((20, 10)).astype(np.float32),
                       **kw) for _ in range(n)]


def test_overload_profile_queue_drains_every_request_terminal():
    """exec_delay overload (every batch stalls) + a bounded queue: the
    ladder keeps serving, admission keeps shedding, and at the end the
    queue is empty with every request in a terminal state."""
    rng = np.random.default_rng(0)
    eng = _engine(slots=2, levels=0, min_bucket=16,
                     max_queue=8, backoff_s=0.0).start()
    try:
        with faults.inject(FaultSpec("exec_delay", delay=0.02,
                                     site="gram.engine.exec.*")):
            futs = _flood(eng, rng, 40, deadline_s=30.0)
            assert eng.drain(timeout=60), "queue did not drain"
    finally:
        eng.shutdown()
    assert all(f.done() for f in futs)
    statuses = [f.request.status for f in futs]
    assert set(statuses) <= TERMINAL
    s = eng.stats()
    assert s["queue_depth"] == 0 and s["inflight"] == 0
    assert s["queue_peak"] <= 8
    assert s["served"] + s["failed"] + s["shed"] + s["cancelled"] == 40
    assert s["served"] > 0, "overload served nothing at all"
    # sheds failed FAST (admission time), not after queueing
    for f in futs:
        if f.request.status == "shed":
            with pytest.raises(Overloaded):
                f.result(timeout=1)


def test_overload_plus_crash_and_poison_chaos_still_terminates():
    """The full drill: stalls + crashes + NaN poison while submitters
    race the scheduler.  Nothing may hang; the ladder absorbs faults
    for admitted requests, the shedder bounds the queue."""
    rng = np.random.default_rng(1)
    eng = _engine(slots=2, levels=0, min_bucket=16, verify="finite",
                     max_retries=4, max_queue=12,
                     tenant_quota=8).start()
    futs, lock = [], threading.Lock()

    def submitter(tenant, n):
        local_rng = np.random.default_rng(hash(tenant) % 2**32)
        for _ in range(n):
            f = eng.submit(
                local_rng.standard_normal((20, 10)).astype(np.float32),
                tenant=tenant, deadline_s=30.0)
            with lock:
                futs.append(f)
            time.sleep(0.001)

    try:
        with faults.inject(
                FaultSpec("exec_delay", rate=0.5, delay=0.01,
                          site="gram.engine.exec.*"),
                FaultSpec("exec_fail", rate=0.1,
                          site="gram.engine.exec*"),
                FaultSpec("poison_output", rate=0.05),
                seed=3):
            threads = [threading.Thread(target=submitter,
                                        args=(f"t{i}", 15))
                       for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
            assert eng.drain(timeout=120), "queue did not drain"
    finally:
        eng.shutdown()
    assert len(futs) == 45
    assert all(f.done() for f in futs), "a future never became terminal"
    assert {f.request.status for f in futs} <= TERMINAL
    s = eng.stats()
    assert s["queue_depth"] == 0 and s["inflight"] == 0
    assert s["served"] > 0
    # per-tenant accounting adds up
    for name, ts in s["tenants"].items():
        assert ts["served"] + ts["failed"] + ts["shed"] \
            + ts["cancelled"] == ts["submitted"], (name, ts)


def test_env_profile_composes_with_overload_assertions():
    """Sanity for the CI chaos job: whatever ``REPRO_FAULTS`` is armed
    in the environment composes with a bounded engine — drain + all
    terminal (this is what the chaos job's overload profile step
    exercises under `exec_delay:site=gram.engine.exec.*`)."""
    rng = np.random.default_rng(2)
    eng = _engine(slots=2, levels=0, min_bucket=16, max_queue=16,
                     max_retries=4).start()
    try:
        futs = _flood(eng, rng, 24)
        assert eng.drain(timeout=120)
    finally:
        eng.shutdown()
    assert all(f.done() for f in futs)
    assert {f.request.status for f in futs} <= TERMINAL
    assert eng.stats()["queue_depth"] == 0
