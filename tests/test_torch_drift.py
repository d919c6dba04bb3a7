"""The port's ``obs.drift``: the cost-model drift detector and the
engine's use of it, held against the JAX package.

The port's counterparts of ``tests/test_obs_drift.py`` (EWMA mechanics,
the wall channel's median normalization, the traffic channel's direct
band, the engine's ``invalidate_drifted``), both detectors fed the same
observations (the same findings, ratios and snapshots), and the one
deliberate difference pinned: the port's engine records no traffic
observation (the JAX engine's comes from the HLO census of a compiled
executable, which torch has no counterpart of until ``roofline/`` is
ported).  The engines run with ``device="cpu"``.
"""
import json

import numpy as np
import pytest

from repro.obs.drift import DriftDetector as JaxDriftDetector
from repro_torch.gram import GramEngine
from repro_torch.gram import autotune as at
from repro_torch.obs.drift import DriftDetector


def _feed(det, key, measured, predicted, n=4, channel="wall"):
    for _ in range(n):
        det.observe(key, measured=measured, predicted=predicted,
                    channel=channel)


def _engine(**kw):
    kw.setdefault("device", "cpu")
    return GramEngine(**kw)


# ---------------------------------------------------------------------------
# EWMA mechanics
# ---------------------------------------------------------------------------

def test_observe_returns_ewma_and_seeds_on_first_sample():
    det = DriftDetector(alpha=0.5)
    assert det.observe("k", measured=2.0, predicted=1.0) == 2.0
    # 0.5 * 2.0 + 0.5 * 4.0
    assert det.observe("k", measured=4.0, predicted=1.0) == pytest.approx(3.0)
    rec = det.record("k")
    assert rec.n == 2
    assert rec.last_measured == 4.0 and rec.last_predicted == 1.0


def test_non_positive_samples_carry_no_ratio_and_are_dropped():
    det = DriftDetector()
    assert det.observe("k", measured=0.0, predicted=1.0) is None
    assert det.observe("k", measured=1.0, predicted=-2.0) is None
    assert det.record("k") is None


def test_constructor_validates_theta_and_alpha():
    with pytest.raises(ValueError, match="theta"):
        DriftDetector(theta=1.0)
    with pytest.raises(ValueError, match="alpha"):
        DriftDetector(alpha=0.0)


# ---------------------------------------------------------------------------
# Findings
# ---------------------------------------------------------------------------

def test_wall_channel_flags_only_the_falsified_bucket():
    """Three buckets sharing a machine constant (1e-6 s/byte) but one
    that runs 20x its model: only that one is flagged."""
    det = DriftDetector(theta=2.0, min_samples=3)
    _feed(det, "64x64/float32/ata", 1.0, 1e6)
    _feed(det, "128x128/float32/ata", 4.0, 4e6)
    _feed(det, "256x256/float32/ata", 80.0, 4e6)    # falsified: 20x
    findings = det.findings("wall")
    assert [f.key for f in findings] == ["256x256/float32/ata"]
    (f,) = findings
    assert f.channel == "wall"
    assert f.ratio > f.theta
    assert f.n == 4
    assert det.stale_keys("wall") == ["256x256/float32/ata"]


def test_wall_channel_is_robust_to_whole_machine_slowdown():
    det = DriftDetector(theta=2.0, min_samples=2)
    _feed(det, "a", 10.0, 1e6)
    _feed(det, "b", 40.0, 4e6)
    _feed(det, "c", 160.0, 16e6)
    assert det.findings("wall") == []


def test_wall_channel_needs_peer_keys_to_flag():
    det = DriftDetector(theta=2.0, min_samples=2)
    _feed(det, "only", 1e9, 1.0)            # wildly off, but alone
    assert det.findings("wall") == []
    _feed(det, "peer1", 1.0, 1e6)
    _feed(det, "peer2", 1.1, 1e6)
    assert [f.key for f in det.findings("wall")] == ["only"]


def test_min_samples_gates_findings():
    det = DriftDetector(theta=2.0, min_samples=3)
    _feed(det, "ok1", 1.0, 1e6, n=3)
    _feed(det, "ok2", 1.1, 1e6, n=3)
    _feed(det, "young", 100.0, 1e6, n=2)
    assert det.findings("wall") == []
    det.observe("young", measured=100.0, predicted=1e6)
    assert [f.key for f in det.findings("wall")] == ["young"]


def test_traffic_channel_bands_directly_both_sides():
    det = DriftDetector(theta=2.0, min_samples=2)
    _feed(det, "honest", 1.1e6, 1e6, channel="traffic")
    _feed(det, "hungry", 5e6, 1e6, channel="traffic")
    _feed(det, "phantom", 1e5, 1e6, channel="traffic")
    assert {f.key for f in det.findings("traffic")} == {"hungry", "phantom"}
    assert det.findings("wall") == []


def test_reset_scopes_and_snapshot_is_json_friendly():
    det = DriftDetector(min_samples=1)
    det.observe("k1", measured=1.0, predicted=1.0, config="c1")
    det.observe("k1", measured=1.0, predicted=1.0, channel="traffic")
    det.observe("k2", measured=9.0, predicted=1.0)
    det.reset("k1", channel="wall")
    assert det.record("k1", "wall") is None
    assert det.record("k1", "traffic") is not None
    snap = json.loads(json.dumps(det.snapshot()))
    assert snap["theta"] == det.theta
    assert "k1|traffic" in snap["records"]
    assert snap["records"]["k2|wall"]["n"] == 1
    det.reset()
    assert det.snapshot()["records"] == {}


# ---------------------------------------------------------------------------
# Parity: both detectors on the same observations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta,alpha,min_samples", [(2.0, 0.25, 3),
                                                     (1.5, 0.5, 1)])
def test_same_findings_as_the_jax_detector(theta, alpha, min_samples):
    """A seeded stream of observations over six keys and both channels,
    a reset in the middle: the two detectors agree on every ratio,
    finding and snapshot."""
    rng = np.random.default_rng(7)
    dets = [cls(theta=theta, alpha=alpha, min_samples=min_samples)
            for cls in (DriftDetector, JaxDriftDetector)]
    keys = [f"{2 ** k}x{2 ** k}/float32/ata" for k in range(5, 11)]
    skew = {keys[1]: 6.0, keys[4]: 0.1}     # two falsified buckets
    for step in range(40):
        key = keys[int(rng.integers(len(keys)))]
        channel = ("wall", "traffic")[int(rng.integers(2))]
        pred = float(rng.uniform(1e5, 1e7))
        meas = pred * 1e-6 * skew.get(key, 1.0) * float(rng.uniform(0.8, 1.2))
        if channel == "traffic":
            meas *= 1e6
        if step == 20:
            for det in dets:
                det.reset(keys[0])
        got = [det.observe(key, measured=meas, predicted=pred,
                           channel=channel, step=step) for det in dets]
        assert got[0] == got[1]
    for ch in ("wall", "traffic", None):
        mine, theirs = (det.findings(ch) for det in dets)
        assert [f.as_dict() for f in mine] == [f.as_dict() for f in theirs]
    assert dets[0].snapshot() == dets[1].snapshot()
    assert dets[0].stale_keys("wall")


# ---------------------------------------------------------------------------
# The engine's drift channel
# ---------------------------------------------------------------------------

def test_engine_invalidate_drifted_drops_winner_and_history(tmp_path,
                                                            monkeypatch):
    cache = tmp_path / "gram_autotune.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(cache))
    eng = _engine(slots=2, levels=0, min_bucket=32)
    at.autotune(64, 64, blocks=(16,), levels=(0,), measure=False,
                device="cpu")
    assert at.lookup(64, 64, backend="cpu") is not None
    key = (64, 64, "float32", "cols", "native")
    _feed(eng.drift, "64x64/float32/ata", 80.0, 4e6)
    _feed(eng.drift, "128x128/float32/ata", 1.0, 1e6)
    _feed(eng.drift, "256x256/float32/ata", 1.1, 1e6)
    eng._executables[("local", key)] = object()
    eng._drift_pred_cache[(key, "fp")] = 1.0

    st = eng.stats()
    assert [f["key"] for f in st["drift"]] == ["64x64/float32/ata"]
    dropped = eng.invalidate_drifted()
    assert dropped == ["64x64/float32/ata"]
    assert at.lookup(64, 64, backend="cpu") is None
    assert ("local", key) not in eng._executables
    assert (key, "fp") not in eng._drift_pred_cache
    assert eng.drift.record("64x64/float32/ata") is None
    assert eng.stats()["drift"] == []
    assert eng.drift.record("128x128/float32/ata") is not None


def test_engine_feeds_wall_drift_from_real_serving():
    rng = np.random.default_rng(5)
    eng = _engine(slots=2, levels=0, min_bucket=16)
    for _ in range(3):
        eng.submit(rng.standard_normal((40, 20)).astype(np.float32))
    eng.run_to_completion()
    # one observation per executed batch (3 requests over 2 slots -> 2)
    rec = eng.drift.record("64x32/float32/ata")
    assert rec is not None and rec.n == 2
    assert rec.last_measured > 0 and rec.last_predicted > 0


def test_engine_wall_predictions_match_the_jax_engine():
    """The wall channel's denominator, the model's bytes for the config
    the bucket runs, is the JAX engine's for the same bucket and knobs
    (fused and reference, both grams, an autotune-free engine)."""
    from repro.gram import GramEngine as JaxGramEngine
    for mode in ("reference", "fused"):
        mine = _engine(slots=2, levels=1, mode=mode, block=16,
                       use_autotune_cache=False)
        theirs = JaxGramEngine(slots=2, levels=1, mode=mode, block=16,
                               use_autotune_cache=False)
        for key in ((64, 32, "float32", "cols", "native"),
                    (32, 64, "float32", "rows", "native"),
                    (128, 128, "bfloat16", "cols", "native")):
            got = mine._drift_prediction(key, mine._bucket_config(key))
            want = theirs._drift_prediction(key, theirs._bucket_config(key))
            assert got == pytest.approx(want, rel=1e-12), (mode, key)
            assert mine._drift_key(key) == theirs._drift_key(key)


def test_engine_records_no_traffic_observation():
    """The deliberate difference: the JAX engine's traffic channel reads
    the HLO census of each compiled executable; the port binds a program
    and compiles no HLO, so until ``roofline/`` is ported its traffic
    channel stays empty while the wall channel fills."""
    rng = np.random.default_rng(6)
    eng = _engine(slots=2, levels=1, leaf=8, min_bucket=16)
    for shape in ((40, 20), (40, 20), (20, 40), (100, 50)):
        eng.submit(rng.standard_normal(shape).astype(np.float32))
    eng.run_to_completion()
    assert eng.compile_count == 3
    assert eng.drift.ratios("traffic") == {}
    assert eng.drift.findings("traffic") == []
    assert len(eng.drift.ratios("wall")) == 3
    assert not hasattr(eng, "_observe_traffic")
