"""The port's autotune cache: search, persistence, invalidation, and the
ops-default consultation path, held against the JAX package.

The port's counterparts of ``tests/test_gram_autotune.py`` (its
``test_tuned_blocks_run_correctly`` and ``test_autotune_bwd_measured``
fail on the JAX side under jax 0.9.0; the port's pass), with
``device="cpu"`` and small buckets; ``model_score`` and the candidate
grid against the JAX package's at equal constants; one cache file shared
by both packages, in which neither package's entry matches the other's
lookups; the corrupt-cache recovery (also through ``runtime.faults``,
whose copy is held to the JAX package's on the same seed).
``REPRO_AUTOTUNE_CACHE`` points at a tmp file, so the repository's cache
is never touched.
"""
import json
import math
import warnings

import numpy as np
import pytest
import torch

from repro.gram import autotune as jat
from repro.core import cost_model as jcost
from repro.runtime import faults as jfaults
from repro_torch.core import cost_model as tcost
from repro_torch.gram import autotune as at
from repro_torch.gram import stream
from repro_torch.kernels import ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.runtime import faults

CPU = dict(device="cpu")


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    path = tmp_path / "gram_autotune.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    faults.reset()
    yield path
    faults.reset()


def _resolve(kind, m, n, **blocks):
    return ops._resolve_blocks(kind, m, n, torch.float32, "cpu", **blocks)


def test_bucketing_is_pow2(tmp_cache):
    assert at.bucket_shape(100, 60) == (128, 64)
    assert at.bucket_shape(1, 1) == (32, 32)
    for m, n in ((100, 60), (1, 1), (513, 2), (10000, 10000)):
        assert at.bucket_shape(m, n) == jat.bucket_shape(m, n)
    assert at.bucket_shape(10000, 10000) == (16384, 16384)


def test_candidate_space_drops_oversized_and_refused_blocks():
    cands = at.candidate_space(64, 64, blocks=(32, 128, 512))
    assert all(c["bk"] <= 128 for c in cands)
    assert {c["mode"] for c in cands} == {"fused", "reference"}
    # edges the port's kernels refuse (not positive multiples of 8)
    cands = at.candidate_space(64, 64, blocks=(12, 16, 32))
    assert {c["bk"] for c in cands} == {16, 32}
    with pytest.raises(ValueError, match="multiple of 8"):
        at.candidate_space(64, 64, blocks=(12, 4))


@pytest.mark.parametrize("kind", ["ata", "aat", "rank_k", "ata_bwd"])
def test_candidate_space_matches_jax(kind, monkeypatch):
    # another test file run earlier in this process may have registered
    # an algebra in the JAX package's registry (tests/test_leaf_ir.py
    # does): hold both grids to the port's algebras, each of which the
    # JAX package registers too, in the same order
    from repro.core import leaf_ir as jir
    from repro_torch.core import leaf_ir as tir
    ours = tir.registered_algebras()
    assert tuple(v for v in jir.registered_algebras() if v in ours) == ours
    monkeypatch.setattr(jir, "registered_algebras", lambda: ours)
    kw = dict(blocks=(16, 32, 128), levels=(0, 1, 2), kind=kind,
              pipeline_depths=(1, 2), operand_dtypes=(None, "bfloat16"))
    assert at.candidate_space(64, 128, **kw) == \
        jat.candidate_space(64, 128, **kw)


def test_model_score_penalizes_fanin_amplification():
    base = {"mode": "fused", "variant": "strassen", "bm": 32, "bk": 32,
            "bn": 32}
    s0 = at.model_score(256, 256, {**base, "levels": 0})
    s2 = at.model_score(256, 256, {**base, "levels": 2})
    assert s2 > s0


@pytest.mark.parametrize("kind", ["ata", "aat", "rank_k", "ata_bwd"])
def test_model_score_matches_jax_at_equal_constants(kind, monkeypatch):
    """Every candidate of a grid, legacy (no pipeline knobs) and
    pipelined, fused and reference, scored as the JAX package scores it
    once the port's roofline runs at the TPU constants."""
    orig = tcost.pipelined_bytes_score

    def at_tpu(*a, **kw):
        return orig(*a, flop_rate=jcost.TPU_V5E_BF16_FLOPS,
                    hbm_bw=jcost.TPU_V5E_HBM_BW, **kw)
    monkeypatch.setattr(tcost, "pipelined_bytes_score", at_tpu)
    cands = at.candidate_space(100, 200, blocks=(16, 32, 64),
                               levels=(0, 1, 2), kind=kind,
                               operand_dtypes=(None, "float8_e4m3fn"))
    legacy = [{k: v for k, v in c.items()
               if k not in ("pipeline_depth", "operand_dtype")}
              for c in cands]
    for cand in cands + legacy:
        for in_bytes in (2, 4):
            mine = at.model_score(100, 200, cand, in_bytes=in_bytes,
                                  kind=kind)
            theirs = jat.model_score(100, 200, cand, in_bytes=in_bytes,
                                     kind=kind)
            assert math.isclose(mine, theirs, rel_tol=1e-12), cand


def test_autotune_persists_and_lookup_roundtrips(tmp_cache):
    entry = at.autotune(100, 60, blocks=(16, 32), levels=(0, 1), **CPU)
    assert tmp_cache.exists()
    raw = json.loads(tmp_cache.read_text())
    assert raw["version"] == 2 and len(raw["entries"]) == 1
    assert at.lookup(70, 33, backend="cpu") == entry
    assert at.lookup(100, 60, backend="cpu") == entry
    assert at.lookup(1000, 1000, backend="cpu") is None
    # another backend's lookup never sees a cpu winner
    assert at.lookup(100, 60, backend="cuda") is None


def test_autotune_measured_beats_model_ranking(tmp_cache):
    entry = at.autotune(32, 32, blocks=(16, 32), levels=(0, 1),
                        modes=("reference",), measure=True, **CPU)
    assert entry["source"] == "measured"
    assert entry["measured_s"] > 0


def test_autotune_measures_fused_candidates(tmp_cache):
    """The top-K fused candidates run the plain leaf program on the CPU
    and the fastest of them and the references is kept."""
    entry = at.autotune(64, 64, blocks=(16, 32), levels=(0, 1),
                        measure=True, top_k=2, **CPU)
    assert entry["source"] == "measured" and entry["measured_s"] > 0
    assert entry["mode"] in ("fused", "reference")


def test_cache_mtime_invalidation(tmp_cache):
    at.autotune(100, 60, blocks=(16,), levels=(0,), **CPU)
    assert at.lookup(100, 60, backend="cpu") is not None
    tmp_cache.write_text(json.dumps({"version": 1, "entries": {}}))
    assert at.lookup(100, 60, backend="cpu") is None


def test_refresh_overwrites_entry(tmp_cache):
    e1 = at.autotune(40, 40, blocks=(16,), levels=(0,), **CPU)
    e2 = at.autotune(40, 40, blocks=(32,), levels=(1,), **CPU)
    assert e2 == e1
    e3 = at.autotune(40, 40, blocks=(32,), levels=(1,), refresh=True, **CPU)
    assert e3["bk"] == 32 and e3["levels"] == 1


def test_ops_defaults_consult_cache(tmp_cache):
    """kernels/ops.py block defaults come from the tuned winner (and fall
    back to 256 when untuned); explicit arguments always win."""
    assert _resolve("ata", 50, 33, bk=None, bn=None) == {"bk": 256,
                                                         "bn": 256}
    at.autotune(50, 33, blocks=(16, 32), levels=(0,), **CPU)
    tuned = at.lookup(50, 33, backend="cpu")
    assert _resolve("ata", 50, 33, bk=None, bn=None) == {
        "bk": tuned["bk"], "bn": tuned["bn"]}
    assert _resolve("ata", 50, 33, bk=64, bn=None)["bk"] == 64
    assert ops._gram_blocks("ata", torch.ones(50, 33), "cpu", bk=None,
                            bn=None) == (tuned["bk"], tuned["bn"])


def test_tuned_blocks_run_correctly(tmp_cache, monkeypatch):
    """End to end: tune a bucket, then call the default-blocked fused op:
    it runs the tuned blocks and matches the oracle."""
    at.autotune(64, 32, blocks=(16,), levels=(1,), modes=("fused",), **CPU)
    from repro_torch.kernels import strassen_fused as sf
    seen = []
    real = sf.fused_ata

    def spy(a, **kw):
        seen.append((kw["bk"], kw["bn"]))
        return real(a, **kw)
    monkeypatch.setattr(sf, "fused_ata", spy)
    a = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (60, 30)).astype(np.float32))
    got = ops.ata_fused(a, levels=1, **CPU).double().numpy()
    assert seen == [(16, 16)]
    a64 = a.double().numpy()
    want = np.tril(a64.T @ a64)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_autotune_bwd_candidates(tmp_cache):
    entry = at.autotune(64, 64, kind="ata_bwd", blocks=(16, 32),
                        levels=(0, 1), **CPU)
    assert entry["mode"] == "fused"
    key_kinds = {k.split("/")[4] for k in at.load_cache()}
    assert "ata_bwd" in key_kinds
    fused_s = at.model_score(64, 64, {**entry, "mode": "fused"},
                             kind="ata_bwd")
    dense_s = at.model_score(64, 64, {**entry, "mode": "reference"},
                             kind="ata_bwd")
    assert fused_s != dense_s
    at.autotune(64, 64, kind="ata", blocks=(16,), levels=(0,), **CPU)
    bwd = at.lookup(64, 64, kind="ata_bwd", backend="cpu")
    fwd = at.lookup(64, 64, kind="ata", backend="cpu")
    assert bwd is not None and fwd is not None and bwd != fwd


def test_autotune_bwd_measured(tmp_cache):
    """measure=True times the gradient through the fused forward with the
    candidate's backward."""
    entry = at.autotune(32, 32, kind="ata_bwd", blocks=(16,), levels=(0, 1),
                        measure=True, top_k=1, **CPU)
    assert entry["source"] == "measured"
    assert entry["measured_s"] > 0


def test_cache_key_pins_torch_version_backend_and_device(tmp_cache):
    entry = at.autotune(40, 40, blocks=(16,), levels=(0,), **CPU)
    (key,) = at.load_cache()
    backend, torchseg, device, dtype, kind, shape = key.split("/")
    assert backend == "cpu" and device == "cpu"
    assert torchseg == f"torch-{torch.__version__}"
    assert (dtype, kind, shape) == ("float32", "ata", "64x64")
    assert entry["torch"] == torch.__version__
    assert entry["backend"] == "cpu" and entry["device_name"] == "cpu"


def test_v1_cache_is_ignored_wholesale(tmp_cache):
    stale_key = "cpu/float32/ata/64x64"
    tmp_cache.write_text(json.dumps({
        "version": 1,
        "entries": {stale_key: {"mode": "fused", "levels": 2,
                                "variant": "strassen", "bm": 512,
                                "bk": 512, "bn": 512,
                                "source": "measured",
                                "measured_s": 1e-9}}}))
    assert at.load_cache() == {}
    assert at.lookup(40, 40, backend="cpu") is None
    entry = at.autotune(40, 40, blocks=(16,), levels=(0,), **CPU)
    assert entry["bk"] == 16
    raw = json.loads(tmp_cache.read_text())
    assert raw["version"] == 2
    assert all("/torch-" in k for k in raw["entries"])


def test_other_toolchain_entry_never_matches(tmp_cache):
    """Entries of another torch version or another card miss; this
    toolchain's hit."""
    other = {"mode": "fused", "levels": 2, "variant": "strassen",
             "bm": 512, "bk": 512, "bn": 512}
    tmp_cache.write_text(json.dumps({"version": 2, "entries": {
        "cpu/torch-0.0.0-other/cpu/float32/ata/64x64": other,
        f"cpu/torch-{torch.__version__}/another-cpu/float32/ata/64x64":
            other}}))
    assert at.lookup(40, 40, backend="cpu") is None
    at.autotune(40, 40, blocks=(16,), levels=(0,), **CPU)
    assert at.lookup(40, 40, backend="cpu")["bk"] == 16
    assert len(at.load_cache()) == 3


def test_one_file_shared_with_the_jax_package(tmp_cache):
    """Both packages read and write one file; each keeps the other's
    entries and neither's lookup matches the other's."""
    jentry = jat.autotune(40, 40, blocks=(16,), levels=(0,), measure=False)
    assert at.lookup(40, 40, backend="cpu") is None
    mine = at.autotune(40, 40, blocks=(32,), levels=(1,), **CPU)
    assert mine["bk"] == 32 and jentry["bk"] == 16
    assert jat.lookup(40, 40) == jentry             # kept, still its own
    assert at.lookup(40, 40, backend="cpu") == mine
    jat.autotune(40, 40, kind="aat", blocks=(16,), levels=(0,),
                 measure=False)
    assert at.lookup(40, 40, backend="cpu") == mine  # kept across its write
    assert at.lookup(40, 40, kind="aat", backend="cpu") is None
    keys = json.loads(tmp_cache.read_text())["entries"]
    assert sorted(k.split("/")[1].split("-")[0] for k in keys) == \
        ["jax", "jax", "torch"]


def test_autotune_aat_kind(tmp_cache):
    entry = at.autotune(64, 32, kind="aat", blocks=(16, 32), levels=(0, 1),
                        **CPU)
    assert entry["mode"] == "fused"
    assert at.lookup(64, 32, kind="aat", backend="cpu") == entry
    assert at.lookup(64, 32, kind="ata", backend="cpu") is None
    assert _resolve("aat", 64, 32, bm=None, bk=None) == {
        "bm": entry["bm"], "bk": entry["bk"]}


def test_autotune_rank_k_kind_scores_vs_streamed_baseline(tmp_cache):
    entry = at.autotune(128, 64, kind="rank_k", blocks=(16, 32),
                        levels=(0, 1), **CPU)
    assert entry["mode"] == "fused"
    fused_s = at.model_score(128, 64, entry, kind="rank_k")
    base_s = at.model_score(128, 64, {**entry, "mode": "reference"},
                            kind="rank_k")
    assert fused_s < base_s


def test_autotune_rank_k_measured(tmp_cache):
    entry = at.autotune(32, 32, kind="rank_k", blocks=(16,), levels=(0,),
                        measure=True, top_k=1, **CPU)
    assert entry["source"] == "measured"
    assert entry["measured_s"] > 0


def test_stack_init_block_none_consults_cache(tmp_cache):
    assert stream.stack_init(40, **CPU).block == 256
    at.autotune(40, 40, kind="rank_k", blocks=(16,), levels=(0,), **CPU)
    st = stream.stack_init(40, **CPU)
    assert st.block == 16 and st.stack.shape == (6 * 16, 16)
    assert stream.stack_init(40, block=8, **CPU).block == 8


@pytest.mark.parametrize("content", ["", "{not json", "[1, 2]",
                                     '{"version": 2, "entries": [1]}',
                                     '{"version": 2, "entries": {"k": 3}}'])
def test_empty_or_corrupt_cache_gives_defaults(tmp_cache, content):
    """A cache miss, never an error: untuned 256."""
    tmp_cache.write_text(content)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert _resolve("ata", 50, 33, bk=None, bn=None) == {"bk": 256,
                                                             "bn": 256}
        assert at.load_cache() == {}


def test_entry_point_hook_rereads_the_file_once_a_second(tmp_cache,
                                                        monkeypatch):
    """The ops hook answers a bucket from memory for up to a second (a
    lookup stats the file; the recursion on kernel leaves asks per
    leaf): another process's write shows after that, this process's own
    at once; ``lookup`` itself re-reads on every mtime change."""
    assert _resolve("ata", 50, 33, bk=None, bn=None)["bk"] == 256
    entry = {"mode": "fused", "bm": 16, "bk": 16, "bn": 16}
    key = at._key("cpu", "float32", "ata", 64, 64)
    tmp_cache.write_text(json.dumps({"version": 2, "entries": {
        key: entry}}))                      # as another process would
    assert at.lookup(50, 33, backend="cpu") == entry
    assert _resolve("ata", 50, 33, bk=None, bn=None)["bk"] == 256
    monkeypatch.setattr(at, "_RESOLVE_TTL_S", 0.0)
    assert _resolve("ata", 50, 33, bk=None, bn=None)["bk"] == 16
    monkeypatch.setattr(at, "_RESOLVE_TTL_S", 3600.0)
    assert at.invalidate(50, 33, backend="cpu")
    assert _resolve("ata", 50, 33, bk=None, bn=None)["bk"] == 256


def test_kernel_leaf_hooks_read_each_leaf_shape_once(tmp_cache):
    """The recursion's leaf hooks look a leaf shape's blocks up on its
    first call only (the JAX package resolves them once a trace), and
    run the tuned ones."""
    at.autotune(64, 64, kind="matmul", blocks=(16,), levels=(0,), **CPU)
    at.autotune(64, 64, kind="ata", blocks=(16,), levels=(0,), **CPU)
    from repro_torch.kernels import _launch
    obs_metrics.reset()
    lookups = obs_metrics.counter("gram_autotune_cache_total")
    mm, sy = ops.kernel_base_matmul(), ops.kernel_base_syrk()
    x = torch.randn(40, 40, generator=torch.Generator().manual_seed(0))
    seen = []
    real = _launch.check_blocks

    def spy(kernel, **blocks):
        seen.append(blocks)
        return real(kernel, **blocks)
    try:
        _launch.check_blocks = spy
        for _ in range(3):
            torch.testing.assert_close(mm(x, x), x @ x)
            torch.testing.assert_close(sy(x), torch.tril(x.T @ x))
    finally:
        _launch.check_blocks = real
    assert lookups.value(outcome="hit") == 2      # one a hook and shape
    assert all(set(b.values()) == {16} for b in seen), seen
    mm(x[:20], x[:, :20])                          # a new shape: one more
    assert lookups.value(outcome="miss") + lookups.value(
        outcome="hit") == 3
    obs_metrics.reset()


def test_unusable_tuned_block_gives_default(tmp_cache):
    at.autotune(50, 33, blocks=(16,), levels=(0,), **CPU)
    raw = json.loads(tmp_cache.read_text())
    (key,) = raw["entries"]
    raw["entries"][key]["bk"] = 12          # not a block the port takes
    tmp_cache.write_text(json.dumps(raw))
    assert _resolve("ata", 50, 33, bk=None, bn=None) == {"bk": 256,
                                                         "bn": 16}


def test_injected_cache_corruption_degrades_once(tmp_cache):
    """An armed ``cache_corrupt`` fault truncates the file at load: one
    warning, untuned defaults, and the next autotune rewrites it."""
    at.autotune(50, 33, blocks=(16,), levels=(0,), **CPU)
    obs_metrics.reset()
    with faults.inject(faults.FaultSpec("cache_corrupt", times=1)) as reg:
        with pytest.warns(UserWarning, match="corrupt"):
            assert _resolve("ata", 50, 33, bk=None, bn=None) == {
                "bk": 256, "bn": 256}
    assert reg.count("cache_corrupt") == 1
    c = obs_metrics.counter("gram_autotune_cache_total")
    assert c.value(outcome="corrupt") == 1
    at.autotune(50, 33, blocks=(16,), levels=(0,), **CPU)
    assert _resolve("ata", 50, 33, bk=None, bn=None)["bk"] == 16
    obs_metrics.reset()


def test_cache_event_counters_track_lifecycle(tmp_cache):
    obs_metrics.reset()
    try:
        c = obs_metrics.counter("gram_autotune_cache_total")
        assert at.lookup(40, 40, backend="cpu") is None
        assert c.value(outcome="miss") == 1
        at.autotune(40, 40, blocks=(16,), levels=(0,), **CPU)
        assert c.value(outcome="persist") == 1
        assert at.lookup(40, 40, backend="cpu") is not None
        assert c.value(outcome="hit") == 1
        assert at.invalidate(40, 40, backend="cpu")
        assert c.value(outcome="invalidate") == 1
        assert not at.invalidate(40, 40, backend="cpu")
        assert c.value(outcome="invalidate") == 1
        tmp_cache.write_text(json.dumps(
            {"version": 1, "entries": {"k1": {}, "k2": {}}}))
        assert at.load_cache() == {}
        assert c.value(outcome="stale_dropped") == 2
    finally:
        obs_metrics.reset()


def test_cache_counters_survive_registry_reset(tmp_cache):
    obs_metrics.reset()
    at.lookup(40, 40, backend="cpu")
    obs_metrics.reset()
    at.lookup(40, 40, backend="cpu")
    c = obs_metrics.counter("gram_autotune_cache_total")
    assert c.value(outcome="miss") == 1
    obs_metrics.reset()


def test_device_name_cannot_split_a_key():
    key = at._key("cpu", "float32", "ata", 64, 64)
    assert len(key.split("/")) == 6


# ---------------------------------------------------------------------------
# runtime.faults: the port's copy against the JAX package's
# ---------------------------------------------------------------------------

def test_faults_public_names_match_the_jax_packages():
    assert faults.__all__ == jfaults.__all__
    assert faults.KINDS == jfaults.KINDS and faults.ENV_VAR == \
        jfaults.ENV_VAR


def test_faults_seeded_firings_and_poison_match_the_jax_packages():
    """The same seed, specs and arrays: the same firings and the same
    poisoned tile, and the input never mutated."""
    def drive(mod):
        reg = mod.FaultRegistry([mod.FaultSpec("exec_fail", rate=0.3),
                                 mod.FaultSpec("poison_output", rate=0.5,
                                               value=7.5)], seed=3)
        fired = [reg.match("exec_fail", "s") is not None for _ in range(64)]
        arr = np.zeros((3, 16, 16), np.float32)
        outs = [reg.poison("poison_output", "s", arr) for _ in range(8)]
        assert not arr.any()
        return fired, [(o[1], o[0].tobytes()) for o in outs], \
            [(e.kind, e.detail) for e in reg.events]
    assert drive(faults) == drive(jfaults)


def test_faults_profile_parsing_matches_the_jax_packages():
    prof = ("poison_output:rate=0.1,value=inf;exec_fail:rate=0.05,times=3,"
            "site=gram.*;cache_corrupt:seed=7")
    mine, theirs = faults.parse_profile(prof), jfaults.parse_profile(prof)
    assert mine.seed == theirs.seed == 7
    assert [vars(s) for s in mine.specs] == [vars(s) for s in theirs.specs]
    with pytest.raises(ValueError):
        faults.parse_profile("exec_fail:bogus=1")


def test_faults_corrupt_file_truncates_to_half(tmp_path):
    p = tmp_path / "cache.json"
    payload = json.dumps({"entries": {str(i): i for i in range(50)}})
    p.write_text(payload)
    with faults.inject(faults.FaultSpec("cache_corrupt")):
        assert faults.corrupt_file("gram.autotune.cache", p)
    assert len(p.read_text()) == len(payload) // 2
    assert not faults.corrupt_file("gram.autotune.cache", p)   # disarmed
