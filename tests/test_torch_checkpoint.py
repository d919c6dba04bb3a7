"""The port's checkpoints (``repro_torch.checkpoint``) and its
crash-recoverable streamed Gram (``gram.CheckpointedGramStream``), on
the CPU, against the JAX package's.

The two packages share one format: a checkpoint written by either loads
in the other, leaf for leaf (bf16 through its ``__bf16__`` uint16 tag),
and a stream the JAX package committed resumes in the port bit for bit.
A resumed stream must end bit-equal to the uninterrupted one (fp addition
is order-sensitive; the checkpoint keeps the order); a stream resumed
across packages within 1e-5 of max|C| of the JAX package's uninterrupted
run (the two packages sum each chunk's Gram in their own order).
"""
import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.checkpoint import CheckpointManager as JaxManager
from repro.checkpoint import load_pytree as jax_load
from repro.checkpoint import save_pytree as jax_save
from repro.gram.stream import CheckpointedGramStream as JaxStream
from repro_torch.checkpoint import (CheckpointManager, load_pytree,
                                    manager, save_pytree)
from repro_torch.gram import CheckpointedGramStream
from repro_torch.obs import metrics


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
    ``CompilerParams``; the JAX fused executor (the stack stream's) still
    uses the old name.  Alias it for the duration of one test only."""
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)


def _tree():
    """Nested dicts, lists and a tuple, with fp32, bf16, fp16, int32 and
    0-d leaves."""
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(4, 3, generator=g),
                       "b": torch.randn(3, generator=g).bfloat16()},
            "layers": [{"scale": torch.randn(2, generator=g).half()},
                       {"scale": torch.arange(5, dtype=torch.int32)}],
            "pair": (torch.tensor(7, dtype=torch.int32),
                     np.arange(6, dtype=np.float32).reshape(2, 3)),
            "rows": torch.zeros((), dtype=torch.int32)}


def _flat(tree, path=""):
    """{path: numpy leaf} of a tree, bf16 as float32 (exact), sequences as
    lists, for comparisons across packages."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}/#{i}"))
        return out
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            return {path: ("bfloat16", tree.float().numpy())}
        return {path: (str(tree.dtype).removeprefix("torch."), tree.numpy())}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return {path: ("bfloat16", arr.astype(np.float32))}
    return {path: (arr.dtype.name, arr)}


def _same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k][0] == fb[k][0], (k, fa[k][0], fb[k][0])
        np.testing.assert_array_equal(fa[k][1], fb[k][1])


def test_pytree_round_trip(tmp_path):
    tree = _tree()
    save_pytree(tree, str(tmp_path / "s.npz"))
    back = load_pytree(str(tmp_path / "s.npz"))
    _same(back, tree)
    assert isinstance(back["pair"], list)
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
               for x in (back["params"]["w"], back["params"]["b"],
                         back["pair"][1]))
    assert back["params"]["b"].dtype == torch.bfloat16


def test_pytree_keys_are_the_jax_packages(tmp_path):
    """The npz keys follow ``jax.tree_util``'s paths: '/'-joined dict
    keys, ``#i`` for sequence items, the bf16 tag in front."""
    tree = _tree()
    save_pytree(tree, str(tmp_path / "t.npz"))
    jax_tree = {"params": {"w": jnp.asarray(tree["params"]["w"].numpy()),
                           "b": jnp.asarray(tree["params"]["b"].float()
                                            .numpy()).astype(jnp.bfloat16)},
                "layers": [{"scale": jnp.asarray(
                    tree["layers"][0]["scale"].numpy())},
                    {"scale": jnp.arange(5, dtype=jnp.int32)}],
                "pair": (jnp.int32(7), tree["pair"][1]),
                "rows": jnp.zeros((), jnp.int32)}
    jax_save(jax_tree, str(tmp_path / "j.npz"))
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        assert "__bf16__params/b" in t.files and "pair/#1" in t.files
        for key in t.files:
            assert t[key].dtype == j[key].dtype, key
            np.testing.assert_array_equal(t[key], j[key])


def test_port_checkpoint_loads_in_jax(tmp_path):
    tree = _tree()
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    mgr.save(3, tree, extra={"note": "port"})
    state, meta = JaxManager(str(tmp_path)).restore()
    assert meta["step"] == 3 and meta["note"] == "port"
    _same(state, tree)
    _same(jax_load(str(tmp_path / "step_00000003" / "state.npz")), tree)


def test_jax_checkpoint_loads_in_port(tmp_path):
    tree = {"a": jnp.arange(6.0).reshape(2, 3),
            "b": [jnp.ones(3, jnp.bfloat16), {"c": jnp.int32(4)}],
            "d": jnp.asarray([1.5, -2.25], jnp.float16)}
    JaxManager(str(tmp_path), async_save=False).save(5, tree,
                                                     extra={"x": 1})
    state, meta = CheckpointManager(str(tmp_path)).restore()
    assert meta["step"] == 5 and meta["x"] == 1
    _same(state, tree)
    assert state["b"][0].dtype == torch.bfloat16
    assert state["d"].dtype == torch.float16


def test_manager_keep_k_and_atomic_commit(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for step in (1, 2, 3, 4):
        mgr.save(step, {"x": torch.full((3,), float(step))})
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    state, meta = mgr.restore()
    assert meta["step"] == 4 and torch.equal(state["x"], torch.full((3,), 4.))
    state, _ = mgr.restore(3)
    assert torch.equal(state["x"], torch.full((3,), 3.))
    # a torn write (a .tmp directory, no rename) is never a step
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert mgr.latest_step() == 4
    assert CheckpointManager(str(tmp_path / "empty")).restore() == (None,
                                                                     None)


def test_manager_async_snapshot_and_errors(tmp_path, monkeypatch):
    """``save`` snapshots before the writer starts: a tensor updated in
    place right after is saved as it was.  An async failure is re-raised
    by the next ``save``, once, and leaves no step behind."""
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    x = torch.zeros(1000)
    mgr.save(1, {"x": x, "l": [x]})
    x.add_(1.0)                        # the stream's in-place update
    mgr.wait()
    state, _ = mgr.restore(1)
    assert float(state["x"].abs().max()) == 0.0
    assert float(state["l"][0].abs().max()) == 0.0

    def full_disk(file, **entries):
        raise OSError("no space left on device")

    real = manager.np.savez
    monkeypatch.setattr(manager.np, "savez", full_disk)
    mgr.save(2, {"x": x})              # fails on the writer thread
    mgr.wait()
    monkeypatch.setattr(manager.np, "savez", real)
    with pytest.raises(OSError, match="no space"):
        mgr.save(3, {"x": x})
    assert mgr.all_steps() == [1]
    mgr.save(4, {"x": x})              # the error was raised once
    mgr.wait()
    assert mgr.all_steps() == [1, 4]
    assert torch.equal(mgr.restore()[0]["x"], torch.ones(1000))


def test_restore_skips_corrupt_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    mgr.save(1, {"x": torch.arange(4)})
    mgr.save(2, {"x": torch.arange(8)})
    npz = tmp_path / "step_00000002" / "state.npz"
    npz.write_bytes(b"not a zipfile")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        state, meta = mgr.restore()
    assert meta["step"] == 1 and torch.equal(state["x"], torch.arange(4))
    assert any("unreadable" in str(x.message) for x in w)
    with pytest.raises(Exception):
        mgr.restore(2)                 # an explicit step still raises
    (tmp_path / "step_00000001" / "meta.json").write_text("{torn")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert mgr.restore() == (None, None)


# -- the crash-recoverable stream ------------------------------------------

def _chunks():
    rng = np.random.default_rng(8)
    return [rng.standard_normal((6, 12)).astype(np.float32)
            for _ in range(7)]


@pytest.mark.parametrize("layout,kw", [
    ("packed", dict(levels=1, leaf=8)),
    ("packed", dict(levels=1, mode="fused")),
    ("stack", dict(levels=1, block=8)),
])
def test_stream_resumes_bit_exact_after_kill(tmp_path, layout, kw):
    chunks = _chunks()
    s_ref = CheckpointedGramStream(12, str(tmp_path / "ref"), every=2,
                                   layout=layout, device="cpu", **kw)
    for c in chunks:
        s_ref.update(c)
    ref = s_ref.finalize(guard=True)

    # "crash" after 5 chunks: last commit at chunk 4, chunk 5 lost
    wd = str(tmp_path / "wal")
    s1 = CheckpointedGramStream(12, wd, every=2, layout=layout,
                                device="cpu", **kw)
    for c in chunks[:5]:
        s1.update(c)
    del s1

    s2 = CheckpointedGramStream(12, wd, every=2, layout=layout,
                                device="cpu", **kw)
    assert s2.resumed and s2.next_chunk == 4
    for i, c in enumerate(chunks):
        if i < s2.next_chunk:
            continue
        s2.update(c)
    out = s2.finalize()
    assert out.dtype == ref.dtype and out.shape == (12, 12)
    assert torch.equal(ref, out), "resumed stream is not bit-exact"
    want = np.concatenate(chunks).astype(np.float64)
    want = want.T @ want
    assert np.abs(out.double().numpy() - want).max() <= \
        5e-5 * np.abs(want).max()


def test_stream_checkpoint_rejects_mismatched_geometry(tmp_path):
    s = CheckpointedGramStream(12, str(tmp_path), every=1, levels=0,
                               device="cpu")
    s.update(np.ones((4, 12), np.float32))
    with pytest.raises(ValueError, match="n=12"):
        CheckpointedGramStream(16, str(tmp_path), every=1, levels=0,
                               device="cpu")
    with pytest.raises(ValueError, match="packed"):
        CheckpointedGramStream(12, str(tmp_path), layout="stack",
                               device="cpu")
    with pytest.raises(ValueError, match="layout"):
        CheckpointedGramStream(12, str(tmp_path / "x"), layout="dense",
                               device="cpu")
    with pytest.raises(ValueError, match="every"):
        CheckpointedGramStream(12, str(tmp_path / "y"), every=0,
                               device="cpu")


@pytest.mark.parametrize("layout,kw", [
    ("packed", dict(levels=1, leaf=8)),
    ("stack", dict(levels=1, block=8)),
])
def test_jax_committed_stream_resumes_in_port(pallas_compiler_params,
                                              tmp_path, layout, kw):
    """The JAX package streams 5 of 7 chunks and commits at chunk 4; the
    port restores that state bit for bit, feeds chunks 4-6 and ends within
    1e-5 of max|C| of the JAX package's uninterrupted run."""
    chunks = _chunks()
    jkw = dict(kw, interpret=True) if layout == "stack" else kw
    j_ref = JaxStream(12, str(tmp_path / "ref"), every=2, layout=layout,
                      **jkw)
    for c in chunks:
        j_ref.update(c)
    ref = np.asarray(j_ref.finalize(), np.float64)

    wd = str(tmp_path / "wal")
    j1 = JaxStream(12, wd, every=2, layout=layout, **jkw)
    for c in chunks[:5]:
        j1.update(c)
    key = "packed" if layout == "packed" else "stack"
    committed = np.asarray(JaxManager(wd).restore()[0][key])
    del j1

    s = CheckpointedGramStream(12, wd, every=2, layout=layout,
                               device="cpu", **kw)
    assert s.resumed and s.next_chunk == 4
    state = s.state.packed if layout == "packed" else s.state.stack
    np.testing.assert_array_equal(state.numpy(), committed)
    assert s.state.rows.dtype == torch.int32 and int(s.state.rows) == 24
    for c in chunks[4:]:
        s.update(c)
    out = s.finalize()
    assert np.abs(out.double().numpy() - ref).max() <= \
        1e-5 * np.abs(ref).max()
    # and the port's own commit of chunk 6 loads back in the JAX package
    state, meta = JaxManager(wd).restore()
    assert meta["chunks"] == 7 and meta["layout"] == layout
    np.testing.assert_array_equal(
        np.asarray(state[key]),
        (s.state.packed if layout == "packed" else s.state.stack).numpy())


def test_commits_are_counted_and_traced(tmp_path):
    counter = metrics.counter("gram_stream_commits_total",
                              "checkpoint commits of streamed Gram state")
    before = counter.value(layout="packed")
    s = CheckpointedGramStream(12, str(tmp_path), every=2, levels=0,
                               device="cpu")
    for c in _chunks()[:5]:
        s.update(c)
    assert counter.value(layout="packed") == before + 2
    s.commit()                               # chunk 5 was dirty
    s.commit()                               # clean: no commit
    s.finalize()
    assert counter.value(layout="packed") == before + 3
    meta = json.loads((tmp_path / "step_00000005" / "meta.json").read_text())
    assert meta["chunks"] == 5 and meta["n"] == 12
