"""The port's gradient compression (``optim/grad_compress.py``) on
``torch.distributed``, on the CPU.

One world of 4 gloo ranks (``torch.multiprocessing``, spawned once for
the file, a ``FileStore`` in a tmp dir) runs every case over the "data"
axis of ``make_gram_mesh(4, ring=1)``; each rank writes what it got and
the tests below assert in this process, against the JAX package's
``int8_quantize`` and ``lowrank_basis`` (``axis=None``, on the ranks'
gradients stacked: the all-reduced Gram is the stack's) and against the
numpy arithmetic of the collectives.  The ranks import only torch, numpy
and the port (this module's top level); the JAX package comes in the
tests' own imports.
"""
import datetime
import importlib
import json
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
WORLD_TIMEOUT_S = 120
RANK = 3
# one gradient tree a rank: a tall leaf (low rank pays: 48 > 8 + 3), a
# square-ish one and a vector (both int8), a leaf of zeros (scale 1e-30)
SHAPES = {"tall": (48, 8), "wide": (10, 8), "vec": (7,), "zero": (3, 2)}


def _grads(rank: int, it: int = 0) -> dict:
    rng = np.random.default_rng(100 * rank + it)
    out = {k: rng.standard_normal(s).astype(np.float32) * (1 + rank)
           for k, s in SHAPES.items()}
    out["zero"][:] = 0.0
    return out


def _rank_main(rank: int, world: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    from repro_torch.launch.mesh import make_gram_mesh
    from repro_torch.optim import (ErrorFeedback, compressed_psum,
                                   lowrank_basis, lowrank_psum)
    out, meta = {}, {}
    try:
        mesh = make_gram_mesh(world, ring=1, device_type="cpu")
        meta["axis"] = mesh.mesh.tolist()
        for scheme, fn, kw in (("int8", compressed_psum, {}),
                               ("lowrank", lowrank_psum,
                                dict(rank=RANK, leaf=8))):
            g0 = {k: torch.from_numpy(v) for k, v in _grads(rank).items()}
            ef = ErrorFeedback.init(g0)
            for it in range(2):
                g = {k: torch.from_numpy(v)
                     for k, v in _grads(rank, it).items()}
                red, ef = fn(g, mesh, ef, **kw)
                for k in SHAPES:
                    out[f"{scheme}/{it}/red/{k}"] = red[k].numpy()
                    out[f"{scheme}/{it}/res/{k}"] = ef.residual[k].numpy()
        basis = lowrank_basis(torch.from_numpy(_grads(rank)["tall"]), RANK,
                              leaf=8, mesh=mesh)
        out["basis"] = basis.numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(meta, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("gloo_grad_compress_world")
    t0 = time.perf_counter()
    ctx = mp.start_processes(_rank_main, args=(WORLD, str(out)),
                             nprocs=WORLD, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > WORLD_TIMEOUT_S:
                pytest.fail(f"the {WORLD}-rank world ran past "
                            f"{WORLD_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    ranks = []
    for k in range(WORLD):
        with np.load(out / f"rank{k}.npz") as z:
            ranks.append((dict(z), json.loads(
                (out / f"rank{k}.json").read_text())))
    return ranks


@pytest.fixture(scope="module")
def jgc():
    """The JAX package's grad_compress module (imported here, never at
    the module's top level, which the ranks import)."""
    return importlib.import_module("repro.optim.grad_compress")


def _quantized(jgc, x):
    import jax.numpy as jnp
    q, s = jgc.int8_quantize(jnp.asarray(x))
    return np.asarray(q), np.float32(s)


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 0.0)])
def test_int8_quantize_matches_jax_bit_for_bit(jgc, seed, scale):
    """Round half to even (``torch.round`` as ``jnp.round``), the clip at
    +-127, the scale's floor of 1e-30; ties planted at .5 of a step."""
    from repro_torch.optim import int8_dequantize, int8_quantize
    x = np.random.default_rng(seed).standard_normal((9, 13)).astype(
        np.float32) * scale
    x[0, :4] = np.float32([2.5, -2.5, 3.5, 127.0]) * np.abs(x).max() / 127
    q, s = int8_quantize(torch.from_numpy(x))
    jq, js = _quantized(jgc, x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), jq)
    assert float(s) == float(js)
    np.testing.assert_array_equal(int8_dequantize(q, s).numpy(),
                                  np.asarray(jgc.int8_dequantize(jq, js)))


def test_error_feedback_init():
    from repro_torch.optim import ErrorFeedback
    ef = ErrorFeedback.init({"a": torch.ones(3, dtype=torch.bfloat16),
                             "b": [torch.ones(2, 2)]})
    assert ef.residual["a"].dtype == torch.float32
    assert float(ef.residual["b"][0].abs().sum()) == 0


def _int8_round(jgc, grads, residuals):
    """The int8 all-reduce in numpy: each rank's (g + r) quantized by the
    JAX package's ``int8_quantize``, the scaled sum over ranks / n, and
    each rank's residual."""
    qs = [_quantized(jgc, g + r) for g, r in zip(grads, residuals)]
    total = sum(s * q.astype(np.float32) for q, s in qs) / len(qs)
    res = [(g + r) - q.astype(np.float32) * s
           for (q, s), g, r in zip(qs, grads, residuals)]
    return total, res


def test_compressed_psum_matches_the_collective(world, jgc):
    """Two rounds with error feedback: every rank's reduced leaf within
    1e-6 of max of the numpy sum (another summation order), its residual
    bit for bit; the same reduction on every rank."""
    for k in SHAPES:
        res = [np.zeros(SHAPES[k], np.float32)] * WORLD
        for it in range(2):
            grads = [_grads(r, it)[k] for r in range(WORLD)]
            want, res = _int8_round(jgc, grads, res)
            scale = max(np.abs(want).max(), 1e-30)
            for r, (arrays, _) in enumerate(world):
                got = arrays[f"int8/{it}/red/{k}"]
                assert np.abs(got - want).max() <= 1e-6 * scale, (k, it)
                np.testing.assert_array_equal(got, world[0][0][
                    f"int8/{it}/red/{k}"])
                np.testing.assert_array_equal(
                    arrays[f"int8/{it}/res/{k}"], res[r])


def test_lowrank_basis_is_the_stacked_gradients_basis(world, jgc):
    """``lowrank_basis`` through ``gram_allreduce`` over the mesh: the
    same basis on every rank, and its projector Q Q^t within 1e-4 of the
    JAX package's ``lowrank_basis(stack, axis=None)`` on the ranks'
    gradients stacked (eigenvector signs differ between LAPACKs)."""
    import jax.numpy as jnp
    stack = np.concatenate([_grads(r)["tall"] for r in range(WORLD)])
    jq = np.asarray(jgc.lowrank_basis(jnp.asarray(stack), RANK, leaf=8))
    want = jq @ jq.T
    for arrays, meta in world:
        assert meta["axis"] == [[[0], [1], [2], [3]]]
        q = arrays["basis"]
        assert q.shape == (8, RANK)
        np.testing.assert_array_equal(q, world[0][0]["basis"])
        assert np.abs(q @ q.T - want).max() <= 1e-4
        np.testing.assert_allclose(q.T @ q, np.eye(RANK), atol=1e-5)


def test_lowrank_psum_matches_the_collective(world, jgc):
    """The tall leaf: mean(G_i Q) Q^t with the shared basis and each
    rank's residual G_i - G_i Q Q^t, within 1e-5 of max; the other
    leaves take the int8 path, as in the JAX package."""
    res = {k: [np.zeros(s, np.float32)] * WORLD for k, s in SHAPES.items()}
    for it in range(2):
        for k in SHAPES:
            grads = [_grads(r, it)[k] for r in range(WORLD)]
            if k == "tall":
                gf = [g + r_ for g, r_ in zip(grads, res[k])]
                stack = np.concatenate(gf).astype(np.float64)
                _, v = np.linalg.eigh(stack.T @ stack)
                q = v[:, -RANK:]
                want = sum(g @ q for g in gf) / WORLD @ q.T
                res[k] = [g - (g @ q) @ q.T for g in gf]
                bar = 1e-5
            else:
                want, res[k] = _int8_round(jgc, grads, res[k])
                bar = 1e-6
            scale = max(np.abs(want).max(), 1e-30)
            for r, (arrays, _) in enumerate(world):
                got = arrays[f"lowrank/{it}/red/{k}"]
                assert np.abs(got - want).max() <= bar * scale, (k, it)
                r_scale = max(np.abs(res[k][r]).max(), 1e-30)
                assert np.abs(arrays[f"lowrank/{it}/res/{k}"]
                              - res[k][r]).max() <= bar * max(
                                  r_scale, scale), (k, it, r)
