"""The port's Gram engine on a ``torch.distributed`` mesh, on the CPU.

One world of 4 gloo ranks (``torch.multiprocessing``, spawned once for
the file, a ``FileStore`` in a tmp dir) runs every case; each rank
writes what it served and the tests below assert in this process.  The
port's counterparts of the JAX suite's multi-device engine cases
(``test_engine_routes_large_buckets_to_mesh``,
``test_mesh_shrink_falls_back_through_schemes``), at 4 ranks where the
JAX suite emulates 8 devices: every rank submits the same trace and
serves it through ``run_to_completion`` (a multi-rank mesh is SPMD and
synchronous; ``start()`` refuses it), and a one-rank mesh serves through
the background scheduler.  The ranks import only torch, numpy and the
port (this module's top level).
"""
import datetime
import json
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import ata_full
from repro_torch.gram import GramEngine
from repro_torch.runtime import faults
from repro_torch.runtime.faults import FaultSpec

WORLD = 4
WORLD_TIMEOUT_S = 120
BIG, SMALL = (120, 60), (20, 12)        # buckets 128x64 and 32x16


def _input(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _served(eng, arrays):
    uids = [eng.submit(a).uid for a in arrays]
    done = {r.uid: r for r in eng.run_to_completion()}
    return [done[u] for u in uids]


def _record(r):
    return {"status": r.status, "served_by": r.served_by,
            "degraded": r.degraded, "error": r.error}


def _run_cases(rank, out, meta):
    from repro_torch.launch.mesh import make_gram_mesh
    # routing: (rep 1, data 2, model 2); the big bucket on the mesh, the
    # small one on the local slot-batched path
    mesh = make_gram_mesh(WORLD, ring=2, device_type="cpu")
    eng = GramEngine(slots=2, levels=1, leaf=8, min_bucket=16, mesh=mesh,
                     dist_threshold=128 * 64, device="cpu")
    big, small = _input(BIG, 8), _input(SMALL, 9)
    rb, rs = _served(eng, [big, small])
    out["route/big"], out["route/small"] = rb.result, rs.result
    st = eng.stats()
    meta["route"] = {"big": _record(rb), "small": _record(rs),
                     "dist_served": st["dist_served"],
                     "buckets": [list(k) for k in st["buckets"]],
                     "distributed": [list(k) for k in
                                     st["distributed_buckets"]]}
    try:
        eng.start()
        meta["start"] = "started"
        eng.shutdown(timeout=5)
    except RuntimeError as e:
        meta["start"] = str(e)

    # the shrink drill: (rep 2, data 1, model 2), bfs25d pinned
    mesh = make_gram_mesh(WORLD, rep=2, ring=2, device_type="cpu")
    eng = GramEngine(slots=2, levels=1, leaf=8, min_bucket=16, mesh=mesh,
                     dist_scheme="bfs25d", dist_threshold=128 * 64,
                     verify=2, max_retries=6, breaker_threshold=1,
                     device="cpu")
    a1, a2 = _input(BIG, 10), _input(BIG, 11)
    (r1,) = _served(eng, [a1])
    with faults.inject(FaultSpec("mesh_shrink", times=1),
                       FaultSpec("exec_fail", site="*bfs25d*")) as reg:
        (r2,) = _served(eng, [a2])
    out["shrink/1"], out["shrink/2"] = r1.result, r2.result
    st = eng.stats()
    meta["shrink"] = {"r1": _record(r1), "r2": _record(r2),
                      "shrinks": reg.count("mesh_shrink"),
                      "mesh_changes": st["mesh_changes"],
                      "in_mesh": eng.mesh.get_coordinate() is not None,
                      "mesh": eng.mesh.mesh.tolist(),
                      "served": st["served"], "failed": st["failed"]}

    # a one-rank mesh per rank (every rank builds all four: the groups
    # are made collectively), served through the background scheduler
    ones = [make_gram_mesh(ranks=[k], device_type="cpu")
            for k in range(WORLD)]
    eng = GramEngine(slots=2, levels=1, leaf=8, min_bucket=16,
                     mesh=ones[rank], dist_scheme="allreduce",
                     dist_threshold=128 * 64, device="cpu")
    a3 = _input((128, 64), 12 + rank)
    try:
        eng.start()
        futs = [eng.submit(a3), eng.submit(_input(SMALL, 20 + rank))]
        got = [f.result(timeout=60) for f in futs]
        meta["one"] = {"drained": eng.drain(timeout=60),
                       "served_by": [f.request.served_by for f in futs]}
    finally:
        eng.shutdown(timeout=10)
    out["one/big"], out["one/small"] = got
    out["one/ata_full"] = ata_full(torch.from_numpy(a3), levels=1, leaf=8,
                                   device="cpu").numpy()


def _rank_main(rank: int, world: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    out, meta = {}, {}
    try:
        _run_cases(rank, out, meta)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(meta, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("gloo_engine_world")
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
            arrays = dict(z)
        ranks.append((arrays, json.loads((out / f"rank{k}.json").read_text())))
    return ranks


def _rel(got, a):
    a64 = a.astype(np.float64)
    want = a64.T @ a64
    return np.abs(got - want).max() / np.abs(want).max()


def test_large_buckets_route_to_the_mesh(world):
    """The big bucket serves through ``distributed_gram`` (scheme "auto",
    the cost model's pick), the small one on the local path; both within
    1e-4 of float64 and symmetric, the same on every rank."""
    for arrays, meta in world:
        route = meta["route"]
        assert route["big"]["status"] == route["small"]["status"] == "ok"
        assert route["big"]["served_by"].startswith("dist:")
        assert route["small"]["served_by"] == "local"
        assert route["dist_served"] == 1
        assert route["distributed"] == [[128, 64, "float32", "cols",
                                         "native"]]
        assert [32, 16, "float32", "cols", "native"] in route["buckets"]
        for tag, shape, seed in (("big", BIG, 8), ("small", SMALL, 9)):
            got = arrays[f"route/{tag}"]
            assert _rel(got, _input(shape, seed)) < 1e-4, tag
            np.testing.assert_allclose(got, got.T, rtol=1e-5)
        assert np.array_equal(arrays["route/big"], world[0][0]["route/big"])


def test_start_refuses_a_multi_rank_mesh(world):
    for _, meta in world:
        assert "more than one rank" in meta["start"]


def test_mesh_shrink_falls_back_through_schemes(world):
    """bfs25d over (rep 2, data 1, model 2); then a shrink drops the
    first replica group and bfs25d fails: on the surviving ranks the
    next request takes one rung down the chain (``dist:ring``, degraded)
    on the (1, 1, 2) mesh; the dropped ranks hold the whole A and serve
    it locally.  Every result within 1e-4 of float64."""
    for k, (arrays, meta) in enumerate(world):
        sh = meta["shrink"]
        assert sh["r1"]["served_by"] == "dist:bfs25d"
        assert sh["shrinks"] == 1 and sh["mesh_changes"] == 1
        assert sh["mesh"] == [[[2, 3]]]
        assert sh["in_mesh"] == (k >= 2)
        if k >= 2:
            assert sh["r2"]["served_by"] == "dist:ring"
            assert sh["r2"]["degraded"]
        else:
            assert sh["r2"]["served_by"] == "local"
        assert sh["served"] == 2 and sh["failed"] == 0
        assert _rel(arrays["shrink/1"], _input(BIG, 10)) < 1e-4
        assert _rel(arrays["shrink/2"], _input(BIG, 11)) < 1e-4


def test_one_rank_mesh_serves_through_the_scheduler(world):
    """On a one-rank mesh the background scheduler runs: the bucket-sized
    request (no padding) is routed to ``distributed_gram`` and equals
    ``ata_full`` of the same A bit for bit; the small one stays local."""
    for k, (arrays, meta) in enumerate(world):
        assert meta["one"]["drained"]
        assert meta["one"]["served_by"] == ["dist:allreduce", "local"]
        assert np.array_equal(arrays["one/big"], arrays["one/ata_full"])
        assert _rel(arrays["one/small"], _input(SMALL, 20 + k)) < 1e-4
