"""The port's distributed Gram schemes against the JAX package, on the CPU.

One world of 8 gloo ranks (``torch.multiprocessing``, spawned, a
``FileStore`` in a tmp dir, one thread a rank) runs every mesh of the
JAX suite's ``MESHES`` (``tests/test_distributed.py``) as a sub-mesh of
the world — the 6-rank ones leave ranks 6 and 7 out — and each rank
writes what it holds to the tmp dir; the tests below assert case by
case in this process.  Each rank keeps its local shard, so a case is
checked rank by rank: the replicated C on every rank, each block-row
shard, each ring coordinate's block stack.

The ranks import only torch and the port (this module's top level): the
JAX package is imported by the fixture that the parent's tests use.
What is held against it: ``ring_layout_coords``, ``assemble_ring_gram``,
``ring_stack_len``, ``feasible_schemes``, ``default_gram_axes``,
``scheme_fallback_chain``, ``shrink_mesh`` and one ring block task
(``strassen_matmul(a_loc, cur, trans_a=True)``); every scheme's C
against the float64 oracle at the JAX suite's bars (1e-4 fp32, 5e-2
bf16 of max|C|).
"""
import datetime
import json
import os
import time
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import cost_model, distributed as tdist
from repro_torch.core import ata_full, strassen_matmul
from repro_torch.gram import stream

WORLD = 8
AX3 = ("rep", "data", "model")
KW2 = dict(row_axis="data", col_axis="model")
KW3 = dict(row_axis="data", col_axis="model", rep_axis="rep")
KW = {1: {}, 2: KW2, 3: KW3}

# (mesh shape, axis names) per scheme: the JAX suite's MESHES — odd and
# even ring sizes T and replication factors c, with and without a
# nontrivial row axis; meshes of 6 leave ranks 6 and 7 out
MESHES = {
    "allreduce": [((8,), ("data",)), ((2, 4), ("data", "model"))],
    "reducescatter": [((8,), ("data",)), ((4,), ("data",))],
    "ring": [((2, 4), ("data", "model")), ((1, 8), ("data", "model")),
             ((2, 3), ("data", "model"))],
    "bfs25d": [((2, 1, 4), AX3), ((2, 2, 2), AX3), ((4, 1, 2), AX3),
               ((3, 1, 2), AX3), ((2, 1, 3), AX3)],
}
SCHEME_MESHES = [(s, shape, names) for s in sorted(MESHES)
                 for shape, names in MESHES[s]]
SHAPES = [(120, 48), (48, 48)]          # m=120: rows divide 1/2/3/4/8
LEVELS = (0, 1, 2)
BARS = {"float32": 1e-4, "bfloat16": 5e-2}
LAYOUT_MESHES = [("ring", (2, 4), ("data", "model")),
                 ("ring", (1, 8), ("data", "model")),
                 ("ring", (2, 3), ("data", "model")),
                 ("bfs25d", (2, 1, 4), AX3), ("bfs25d", (2, 1, 3), AX3),
                 ("bfs25d", (4, 1, 2), AX3)]
AUTO_MESHES = [((8,), ("data",)), ((2, 4), ("data", "model")),
               ((2, 2, 2), AX3)]
AUTO_SHAPES = [(512, 32), (64, 64)]
# streams: 4 ragged chunks, every size a multiple of 8 rows
CHUNKS = (40, 24, 56, 16)
STREAM_N = 48
STREAM_MESHES = {"reducescatter": ((1, 2, 4), AX3),
                 "ring": ((1, 2, 4), AX3), "bfs25d": ((2, 1, 4), AX3),
                 "sharded": ((8,), ("data",))}
SHRINK_MESHES = [(((2, 2, 2), AX3), None), (((2, 2, 2), AX3), "model"),
                 (((1, 2, 4), AX3), None), (((8,), ("data",)), None)]
WORLD_TIMEOUT_S = 240


def _tag(*parts) -> str:
    return "/".join(str(p) for p in parts)


def _input(m, n, seed=0, dtype="float32") -> np.ndarray:
    """The numpy-seeded A of a case, as the ranks and the oracle see it
    (bf16 rounded through torch, the type the ranks run)."""
    a = np.random.default_rng(seed).standard_normal((m, n)).astype(
        np.float32)
    if dtype == "bfloat16":
        a = torch.from_numpy(a).bfloat16().float().numpy()
    return a


# ---------------------------------------------------------------------------
# The rank program (runs in the spawned ranks)
# ---------------------------------------------------------------------------

class _Rank:
    """One rank's meshes and what it writes."""

    def __init__(self, rank):
        from repro_torch.launch.mesh import make_gram_mesh
        self.rank, self.out, self.meta = rank, {}, {}
        self._meshes, self._make = {}, make_gram_mesh

    def mesh(self, shape, names):
        """The sub-mesh of the world's first prod(shape) ranks (every rank
        builds it: its groups are made collectively)."""
        from torch.distributed.device_mesh import DeviceMesh
        key = (shape, names)
        if key not in self._meshes:
            size = int(np.prod(shape))
            if names == AX3:
                # through the port's make_gram_mesh: rep, rows, ring
                mesh = self._make(size, rep=shape[0], ring=shape[2],
                                  device_type="cpu")
                assert tuple(mesh.shape) == shape, (mesh.shape, shape)
            else:
                mesh = DeviceMesh("cpu", torch.arange(size).reshape(shape),
                                  mesh_dim_names=names)
            self._meshes[key] = mesh
        return self._meshes[key]

    def keep(self, tag, x):
        if isinstance(x, torch.Tensor):
            x = x.detach().double().numpy()
        self.out[tag] = x


def _run_cases(r: _Rank):
    from torch.distributed.tensor import DTensor
    # every scheme x mesh x shape x levels x dtype, against the oracle
    for scheme, shape, names in SCHEME_MESHES:
        mesh = r.mesh(shape, names)
        if mesh.get_coordinate() is None:
            continue
        for m, n in SHAPES:
            for lv in LEVELS:
                for dt in BARS:
                    a = torch.from_numpy(_input(m, n, 0, dt)).to(
                        getattr(torch, dt))
                    got = tdist.distributed_gram(a, mesh, scheme=scheme,
                                                 levels=lv, leaf=8,
                                                 **KW[len(shape)])
                    assert isinstance(got, DTensor)
                    r.keep(_tag("parity", scheme, shape, m, n, lv, dt),
                           got.to_local())
                    r.meta[_tag("parity", scheme, shape, m, n, lv, dt)] = \
                        [repr(p) for p in got.placements]
    # the half-ring layout, assemble=False
    for scheme, shape, names in LAYOUT_MESHES:
        mesh = r.mesh(shape, names)
        if mesh.get_coordinate() is None:
            continue
        a = torch.from_numpy(_input(96, 48, 1))
        got = tdist.distributed_gram(a, mesh, scheme=scheme, levels=1,
                                     leaf=8, assemble=False,
                                     **KW[len(shape)])
        r.keep(_tag("layout", scheme, shape), got.to_local())
        r.meta[_tag("layout", scheme, shape)] = {
            "coord": list(mesh.get_coordinate()),
            "global_shape": list(got.shape),
            "placements": [repr(p) for p in got.placements]}
    # the antipodal non-finite regression
    a = _input(64, 48, 2)
    a[0, 40] = np.inf                # ring column block 3 of 4
    a = torch.from_numpy(a)
    ring = r.mesh((2, 4), ("data", "model"))
    got = tdist.distributed_gram(a, ring, scheme="ring", levels=1, leaf=8,
                                 assemble=False, **KW2)
    r.keep("antipodal/ring", got.to_local())
    mesh3 = r.mesh((2, 1, 4), AX3)
    got = tdist.distributed_gram(a, mesh3, scheme="bfs25d", levels=0,
                                 leaf=8, **KW3)
    r.keep("antipodal/bfs25d", got.to_local())
    # scheme="auto" against the port's own ranking, run explicitly
    for shape, names in AUTO_MESHES:
        mesh = r.mesh(shape, names)
        kw = KW[len(shape)]
        for m, n in AUTO_SHAPES:
            a = torch.from_numpy(_input(m, n, 3))
            head = tdist.scheme_fallback_chain(m, n, mesh, **kw)[0]
            got = tdist.distributed_gram(a, mesh, scheme="auto", levels=1,
                                         leaf=8, **kw)
            want = tdist.distributed_gram(a, mesh, scheme=head, levels=1,
                                          leaf=8, **kw)
            tag = _tag("auto", shape, m, n)
            r.keep(tag, got.to_local())
            r.meta[tag] = {"head": head,
                           "equal": bool(torch.equal(got.to_local(),
                                                     want.to_local())),
                           "placements": [repr(p) for p in got.placements]}
    # the resolved scheme's profiler span
    mesh = r.mesh((2, 4), ("data", "model"))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tdist.distributed_gram(torch.from_numpy(_input(64, 64, 3)), mesh,
                               scheme="auto", levels=1, leaf=8, **KW2)
    r.meta["spans"] = sorted({e.key for e in prof.key_averages()
                              if e.key.startswith("gram_dist:")})
    # a DTensor input, sharded otherwise than the scheme wants
    from torch.distributed.tensor import Replicate, distribute_tensor
    a = torch.from_numpy(_input(120, 48, 4))
    dt_in = distribute_tensor(a, mesh, [Replicate(), Replicate()],
                              src_data_rank=None)
    got = tdist.distributed_gram(dt_in, mesh, scheme="ring", levels=1,
                                 leaf=8, **KW2)
    r.keep("dtensor_input", got.to_local())
    # the streams: 4 ragged chunks
    full = _input(sum(CHUNKS), STREAM_N, 5)
    parts = np.split(full, np.cumsum(CHUNKS)[:-1])
    for scheme in ("reducescatter", "ring", "bfs25d"):
        mesh = r.mesh(*STREAM_MESHES[scheme])
        if mesh.get_coordinate() is None:
            continue
        state = stream.distributed_init(STREAM_N, mesh, scheme=scheme)
        first = state.to_local()
        for part in parts:
            new = stream.distributed_update(
                state, torch.from_numpy(part), mesh, scheme=scheme,
                levels=1, leaf=8, rep_axis="rep")
            assert new is state          # in place: no input needs grad
        assert state.to_local().data_ptr() == first.data_ptr()
        r.keep(_tag("stream", scheme), stream.distributed_finalize(
            state, mesh, scheme=scheme).to_local())
    mesh = r.mesh(*STREAM_MESHES["sharded"])
    rows = mesh.size()
    shard = stream.sharded_init(STREAM_N, rows, device="cpu")
    k = mesh.get_coordinate()[0]
    for part in parts:
        local = torch.from_numpy(part).chunk(rows)[k]
        out = stream.update_sharded(shard, local, mesh, "data", levels=1,
                                    leaf=8)
        assert out.data_ptr() == shard.data_ptr()
    r.keep("stream/sharded", shard)
    # the mesh that survives a lost slice
    for (shape, names), axis in SHRINK_MESHES:
        small = tdist.shrink_mesh(r.mesh(shape, names), axis)
        r.meta[_tag("shrink", shape, axis)] = {
            "names": list(small.mesh_dim_names),
            "ranks": small.mesh.tolist()}


def _rank_main(rank: int, world: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    r = _Rank(rank)
    try:
        _run_cases(r)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **r.out)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(r.meta, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The parent: run the world once, then assert case by case
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("gloo_world")
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
    ranks = {}
    for k in range(WORLD):
        with np.load(out / f"rank{k}.npz") as z:
            arrays = dict(z)
        ranks[k] = NS(arrays=arrays, meta=json.loads(
            (out / f"rank{k}.json").read_text()))
    return ranks


@pytest.fixture(scope="module")
def jd():
    """The JAX package's distributed module and strassen (the parent's
    oracles; the ranks never import JAX)."""
    from repro.core import distributed
    from repro.core.strassen import strassen_matmul as jax_strassen
    return NS(dist=distributed, strassen=jax_strassen)


def _oracle(a: np.ndarray) -> np.ndarray:
    a64 = np.asarray(a, np.float64)
    return a64.T @ a64


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _ranks_of(shape):
    """Global ranks of a mesh of ``shape``, row-major (the world's first
    prod(shape))."""
    return np.arange(int(np.prod(shape))).reshape(shape)


def _coords(shape, names, rank):
    idx = np.argwhere(_ranks_of(shape) == rank)[0]
    return dict(zip(names, (int(i) for i in idx)))


def _assemble(world, tag, shape, names, scheme, n):
    """The global result of a case, from every rank's local shard, each
    replica checked equal to the first."""
    sizes = dict(zip(names, shape))
    if scheme == "reducescatter":
        rows = sizes["data"]
        parts = {}
        for k in _ranks_of(shape).flat:
            c = _coords(shape, names, k)
            loc = world[k].arrays[tag]
            parts.setdefault(c["data"], loc)
            np.testing.assert_array_equal(loc, parts[c["data"]])
        return np.concatenate([parts[i] for i in range(rows)])
    first = world[0].arrays[tag]
    for k in _ranks_of(shape).flat:
        np.testing.assert_array_equal(world[k].arrays[tag], first,
                                      err_msg=f"rank {k}")
    return first


@pytest.mark.parametrize("scheme,shape,names", SCHEME_MESHES)
def test_scheme_parity_8_ranks(world, scheme, shape, names):
    """Every scheme x mesh x levels 0-2 x fp32/bf16 x (rectangular and
    square) shape matches the float64 oracle at the JAX suite's bars,
    on every rank."""
    for m, n in SHAPES:
        for lv in LEVELS:
            for dt, bar in BARS.items():
                tag = _tag("parity", scheme, shape, m, n, lv, dt)
                got = _assemble(world, tag, shape, names, scheme, n)
                assert got.shape == (n, n)
                err = _rel(got, _oracle(_input(m, n, 0, dt)))
                assert err < bar, (tag, err)
                want = {"reducescatter": "Shard(dim=0)"}.get(scheme,
                                                            "Replicate()")
                row = names.index("data")
                assert world[0].meta[tag][row] == want, world[0].meta[tag]


@pytest.mark.parametrize("scheme,shape,names", LAYOUT_MESHES)
def test_half_ring_layout_contract(world, jd, scheme, shape, names):
    """``assemble=False``: the circulant block layout, entry by entry
    against the JAX package's ``ring_layout_coords``; the masked
    antipodal duplicates exact zeros; the stack sharded over the ring
    axis; the port's and the JAX package's ``assemble_ring_gram``
    rebuild the oracle from it, equal to each other to 1e-6."""
    m, n = 96, 48
    T = shape[-1]
    n_loc, half = n // T, T // 2
    tag = _tag("layout", scheme, shape)
    want = _oracle(_input(m, n, 1))
    assert tdist.ring_stack_len(T) == jd.dist.ring_stack_len(T) == half + 1
    coords = tdist.ring_layout_coords(T)
    assert coords == [tuple(c) for c in jd.dist.ring_layout_coords(T)]
    # every rank's stack: ring coordinate d's, the same over rows and reps
    stacks = {}
    for k in _ranks_of(shape).flat:
        meta = world[k].meta[tag]
        assert meta["global_shape"] == [half + 1, n_loc, n]
        assert meta["placements"][names.index("model")] == "Shard(dim=2)"
        d = meta["coord"][names.index("model")]
        loc = world[k].arrays[tag]
        assert loc.shape == (half + 1, n_loc, n_loc)
        stacks.setdefault(d, loc)
        np.testing.assert_array_equal(loc, stacks[d], err_msg=f"rank {k}")
    owned = set()
    for dev, s, i, j in coords:
        owned.add((dev, s))
        jdev = (dev - s) % T
        blk = want[dev * n_loc:(dev + 1) * n_loc,
                   jdev * n_loc:(jdev + 1) * n_loc]
        np.testing.assert_allclose(stacks[dev][s], blk, rtol=1e-4,
                                   atol=1e-4, err_msg=f"dev={dev} s={s}")
    for dev in range(T):
        for s in range(half + 1):
            if (dev, s) not in owned:
                assert np.all(stacks[dev][s] == 0.0), (dev, s)
    glob = np.concatenate([stacks[d] for d in range(T)], axis=2)
    mine = tdist.assemble_ring_gram(torch.from_numpy(glob).float(), T,
                                    n).double().numpy()
    theirs = np.asarray(jd.dist.assemble_ring_gram(
        np.asarray(glob, np.float32), T, n), np.float64)
    np.testing.assert_allclose(mine, theirs, rtol=0, atol=1e-6 * np.abs(
        theirs).max())
    np.testing.assert_allclose(mine, want, rtol=1e-4, atol=1e-4)


def test_assemble_ring_gram_matches_jax_on_a_numpy_stack(jd):
    """The assembly alone, on random stacks for odd and even rings."""
    for T in (1, 2, 3, 4, 5, 8):
        n_loc = 6
        glob = np.random.default_rng(T).standard_normal(
            (T // 2 + 1, n_loc, T * n_loc)).astype(np.float32)
        mine = tdist.assemble_ring_gram(torch.from_numpy(glob), T,
                                        T * n_loc).numpy()
        theirs = np.asarray(jd.dist.assemble_ring_gram(glob, T, T * n_loc))
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=1e-6)


def test_antipodal_mask_is_select_not_multiply(world):
    """An even ring's discarded antipodal slots are exact zeros though the
    discarded product holds the Inf column block, and bfs25d's merging
    reductions leave finite every entry the oracle keeps finite."""
    T, n_loc, half = 4, 12, 2
    shape = (2, 4)
    for k in _ranks_of(shape).flat:
        d = _coords(shape, ("data", "model"), k)["model"]
        if d >= half:
            assert np.all(world[k].arrays["antipodal/ring"][half] == 0.0), k
    a = _input(64, 48, 2)
    a[0, 40] = np.inf
    want = _oracle(a)
    finite = np.isfinite(want)
    assert finite[:36, :36].all()
    dense = _assemble(world, "antipodal/bfs25d", (2, 1, 4), AX3, "bfs25d", 48)
    np.testing.assert_allclose(dense[finite], want[finite], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("shape,names", AUTO_MESHES)
def test_auto_scheme_follows_the_ports_ranking(world, shape, names):
    """scheme="auto" runs the cost model's pick — bit-equal to that scheme
    run by name — and matches the oracle on 1-, 2- and 3-axis meshes."""
    kw = KW[len(shape)]
    sizes = dict(zip(names, shape))
    for m, n in AUTO_SHAPES:
        tag = _tag("auto", shape, m, n)
        meta = world[0].meta[tag]
        feas = tdist.feasible_schemes(m, n, NS(shape=sizes), **kw)
        ranked = cost_model.rank_gram_schemes(
            m, n, rows=sizes.get("data", 1), ring=sizes.get("model"),
            rep=sizes.get("rep"), schemes=feas)
        assert meta["head"] == ranked[0].scheme
        assert all(world[k].meta[tag]["equal"]
                   for k in _ranks_of(shape).flat)
        got = _assemble(world, tag, shape, names, meta["head"], n)
        assert _rel(got, _oracle(_input(m, n, 3))) < 1e-4, tag


def test_the_resolved_scheme_is_a_profiler_span(world):
    """``gram_dist:<scheme>`` names the scheme that ran, on every rank."""
    sizes = {"data": 2, "model": 4}
    feas = tdist.feasible_schemes(64, 64, NS(shape=sizes), **KW2)
    head = cost_model.choose_gram_scheme(64, 64, rows=2, ring=4,
                                         schemes=feas)
    for k in range(WORLD):
        assert world[k].meta["spans"] == [f"gram_dist:{head}"], k


def test_dtensor_input_is_redistributed(world):
    """A replicated DTensor goes in; the ring reads its own shards."""
    got = _assemble(world, "dtensor_input", (2, 4), ("data", "model"),
                    "ring", 48)
    assert _rel(got, _oracle(_input(120, 48, 4))) < 1e-4


def test_ring_block_task_matches_jax_strassen(jd):
    """One ring block task, ``a_loc^t cur`` through Strassen with the
    transpose folded, against the JAX package's
    ``strassen_matmul(a_loc, cur, trans_a=True)`` on one device."""
    a = _input(96, 48, 1)
    a_loc, cur = a[:, 12:24], a[:, 36:48]
    for lv in LEVELS:
        mine = strassen_matmul(torch.from_numpy(a_loc),
                               torch.from_numpy(cur), trans_a=True,
                               levels=lv, leaf=8, device="cpu").numpy()
        theirs = np.asarray(jd.strassen(a_loc, cur, trans_a=True, levels=lv,
                                        leaf=8))
        np.testing.assert_allclose(mine, theirs, rtol=0,
                                   atol=1e-6 * np.abs(theirs).max())


@pytest.mark.parametrize("scheme", ["reducescatter", "ring", "bfs25d",
                                    "sharded"])
def test_distributed_streams_match_one_shot(world, scheme):
    """4 ragged chunks through the stream, in place, against the one-shot
    Gram of the whole A at 1e-5 of max|C|."""
    full = _input(sum(CHUNKS), STREAM_N, 5)
    one = ata_full(torch.from_numpy(full), levels=1, leaf=8,
                   device="cpu").double().numpy()
    shape, names = STREAM_MESHES[scheme]
    if scheme == "sharded":
        got = np.concatenate([world[k].arrays["stream/sharded"]
                              for k in range(WORLD)])
    else:
        got = _assemble(world, f"stream/{scheme}", shape, names, scheme,
                        STREAM_N)
    assert got.shape == (STREAM_N, STREAM_N)
    assert _rel(got, one) <= 1e-5, scheme
    assert _rel(got, _oracle(full)) < 1e-4


@pytest.mark.parametrize("mesh_axis", SHRINK_MESHES,
                         ids=lambda p: f"{p[0][0]}-{p[1]}")
def test_shrink_mesh_matches_jax(world, jd, monkeypatch, mesh_axis):
    """The surviving mesh: the JAX package's ``shrink_mesh`` (its ``Mesh``
    constructor recorded, not run) drops the same slice of the same axis
    from the same rank grid."""
    (shape, names), axis = mesh_axis

    class _Mesh:
        def __init__(self, devices, axis_names):
            self.devices = np.asarray(devices)
            self.axis_names = tuple(axis_names)
            self.shape = dict(zip(self.axis_names, self.devices.shape))

    monkeypatch.setattr(jd.dist, "Mesh", _Mesh)
    theirs = jd.dist.shrink_mesh(_Mesh(_ranks_of(shape), names), axis)
    meta = world[0].meta[_tag("shrink", shape, axis)]
    assert tuple(meta["names"]) == theirs.axis_names == names
    np.testing.assert_array_equal(np.asarray(meta["ranks"]), theirs.devices)


def test_shrink_mesh_single_rank_is_none(jd):
    one = NS(shape={"rep": 1, "data": 1, "model": 1}, axis_names=AX3)
    assert tdist._shrink_axis(dict(one.shape), None) is None
    assert tdist.shrink_mesh(one) is None
    assert jd.dist.shrink_mesh(one) is None


# ---------------------------------------------------------------------------
# Pure functions on duck-typed meshes (no world)
# ---------------------------------------------------------------------------

DUCKS = [NS(shape={"rep": 2, "data": 2, "model": 4}, axis_names=AX3),
         NS(shape={"data": 7}, axis_names=("data",)),
         NS(shape={"data": 2}, axis_names=("data",)),
         NS(shape={"data": 2, "model": 3}, axis_names=("data", "model")),
         NS(shape={"rep": 3, "data": 1, "model": 2}, axis_names=AX3),
         NS(shape={"rep": 1, "data": 8, "model": 1}, axis_names=AX3)]
DIMS = [(64, 48), (64, 46), (63, 50), (65, 48), (120, 48), (48, 48),
        (1 << 20, 128), (512, 8192)]


@pytest.mark.parametrize("mesh", DUCKS, ids=lambda m: "x".join(
    map(str, m.shape.values())))
def test_feasible_schemes_and_axes_match_jax(jd, mesh):
    for axes in ({}, KW2, KW3, jd.dist.default_gram_axes(mesh)):
        for m, n in DIMS:
            assert tdist.feasible_schemes(m, n, mesh, **axes) == \
                jd.dist.feasible_schemes(m, n, mesh, **axes), (axes, m, n)
    assert tdist.default_gram_axes(mesh) == jd.dist.default_gram_axes(mesh)


def test_feasible_schemes_single_device_logic():
    """The JAX suite's cases, on the port."""
    mesh = NS(shape={"rep": 2, "data": 2, "model": 4})
    assert tdist.feasible_schemes(64, 48, mesh, **KW3) == \
        ["allreduce", "reducescatter", "ring", "bfs25d"]
    assert tdist.feasible_schemes(64, 46, mesh, **KW3) == \
        ["allreduce", "reducescatter"]
    assert tdist.feasible_schemes(63, 50, NS(shape={"data": 7})) == \
        ["allreduce"]
    assert tdist.feasible_schemes(65, 48, NS(shape={"data": 2})) == []
    assert "ring" not in tdist.feasible_schemes(
        64, 48, NS(shape={"data": 2}), col_axis="model")


def test_default_gram_axes_never_duplicates_row_as_col(jd):
    for names in (("model",), ("rep", "model"), AX3, ("x", "y"),
                  ("data",), ("rep", "data")):
        mesh = NS(axis_names=names)
        assert tdist.default_gram_axes(mesh) == \
            jd.dist.default_gram_axes(mesh), names
    ax = tdist.default_gram_axes(NS(axis_names=("model",)))
    assert ax["row_axis"] == "model" and ax["col_axis"] is None


def test_scheme_fallback_chain_matches_jax(jd):
    """Named schemes give the JAX package's chain; under "auto" the head
    is the port's cost-model pick and the rest is the same ladder."""
    for mesh in DUCKS:
        axes = jd.dist.default_gram_axes(mesh)
        for m, n in DIMS:
            for scheme in ("allreduce", "reducescatter", "ring", "bfs25d",
                           "nope"):
                assert tdist.scheme_fallback_chain(
                    m, n, mesh, scheme=scheme, **axes) == \
                    jd.dist.scheme_fallback_chain(m, n, mesh, scheme=scheme,
                                                  **axes)
            mine = tdist.scheme_fallback_chain(m, n, mesh, **axes)
            theirs = jd.dist.scheme_fallback_chain(m, n, mesh, **axes)
            assert sorted(mine) == sorted(theirs)
            if mine:
                sizes = dict(mesh.shape)
                head = cost_model.choose_gram_scheme(
                    m, n, rows=sizes.get(axes["row_axis"], 1),
                    ring=sizes.get(axes["col_axis"]) if axes["col_axis"]
                    else None,
                    rep=sizes.get(axes["rep_axis"]) if axes["rep_axis"]
                    else None, schemes=mine)
                assert mine[0] == head
                assert mine[1:] == [s for s in tdist.SCHEME_LADDER
                                    if s in mine and s != head]
    assert tdist.SCHEME_LADDER == jd.dist.SCHEME_LADDER


def test_refusals_outside_a_world():
    """A rank outside the mesh is refused by the schemes; a mesh needs a
    process group (the ranks above are other processes)."""
    from repro_torch.launch.mesh import make_gram_mesh

    class Outside:
        mesh_dim_names = ("data",)
        shape = (4,)
        mesh = torch.arange(4)

        def get_coordinate(self):
            return None
    with pytest.raises(ValueError, match="not in the mesh"):
        tdist._coords(Outside())
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_gram_mesh(device_type="cpu")
