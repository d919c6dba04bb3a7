"""The port's cost model against the JAX package's.

``repro_torch.core.cost_model`` is the JAX package's pure-math module
with the TPU v5e constants replaced by the H100's: every public function
is held against ``repro.core.cost_model`` at equal constants over a grid
of (m, n, R, T, c, dtype bytes, levels, variant), to 1e-12 relative; the
JAX suite's eleven communication-model properties
(``tests/test_comm_cost.py``) hold again at the H100 defaults; and the
rankings that the H100 constants change are pinned to the port's.
"""
import itertools
import math

import pytest

from repro.core import cost_model as jc
from repro_torch.core import cost_model as tc
from repro_torch.core.cost_model import (GRAM_SCHEMES, GramCommCost,
                                         choose_gram_scheme, gram_comm_cost,
                                         rank_gram_schemes)

# the TPU v5e constants, passed to both sides where a rate is a knob
TPU = dict(alpha=jc.TPU_V5E_ICI_LATENCY, bw=jc.TPU_V5E_ICI_BW,
           flops=jc.TPU_V5E_BF16_FLOPS, hbm=jc.TPU_V5E_HBM_BW)


def _same(a, b):
    """Equal ints, or floats equal to 1e-12 relative."""
    if isinstance(a, int) and isinstance(b, int):
        return a == b
    return math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0)


def test_public_names_are_the_jax_packages_less_the_tpu_constants():
    def public(mod, hw):
        return {k for k in vars(mod) if not k.startswith("_")
                and not k.startswith(hw) and k not in ("annotations",
                                                       "math", "dataclass")}
    assert public(tc, "H100_") == public(jc, "TPU_")
    assert tc.LOG2_7 == jc.LOG2_7 and tc.GRAM_SCHEMES == jc.GRAM_SCHEMES
    assert vars(tc.SimParams()) == vars(jc.SimParams())   # Galileo's


def test_h100_constants_are_the_data_sheets():
    assert tc.H100_FP32_FLOPS == 67e12
    assert tc.H100_TC16_FLOPS == 989e12
    assert tc.H100_HBM_BW == 3.35e12
    assert tc.H100_NVLINK_BW == 450e9
    assert 0 < tc.H100_LINK_LATENCY < 1e-4
    assert not any(k.startswith("TPU") for k in vars(tc))


NS = (1, 2, 31, 32, 33, 100, 257, 1000, 10000)


@pytest.mark.parametrize("fn", ["strassen_mults", "ata_mults_bound",
                                "classical_matmul_mults", "bandwidth_words",
                                "classical_ata_mults"])
def test_closed_forms(fn):
    for n in NS:
        assert _same(getattr(tc, fn)(n), getattr(jc, fn)(n)), (fn, n)
    for m, n in itertools.product(NS, NS[:5]):
        assert _same(tc.classical_ata_mults(n, m), jc.classical_ata_mults(
            n, m))
        assert _same(tc.classical_ata_bwd_mults(m, n),
                     jc.classical_ata_bwd_mults(m, n))


SHAPES = [(1, 1), (33, 17), (64, 64), (100, 60), (256, 512), (1000, 777),
          (4096, 128)]


@pytest.mark.parametrize("leaf", [8, 32, 256])
def test_exact_counts(leaf):
    for (m, n), levels in itertools.product(SHAPES, (None, 0, 1, 2, 3)):
        kw = dict(leaf=leaf, levels=levels)
        assert tc.ata_mults_exact(m, n, **kw) == jc.ata_mults_exact(m, n,
                                                                     **kw)
        assert tc.aat_mults_exact(m, n, **kw) == jc.aat_mults_exact(m, n,
                                                                     **kw)
        assert tc.ata_bwd_mults_exact(m, n, **kw) == \
            jc.ata_bwd_mults_exact(m, n, **kw)
        assert tc.strassen_mults_exact(m, n, m, **kw) == \
            jc.strassen_mults_exact(m, n, m, **kw)
        for gram_of in ("cols", "rows"):
            assert tc.gram_serve_work(m, n, gram_of=gram_of, **kw) == \
                jc.gram_serve_work(m, n, gram_of=gram_of, **kw)


@pytest.mark.parametrize("variant", ["strassen", "winograd", "classical",
                                     "bb322", "bb422"])
def test_leaf_ir_counts(variant):
    for levels in range(4):
        for kind in ("matmul", "symm", "ata", "aat", "rank_k"):
            for gram in ("strassen", "dps"):
                assert tc.ir_leaf_count(kind, levels, variant, gram) == \
                    jc.ir_leaf_count(kind, levels, variant, gram)
                assert tc.ir_max_terms(kind, levels, variant, gram) == \
                    jc.ir_max_terms(kind, levels, variant, gram)
        assert tc.symm_leaf_count(levels, variant) == jc.symm_leaf_count(
            levels, variant)
        from repro_torch.core.leaf_ir import algebra_dims
        dm, _dk, dn = algebra_dims(variant)
        m, n = 5 * dm ** levels, 3 * dn ** levels
        assert tc.symm_mults_exact(m, n, levels, variant) == \
            jc.symm_mults_exact(m, n, levels, variant)
    with pytest.raises(ValueError):
        tc.ir_leaf_count("nope", 1, variant)


def test_process_tree_and_comm_terms():
    for p in range(0, 300):
        assert tc.lmax(p) == jc.lmax(p) and tc.latency_messages(p) == \
            jc.latency_messages(p)
    for level in range(6):
        assert tc.npl(level) == jc.npl(level)
    for n, p in itertools.product((64, 1000, 10000), (1, 6, 12, 48, 250)):
        for alpha, beta in ((2e-6, 1.3e-9), (1e-5, 1e-10)):
            assert _same(tc.comm_time(n, p, alpha, beta),
                         jc.comm_time(n, p, alpha, beta))


@pytest.mark.parametrize("n", [1000, 10000])
def test_parallel_model_and_simulator(n):
    for t1, frac in ((100.0, 0.004), (3.5, 0.05)):
        mine = tc.ParallelModel(t1=t1, n=n, serial_frac=frac)
        theirs = jc.ParallelModel(t1=t1, n=n, serial_frac=frac)
        for p in (1, 2, 6, 7, 12, 18, 36, 48, 250, 1000):
            for meth in ("critical_path_fraction", "time", "speedup",
                         "efficiency"):
                assert _same(getattr(mine, meth)(p),
                             getattr(theirs, meth)(p)), (meth, p)
            if p > 1:
                assert _same(mine.karp_flatt(p), theirs.karp_flatt(p))
    ps = (1, 2, 5, 6, 7, 12, 18, 36, 48, 250)
    for sp_kw in ({}, {"mem_contention": 0.0, "overhead": 0.1}):
        for p in ps:
            assert _same(tc.simulate_ata_p(n, p, tc.SimParams(**sp_kw)),
                         jc.simulate_ata_p(n, p, jc.SimParams(**sp_kw)))
    mine, theirs = tc.simulate_metrics(n, ps), jc.simulate_metrics(n, ps)
    assert _same(mine["t1"], theirs["t1"])
    for r1, r2 in zip(mine["rows"], theirs["rows"]):
        assert r1.keys() == r2.keys()
        assert all(_same(r1[k], r2[k]) for k in r1)


def test_pipelined_bytes_score_at_equal_constants():
    grid = itertools.product((0, 1e6, 3e9), (0, 2e6, 4e8), (0, 1e9, 5e12),
                             (0, 1, 2, 4), (1, 7, 1000))
    for rd, wr, fl, depth, steps in grid:
        kw = dict(pipeline_depth=depth, grid_steps=steps)
        assert _same(
            tc.pipelined_bytes_score(rd, wr, fl, flop_rate=TPU["flops"],
                                     hbm_bw=TPU["hbm"], **kw),
            jc.pipelined_bytes_score(rd, wr, fl, **kw))
        # the port's defaults are the H100's: fp32 CUDA cores, HBM3
        assert _same(tc.pipelined_bytes_score(rd, wr, fl, **kw),
                     jc.pipelined_bytes_score(
                         rd, wr, fl, flop_rate=tc.H100_FP32_FLOPS,
                         hbm_bw=tc.H100_HBM_BW, **kw))


COMM_GRID = list(itertools.product(
    (64, 512, 4096, 1 << 16), (32, 256, 2048), (1, 2, 3, 8), (1, 2, 3, 4, 8),
    (None, 1, 2, 3, 4), (2, 4), (None, 4)))


@pytest.mark.parametrize("scheme", GRAM_SCHEMES)
def test_gram_comm_cost_fields_and_time(scheme):
    for m, n, R, T, c, b, ob in COMM_GRID:
        kw = dict(rows=R, ring=T, rep=c, dtype_bytes=b, out_bytes=ob)
        mine, theirs = gram_comm_cost(scheme, m, n, **kw), \
            jc.gram_comm_cost(scheme, m, n, **kw)
        assert (mine.scheme, mine.devices, mine.messages,
                mine.mem_input_factor) == (theirs.scheme, theirs.devices,
                                           theirs.messages,
                                           theirs.mem_input_factor)
        assert _same(mine.wire_bytes, theirs.wire_bytes)
        assert _same(mine.flops, theirs.flops)
        assert _same(mine.time(alpha=TPU["alpha"], link_bw=TPU["bw"],
                               flop_rate=TPU["flops"]), theirs.time())


def test_rank_gram_schemes_at_equal_constants():
    """The same order and costs as the JAX package's under its constants
    (its dtype-scaled default rate passed to both)."""
    for m, n, R, T, c, b, ob in COMM_GRID:
        rate = TPU["flops"] * 2.0 / max(b, 2)
        mine = rank_gram_schemes(m, n, rows=R, ring=T, rep=c, dtype_bytes=b,
                                 out_bytes=ob, alpha=TPU["alpha"],
                                 link_bw=TPU["bw"], flop_rate=rate)
        theirs = jc.rank_gram_schemes(m, n, rows=R, ring=T, rep=c,
                                      dtype_bytes=b, out_bytes=ob)
        assert [x.scheme for x in mine] == [x.scheme for x in theirs]
        assert all(_same(x.wire_bytes, y.wire_bytes)
                   for x, y in zip(mine, theirs))
        assert choose_gram_scheme(
            m, n, rows=R, ring=T, rep=c, dtype_bytes=b, out_bytes=ob,
            alpha=TPU["alpha"], link_bw=TPU["bw"], flop_rate=rate) == \
            jc.choose_gram_scheme(m, n, rows=R, ring=T, rep=c,
                                  dtype_bytes=b, out_bytes=ob)


def test_default_rate_is_the_fused_kernels_for_every_dtype():
    """The schemes' local work runs the fused leaf program, fp32 on the
    CUDA cores whatever the operand type: 67 TFLOP/s for fp32 and bf16
    alike (the JAX package doubles its rate for a 2-byte type)."""
    for b in (1, 2, 4):
        dflt = rank_gram_schemes(4096, 2048, rows=2, ring=4, rep=2,
                                 dtype_bytes=b)
        fp32 = rank_gram_schemes(4096, 2048, rows=2, ring=4, rep=2,
                                 dtype_bytes=b, flop_rate=67e12)
        assert [x.scheme for x in dflt] == [x.scheme for x in fp32]
        assert [x.time() for x in dflt] == [x.time(flop_rate=67e12)
                                            for x in fp32]


# ---------------------------------------------------------------------------
# The JAX suite's eleven properties (tests/test_comm_cost.py), at the H100
# defaults
# ---------------------------------------------------------------------------

def test_reducescatter_strictly_dominates_allreduce():
    for rows in (2, 4, 8, 64):
        ar = gram_comm_cost("allreduce", 4096, 512, rows=rows)
        rs = gram_comm_cost("reducescatter", 4096, 512, rows=rows)
        assert rs.wire_bytes < ar.wire_bytes
        assert rs.messages < ar.messages
        assert rs.flops == ar.flops
        assert rs.time() < ar.time()


def test_bfs25d_replication_cuts_ring_wire_bytes():
    for c in (2, 4):
        ring = gram_comm_cost("ring", 8192, 1024, rows=2, ring=8)
        bfs = gram_comm_cost("bfs25d", 8192, 1024, rows=2, ring=8, rep=c)
        assert bfs.wire_bytes < ring.wire_bytes
        assert bfs.mem_input_factor == c
        assert bfs.devices == ring.devices * c


def test_bfs25d_fewer_rounds_at_matched_device_count():
    ring = gram_comm_cost("ring", 8192, 1024, rows=2, ring=8)      # P=16
    bfs = gram_comm_cost("bfs25d", 8192, 1024, rows=1, ring=8, rep=2)
    assert bfs.devices == ring.devices == 16
    assert bfs.messages < ring.messages


def test_dtype_bytes_scale_wire_not_messages():
    f32 = gram_comm_cost("ring", 1024, 256, rows=2, ring=4, dtype_bytes=4)
    bf16 = gram_comm_cost("ring", 1024, 256, rows=2, ring=4, dtype_bytes=2)
    assert f32.wire_bytes == 2 * bf16.wire_bytes
    assert f32.messages == bf16.messages


def test_rank_covers_requested_schemes_and_sorts_by_time():
    ranked = rank_gram_schemes(4096, 512, rows=2, ring=4, rep=2)
    assert sorted(r.scheme for r in ranked) == sorted(GRAM_SCHEMES)
    times = [r.time() for r in ranked]
    assert times == sorted(times)
    only = rank_gram_schemes(4096, 512, rows=8,
                             schemes=["allreduce", "reducescatter"])
    assert {r.scheme for r in only} == {"allreduce", "reducescatter"}


def test_auto_picks_row_reduction_for_tall_skinny():
    assert choose_gram_scheme(1 << 20, 128, rows=8, ring=4, rep=2) in \
        ("reducescatter", "allreduce")
    assert choose_gram_scheme(1 << 20, 128, rows=8) == "reducescatter"


def test_auto_picks_ring_family_for_wide():
    assert choose_gram_scheme(512, 8192, rows=2, ring=4, rep=2) in \
        ("ring", "bfs25d")


def test_model_crossover_between_shapes():
    def gap(m, n):
        ar = gram_comm_cost("allreduce", m, n, rows=2)
        ring = gram_comm_cost("ring", m, n, rows=2, ring=4)
        return ar.wire_bytes - ring.wire_bytes
    assert gap(4096, 128) < 0          # tall-skinny: allreduce cheaper
    assert gap(256, 2048) > 0          # wide: ring cheaper


def test_mixed_dtype_charges_permute_at_input_width():
    mixed = gram_comm_cost("ring", 4096, 512, rows=2, ring=4,
                           dtype_bytes=2, out_bytes=4)
    all4 = gram_comm_cost("ring", 4096, 512, rows=2, ring=4,
                          dtype_bytes=4, out_bytes=4)
    all2 = gram_comm_cost("ring", 4096, 512, rows=2, ring=4,
                          dtype_bytes=2, out_bytes=2)
    assert all2.wire_bytes < mixed.wire_bytes < all4.wire_bytes
    assert gram_comm_cost("allreduce", 4096, 512, rows=2, dtype_bytes=2,
                          out_bytes=4).wire_bytes == \
        gram_comm_cost("allreduce", 4096, 512, rows=2, dtype_bytes=4,
                       out_bytes=4).wire_bytes


def test_cost_is_a_pure_dataclass():
    cst = gram_comm_cost("allreduce", 64, 32, rows=2)
    assert isinstance(cst, GramCommCost)
    assert cst.time(alpha=0.0, link_bw=1.0, flop_rate=1e30) == \
        pytest.approx(cst.wire_bytes)


def test_invalid_scheme_and_missing_ring_raise():
    with pytest.raises(ValueError):
        gram_comm_cost("nope", 64, 32, rows=2)
    with pytest.raises(ValueError):
        gram_comm_cost("ring", 64, 32, rows=2)          # ring size missing
    with pytest.raises(ValueError):
        gram_comm_cost("bfs25d", 64, 32, rows=2)


# ---------------------------------------------------------------------------
# Where the H100 constants rank otherwise than the TPU's: the port's pinned
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axes,tpu,h100", [
    # NVLink ~9x the TPU link: shipping the A shards around the ring beats
    # the n^2 reduction for a bf16 A the TPU would all-reduce
    ((64, 8192), dict(rows=1, ring=2, dtype_bytes=2), "allreduce", "ring"),
    # the fp32 CUDA-core rate (67 TFLOP/s) against the TPU's halved bf16
    # (98.5): the per-device flops weigh more, the wire less
    ((4096, 2048), dict(rows=8, ring=4, rep=2, dtype_bytes=4), "bfs25d",
     "reducescatter"),
    ((512, 8192), dict(rows=2, ring=2, dtype_bytes=2), "reducescatter",
     "ring"),
])
def test_rankings_that_the_h100_constants_change(shape, axes, tpu, h100):
    assert jc.choose_gram_scheme(*shape, **axes) == tpu
    assert choose_gram_scheme(*shape, **axes) == h100


def test_full_order_the_h100_constants_change():
    """(4096, 512) on rows 2, ring 4, rep 2: the TPU constants put bfs25d
    before ring, the H100's ring before bfs25d."""
    assert [r.scheme for r in jc.rank_gram_schemes(
        4096, 512, rows=2, ring=4, rep=2)] == \
        ["reducescatter", "allreduce", "bfs25d", "ring"]
    assert [r.scheme for r in rank_gram_schemes(
        4096, 512, rows=2, ring=4, rep=2)] == \
        ["reducescatter", "allreduce", "ring", "bfs25d"]
