"""Where the leaf program's kernel keeps the running sums of a bf16 or fp64
accumulator, on the CPU.

Under a bf16 or fp64 accumulator ``csrc/leaf_products.cuh`` rounds each K
block's part into the op's destinations.  An op's first
``strassen_fused.run_dests`` slots keep their destinations' running values
in shared memory from the op's first K block to its last; the other slots
read and write the workspace every K block.  Here the plan is held against
the programs of ``compile_program`` for every kind and gram at levels 0-3
(the kept slots re-derived op by op and their counts pinned), and
``run_dests`` against the room the kernel's shared-memory layout leaves at
each block tile.  Where the values live changes no bit, so the plain
version, which the rest of the suite holds against the JAX package, is the
same for every plan; the kernel is held against it on the card by
``chip_smoke.py`` and against its parent's bits by
``tools/ab_leaf_program.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import strassen_fused as sf

PROGRAMS = (("ata", "strassen"), ("ata", "dps"), ("aat", "strassen"),
            ("aat", "dps"), ("rank_k", "strassen"), ("rank_k", "dps"),
            ("symm", "strassen"), ("matmul", "strassen"))
LEVELS = (0, 1, 2, 3)

# per program and levels 0-3: (ops, widest op's slots, live slots, kept at
# run_dests 1, kept at run_dests 2)
PINNED = {
    ("ata", "strassen"): [(1, 1, 1, 1, 1), (6, 1, 6, 6, 6),
                          (38, 2, 48, 38, 48), (250, 4, 480, 250, 380)],
    ("ata", "dps"): [(1, 1, 1, 1, 1), (5, 3, 14, 5, 10),
                     (31, 10, 184, 31, 62), (209, 36, 2336, 209, 418)],
    ("symm", "strassen"): [(1, 1, 1, 1, 1), (7, 2, 12, 7, 12),
                           (49, 4, 144, 49, 94), (343, 8, 1728, 343, 678)],
}
for _kind in ("aat", "rank_k"):        # the ata programs, read otherwise
    for _gram in ("strassen", "dps"):
        PINNED[(_kind, _gram)] = PINNED[("ata", _gram)]
PINNED[("matmul", "strassen")] = PINNED[("symm", "strassen")]


def _spec(kind, gram, levels, acc_dtype):
    """A spec binding the program (the tables depend on kind, levels,
    variant and gram alone; the tile fields are the 1000 x 777 ata's)."""
    base, _ = sf._prepare_ata(torch.zeros(64, 48), 0, "strassen",
                              "strassen", 16, 16)
    return dataclasses.replace(base, kind=kind, levels=levels, gram=gram,
                               acc_dtype=acc_dtype)


def _base_smem(spec, tile, operand_bytes, depth, pair):
    """The shared memory of a launch before its running values, as
    ``smem_bytes`` in csrc/leaf_products.cuh lays it out: ``depth`` ring
    slots of an op's terms (4 a side in pair mode, the tri right side's
    doubled), the two double-buffered sum chunks of 16 x (tile + 4) fp32,
    and each slot's terms (144 B) and mbarrier."""
    terms = 4 if pair and spec.tmax > 4 else spec.tmax
    right = 2 if spec.right_tri else 1
    return (depth * terms * 16 * tile * operand_bytes * (1 + right)
            + 2 * 2 * 16 * (tile + 4) * 4 + depth * (144 + 8))


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("kind,gram", PROGRAMS)
def test_kept_slots_follow_compile_program(kind, gram, levels):
    """For every ``run_dests`` an op can take, the kept slots are each op's
    first ``run_dests`` destinations in ``compile_program``'s order, and
    their counts are the pinned ones; an fp32 accumulator, which adds
    each op's product once, keeps none whatever the room."""
    prog = sf.compile_program(kind, levels, "strassen", gram=gram)
    spec = _spec(kind, gram, levels, "float64")
    widest = max(len(op.dests) for op in prog.ops)
    live = sum(len(op.dests) for op in prog.ops)
    for n_run in range(widest + 1):
        want = np.zeros((len(prog.ops), widest), bool)
        for o, op in enumerate(prog.ops):
            want[o, :min(n_run, len(op.dests))] = True
        got = sf.kept_slots(spec, n_run)
        assert got.shape == want.shape and (got == want).all(), n_run
    assert not sf.kept_slots(spec, 0).any()
    assert sf.kept_slots(spec, widest).sum() == live
    assert (len(prog.ops), widest, live, int(sf.kept_slots(spec, 1).sum()),
            int(sf.kept_slots(spec, 2).sum())) == PINNED[(kind, gram)][levels]
    fp32 = _spec(kind, gram, levels, "float32")
    assert all(sf.run_dests(fp32, tile, 0) == 0 for tile in sf.PRODUCT_TILES)


@pytest.mark.parametrize("acc_dtype,tile,operand_bytes,kind,gram,want", [
    # the main path's ata at 10000^2, levels 2, tiles of 256: an fp64 slot
    # (128 KB at tile 128) fits once beside the 99.6 KB of ring and sums,
    # bf16 (32 KB) for every slot of the strassen gram
    ("float64", 128, 4, "ata", "strassen", 1),
    ("bfloat16", 128, 4, "ata", "strassen", 2),
    ("float64", 64, 4, "ata", "strassen", 2),
    # pair mode (4 terms a ring slot): no room for fp64 at tile 128; bf16
    # keeps 2 of the dps gram's up to 10
    ("float64", 128, 4, "ata", "dps", 0),
    ("bfloat16", 128, 4, "ata", "dps", 2),
    ("float64", 64, 4, "ata", "dps", 4),
    ("bfloat16", 64, 4, "ata", "dps", 10),
    # fp8 and fp16 tiles leave more room
    ("float64", 128, 1, "ata", "dps", 1),
    ("bfloat16", 128, 2, "ata", "dps", 4),
    # symm's tri right side fills a tile-128 block: nothing kept
    ("float64", 128, 4, "symm", "strassen", 0),
    ("bfloat16", 128, 4, "symm", "strassen", 0),
    ("bfloat16", 64, 4, "symm", "strassen", 4),
    ("float64", 128, 4, "matmul", "strassen", 0),
    ("bfloat16", 128, 4, "matmul", "strassen", 2),
])
def test_run_dests_fill_the_room_left(acc_dtype, tile, operand_bytes, kind,
                                      gram, want):
    """At levels 2 and the default ring depth of the accumulator library
    (2), ``run_dests`` is the number of ``tile**2`` accumulator values
    that fit beside the ring and sums in the 227 KB a block can use, at
    most the widest op's slots."""
    spec = dataclasses.replace(_spec(kind, gram, 2, acc_dtype),
                               tmax=sf.compile_program(
                                   kind, 2, "strassen", gram=gram).max_terms,
                               right_tri=kind == "symm")
    base = _base_smem(spec, tile, operand_bytes, 2, gram == "dps")
    got = sf.run_dests(spec, tile, base)
    assert got == want
    assert base + got * tile * tile * sf._ACC_BYTES[acc_dtype] \
        <= sf.SMEM_LIMIT_BYTES
    assert got == sf._op_tables(kind, 2, "strassen", gram)[8].shape[1] or \
        base + (got + 1) * tile * tile * sf._ACC_BYTES[acc_dtype] \
        > sf.SMEM_LIMIT_BYTES


def test_run_dests_never_negative_over_budget():
    """A base already over the budget keeps nothing (the launch is refused
    elsewhere)."""
    spec = _spec("ata", "strassen", 2, "float64")
    assert sf.run_dests(spec, 128, sf.SMEM_LIMIT_BYTES + 1) == 0
    assert sf.run_dests(spec, 128, sf.SMEM_LIMIT_BYTES) == 0
