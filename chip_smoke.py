#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed 0] [--n 10000]

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit.  Phases, each of which asserts (nothing is caught, any
failure exits non-zero):

1. device: the card's name and power limit, torch/CUDA versions, and
   both TF32 flags, set off;
2. build: every kernel of ``src/repro_torch/kernels/csrc`` from source;
3. the ``leaf_program`` kernel's ata kind against its plain torch
   version on the card, over algebra x gram x levels at 1000x777 (fp32,
   bk = bn = 64), bf16 input, a bf16 output and a tile-aligned 1024^2 at
   128: kernel vs plain <= 1e-5 of max|C| (fp32 sums in another order),
   kernel vs float64 tril(A^t A) <= 1e-4 (the JAX suite's bar for the
   deeper algebras), ring depths 2-4 bit-equal to depth 1, and a depth
   whose shared memory would exceed 227 KB refused;
3b. its symm kind, ``X @ Sym`` and ``X @ (S + S^t)`` from a packed
   stack, over algebra x levels 0-3 x diag_sym at X 1000x777 fp32
   against a 16-tile stack (bs = bm = 64), bf16 X with an fp32 stack at
   bm = 64, bs = 128, and a tile-aligned 1024^2 at 128: the same bars
   and depth checks;
4. the main path, ``repro_torch.core.ata(a)`` and ``ata_full(a,
   levels="auto")`` at n x n fp32 from ``--seed`` (the paper's
   n = 10000), with launch counts zeroed just before and read just after,
   checked against float64 on the card (<= 1e-4 of max|C|), then
   ``ata`` on bf16 A; then each of those three kernel configurations
   (levels, dtype, ring depth at the main-path shape) against its plain
   version on the same operand, <= 1e-5 of max|C|;
4b. the main path's backward: ``torch.autograd.grad`` of
   ``(W * ata(a)).sum()``, of the same through ``ata_full(a,
   levels="auto")`` and ``ata(bf16 a)``, and of ``(Wp * packed).sum()``
   through ``ops.ata_fused_packed`` with ``Wp = pack_tril_blocks(tril(W))``,
   counts zeroed just before and read just after; dA against float64
   ``A (S + S^t)`` on the card (<= 1e-4 of max|dA|; bf16 dA, which is
   stored in bf16, <= 2^-8); each symm configuration the backward
   launched against its plain version (<= 1e-5); and the peak memory of
   one backward with ``bwd="fused"`` below that with ``bwd="dense"``;
5. times with CUDA events (median of 5 after 2 warm-ups): each kind at
   the main-path shape (depths 2 and 1), the library yardsticks
   ``torch.tril(a.T @ a)`` and ``a @ (s + s.T)``, ``ata(a)`` and its
   backward end to end, the plain versions once, and each kind's bound:
   the least flops of its function (each leaf product once, or
   classical, whichever is less) at the fp32 CUDA-core peak against its
   inputs and outputs at HBM rate.  The kernels' live-step flops, which
   include the per-destination recomputation, are printed beside the
   bounds and kept out of them.

It prints one ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": ...}`` line.  Without a CUDA device it exits 1
and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time
import warnings

# H100 SXM data-sheet peaks at the 700 W limit (NVIDIA H100 data sheet):
# fp32 on the CUDA cores (no tensor cores, no TF32) and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

SOURCE = "src/repro_torch/kernels/csrc/leaf_program.cu"
REPLACES = ("src/repro/kernels/strassen_fused.py:474 (_leaf_kernel) and "
            "src/repro/kernels/strassen_fused.py:533 (_pipelined_kernel), "
            "{} kind")


def _rel(got, want) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


def _time_ms(fn, reps=5, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


def _ptxas_summary(report: str) -> list:
    """Registers and spills per program kind from ``nvcc -Xptxas -v``."""
    kinds = {"0": "ata", "1": "symm"}
    stats, kind = {}, None
    for line in report.splitlines():
        found = re.search(r"leaf_program_kernelILi(\d)E", line)
        if found:
            kind = kinds[found.group(1)]
        regs = re.search(r"Used (\d+) registers", line)
        spill = re.search(r"(\d+) bytes spill stores", line)
        if kind and (regs or spill):
            entry = stats.setdefault(kind, {"regs": [], "spill": [0]})
            if regs:
                entry["regs"].append(int(regs.group(1)))
            if spill:
                entry["spill"].append(int(spill.group(1)))
    return [f"{k}: {len(v['regs'])} instantiations, {min(v['regs'])}-"
            f"{max(v['regs'])} registers, spill stores up to "
            f"{max(v['spill'])} B" for k, v in stats.items()]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=10000,
                    help="main-path size (A is n x n; the paper's 10000)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    import torch.nn.functional as F
    from repro_torch.core import ata, ata_full, ata_levels_for
    from repro_torch.core.leaf_ir import compile_program
    from repro_torch.core.strassen import (
        AUTO_MAX_LEVELS, DEFAULT_LEAF, DEFAULT_LEVELS)
    from repro_torch.core.symmetry import pack_tril_blocks, unpack_tril_blocks
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import strassen_fused as sf
    from repro_torch.kernels.ops import DEFAULT_BLOCK

    # -- 1. device ------------------------------------------------------------
    print("== 1. device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    ATA, SYMM = "leaf_program/ata", "leaf_program/symm"

    # -- 2. build -------------------------------------------------------------
    print("== 2. build")
    t0 = time.perf_counter()
    report = _build.build("leaf_program")
    print(f"leaf_program: {'built' if report else 'cached'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in _ptxas_summary(report or ""):
        print(f"  {line}")

    def plain(spec, left, right, out_dtype):
        tables = sf._device_tables(spec.kind, spec.levels, spec.variant,
                                   spec.gram, str(left.device))
        return sf._leaf_program_plain(spec, tables, left, right, out_dtype)

    def depths_bit_equal(spec, left, right, out_dtype, k1, label):
        """Depths 2-4 give depth 1's bits; an over-budget depth raises."""
        for depth in (2, 3, 4):
            deep = dataclasses.replace(spec, pipeline_depth=depth)
            if sf.smem_bytes(deep, left.element_size(),
                             right.element_size()) > sf.SMEM_LIMIT_BYTES:
                try:
                    sf.leaf_program(deep, left, right, out_dtype)
                except ValueError:
                    continue
                raise AssertionError(f"{label}: depth {depth} over budget ran")
            kd = sf.leaf_program(deep, left, right, out_dtype)
            torch.cuda.synchronize()
            assert torch.equal(kd, k1), (label, depth)

    # -- 3. kernel against its plain version ------------------------------------
    print("== 3. leaf_program (ata kind) against its plain version")
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def check(a, levels, variant, gram, block, out_dtype=f32):
        spec, ap = sf._prepare_ata(a, levels, variant, gram, block, block)
        before = sf.KERNEL_LAUNCHES[ATA]
        k1 = sf.leaf_program(spec, ap, ap, out_dtype)
        assert sf.KERNEL_LAUNCHES[ATA] == before + 1
        depths_bit_equal(spec, ap, ap, out_dtype, k1,
                         (variant, gram, levels))
        ref = plain(spec, ap, ap, f32)
        n, N = a.shape[1], ap.shape[1]
        a64 = a.double()
        want = torch.tril(a64.T @ a64)
        dense = torch.tril(unpack_tril_blocks(k1, N, spec.bi,
                                              symmetrize=False))[:n, :n]
        e_plain = _rel(k1, ref.double())
        e64 = _rel(dense, want)
        bar = 1e-5 if out_dtype == f32 else 2.0 ** -8
        print(f"  {variant:9s} {gram:8s} L{levels}->{spec.levels} "
              f"{tuple(a.shape)} {a.dtype} -> {out_dtype} tmax={spec.tmax} "
              f"n_c={spec.n_c}: vs plain {e_plain:.2e} (<= {bar:.0e}), vs "
              f"float64 {e64:.2e}")
        assert e_plain <= bar, e_plain
        assert e64 <= max(1e-4, bar), e64

    a = torch.randn(1000, 777, generator=gen, device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # the fan-in clamp's notice
        for variant in ("strassen", "winograd", "classical"):
            for gram in ("strassen", "dps"):
                for levels in range(4):
                    check(a, levels, variant, gram, 64)
    check(a.to(bf16), 2, "strassen", "strassen", 64)
    check(a, 2, "strassen", "dps", 64, out_dtype=bf16)
    check(torch.randn(1024, 1024, generator=gen, device=dev), 2,
          "strassen", "strassen", 128)

    # -- 3b. the symm kind against its plain version ------------------------------
    print("== 3b. leaf_program (symm kind) against its plain version")

    def check_symm(x, T, bs, bm, levels, variant, diag_sym):
        s = torch.randn(T * bs, T * bs, generator=gen, device=dev)
        low = torch.tril(s)
        sym = low + torch.tril(s, -1).T
        # diag_sym reads the stack as block-lower S (diagonal tiles full);
        # otherwise as the symmetric completion of its lower triangle
        stack = pack_tril_blocks(low if diag_sym else sym, bs)
        spec, xp, sp = sf._prepare_symm(x, stack, levels, variant, bm,
                                        diag_sym)
        before = sf.KERNEL_LAUNCHES[SYMM]
        k1 = sf.leaf_program(spec, xp, sp, f32)
        assert sf.KERNEL_LAUNCHES[SYMM] == before + 1
        label = (variant, levels, diag_sym, str(x.dtype))
        depths_bit_equal(spec, xp, sp, f32, k1, label)
        ref = plain(spec, xp, sp, f32)
        m = x.shape[0]
        op = (low + low.T) if diag_sym else sym
        want = F.pad(x.double(), (0, T * bs - x.shape[1])) @ op.double()
        e_plain = _rel(k1, ref.double())
        e64 = _rel(k1[:m], want)
        print(f"  {variant:9s} L{levels}->{spec.levels} diag_sym="
              f"{int(diag_sym)} X {tuple(x.shape)} {x.dtype}, stack T={T} "
              f"bs={bs}, bm={bm} tmax={spec.tmax} n_c={spec.n_c}: vs plain "
              f"{e_plain:.2e} (<= 1e-5), vs float64 {e64:.2e} (<= 1e-4)")
        assert e_plain <= 1e-5, e_plain
        assert e64 <= 1e-4, e64

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for variant in ("strassen", "winograd", "classical"):
            for levels in range(4):
                for diag_sym in (False, True):
                    check_symm(a, 16, 64, 64, levels, variant, diag_sym)
    check_symm(a.to(bf16), 8, 128, 64, 2, "strassen", True)
    check_symm(torch.randn(1024, 1024, generator=gen, device=dev), 8, 128,
               128, 2, "strassen", True)

    # -- 4. main path ---------------------------------------------------------
    print(f"== 4. main path: ata / ata_full at {args.n} x {args.n}")
    a = torch.randn(args.n, args.n, generator=gen, device=dev)
    ab = a.to(bf16)
    for key in sf.KERNEL_LAUNCHES:
        sf.KERNEL_LAUNCHES[key] = 0
    c = ata(a)
    full = ata_full(a, levels="auto")
    cb = ata(ab)
    torch.cuda.synchronize()
    launches = dict(sf.KERNEL_LAUNCHES)
    print(f"launches on the main path: {launches}")
    assert launches[ATA] >= 3, launches
    for out in (c, full, cb):
        assert out.shape == (args.n, args.n) and out.dtype == f32
        assert bool(torch.isfinite(out).all())
    a64 = a.double()
    want = a64.T @ a64
    e_c = _rel(c, torch.tril(want))
    e_full = _rel(full, want)
    del want
    ab64 = ab.double()
    e_b = _rel(cb, torch.tril(ab64.T @ ab64))
    del ab64, a64, full, cb, c
    print(f"ata(a) L2 vs float64: {e_c:.3e}; ata_full(a, levels='auto') vs "
          f"float64: {e_full:.3e}; ata(bf16 a) vs float64: {e_b:.3e} "
          f"(each <= 1e-4 of max|C|)")
    assert max(e_c, e_full, e_b) <= 1e-4

    # The main path's three kernel configurations, each held against the
    # plain version on the same padded operand.  These launches come after
    # the counts were read, so they are not counted.
    depth = sf._resolve_pipeline_depth(None, dev)
    auto = min(ata_levels_for(args.n, args.n, DEFAULT_LEAF), AUTO_MAX_LEVELS)
    max_abs_err = 0.0
    for label, x, levels in (("ata(a)", a, DEFAULT_LEVELS),
                             ("ata_full(a, levels='auto')", a, auto),
                             ("ata(bf16 a)", ab, DEFAULT_LEVELS)):
        spec, ap = sf._prepare_ata(x, levels, "strassen", "strassen",
                                   DEFAULT_BLOCK, DEFAULT_BLOCK,
                                   pipeline_depth=depth)
        got = sf.leaf_program(spec, ap, ap, f32)
        ref = plain(spec, ap, ap, f32)
        err = float((got - ref).abs().max())
        rel = _rel(got, ref.double())
        print(f"  {label}: L{spec.levels} {tuple(ap.shape)} {ap.dtype} "
              f"depth {depth} tmax={spec.tmax} n_c={spec.n_c} n_k={spec.n_k}"
              f": kernel vs plain max|d| {err:.3e}, relative {rel:.3e} "
              f"(<= 1e-5)")
        assert rel <= 1e-5, (label, rel)
        max_abs_err = max(max_abs_err, err)
        del got, ref, ap

    # -- 4b. the main path's backward --------------------------------------------
    print(f"== 4b. main path backward: dA of ata / ata_full / ata(bf16) / "
          f"ata_fused_packed at {args.n} x {args.n}")
    n = args.n
    w = torch.randn(n, n, generator=gen, device=dev)
    n_pad = sf._ata_geometry(n, n, DEFAULT_LEVELS, "strassen", DEFAULT_BLOCK,
                             DEFAULT_BLOCK)["N"]
    wp = pack_tril_blocks(F.pad(torch.tril(w), (0, n_pad - n, 0, n_pad - n)),
                          DEFAULT_BLOCK)

    def grad_of(x, loss):
        x = x.clone().requires_grad_()
        (g,) = torch.autograd.grad(loss(x), x)
        return g

    for key in sf.KERNEL_LAUNCHES:
        sf.KERNEL_LAUNCHES[key] = 0
    da = grad_of(a, lambda x: (w * ata(x)).sum())
    da_full = grad_of(a, lambda x: (w * ata_full(x, levels="auto")).sum())
    da_b = grad_of(ab, lambda x: (w * ata(x)).sum())
    da_p = grad_of(a, lambda x: (wp * ops.ata_fused_packed(x)).sum())
    torch.cuda.synchronize()
    bwd_launches = dict(sf.KERNEL_LAUNCHES)
    print(f"launches on the main path's backward (forwards included): "
          f"{bwd_launches}")
    assert bwd_launches[SYMM] >= 4 and bwd_launches[ATA] >= 4, bwd_launches
    for g, dt in ((da, f32), (da_full, f32), (da_b, bf16), (da_p, f32)):
        assert g.shape == (n, n) and g.dtype == dt
        assert bool(torch.isfinite(g).all())
    low = torch.tril(w).double()
    a64 = a.double()
    want = a64 @ (low + low.T)
    e_da, e_dp = _rel(da, want), _rel(da_p, want)
    # ata_full's output is tril(C) + tril(C, -1)^t, so its cotangent on
    # tril(C) is W's lower part plus the mirror of its upper part
    s_full = low + torch.tril(w.T, -1).double()
    want = a64 @ (s_full + s_full.T)
    e_full = _rel(da_full, want)
    del want, a64, s_full
    ab64 = ab.double()
    want = ab64 @ (low + low.T)
    e_b = _rel(da_b, want)
    del want, ab64, low, da, da_full, da_b, da_p
    print(f"dA vs float64 A (S + S^t): ata {e_da:.3e}, ata_full(levels='auto')"
          f" {e_full:.3e}, packed entry {e_dp:.3e} (each <= 1e-4 of max|dA|);"
          f" ata(bf16 a), dA stored in bf16, {e_b:.3e} (<= 2^-8)")
    assert max(e_da, e_full, e_dp) <= 1e-4
    assert e_b <= 2.0 ** -8

    # Each symm configuration the backward launched, on the operands the
    # backward gives it, against the plain version; uncounted.
    s_main = sf._pack_cotangent(w, n, n_pad, DEFAULT_BLOCK)
    symm_err, symm_cfgs = 0.0, []
    for label, x, levels in (("ata / packed", a, DEFAULT_LEVELS),
                             ("ata_full(levels='auto')", a, auto),
                             ("ata(bf16 a)", ab, DEFAULT_LEVELS)):
        lv = sf._ata_geometry(n, n, levels, "strassen", DEFAULT_BLOCK,
                              DEFAULT_BLOCK)["levels"]
        spec, xp, sp = sf._prepare_symm(x, s_main, lv, "strassen",
                                        DEFAULT_BLOCK, True,
                                        pipeline_depth=depth)
        got = sf.leaf_program(spec, xp, sp, f32)
        ref = plain(spec, xp, sp, f32)
        err = float((got - ref).abs().max())
        rel = _rel(got, ref.double())
        if label == "ata(bf16 a)":
            # the fp32 product behind the bf16 dA, against float64
            lw = torch.tril(w).double()
            want = F.pad(x.double(), (0, n_pad - n)) @ F.pad(
                lw + lw.T, (0, n_pad - n, 0, n_pad - n))
            e64 = _rel(got[:n], want)
            del want, lw
            print(f"  {label}: fp32 product behind dA vs float64 {e64:.3e} "
                  f"(<= 1e-4)")
            assert e64 <= 1e-4
        print(f"  {label}: symm L{spec.levels} X {tuple(xp.shape)} {xp.dtype}"
              f", stack {tuple(sp.shape)} {sp.dtype}, depth {depth} tmax="
              f"{spec.tmax} n_c={spec.n_c} n_k={spec.n_k}: kernel vs plain "
              f"max|d| {err:.3e}, relative {rel:.3e} (<= 1e-5)")
        assert rel <= 1e-5, (label, rel)
        symm_err = max(symm_err, err)
        symm_cfgs.append((spec.levels, str(xp.dtype), depth))
        del got, ref, xp, sp

    # Peak memory of one backward (forward done) with each engine.
    peaks = {}
    for bwd in ("fused", "dense"):
        x = a.clone().requires_grad_()
        loss = (w * ata(x, bwd=bwd)).sum()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (g,) = torch.autograd.grad(loss, x)
        torch.cuda.synchronize()
        peaks[bwd] = torch.cuda.max_memory_allocated() - base
        del x, loss, g
    print(f"peak memory of one backward above the forward's: fused "
          f"{peaks['fused']} B, dense {peaks['dense']} B")
    assert peaks["fused"] < peaks["dense"], peaks

    # -- 5. times -------------------------------------------------------------
    print("== 5. times (CUDA events, median of 5 after 2 warm-ups)")
    m = n
    spec, ap = sf._prepare_ata(a, DEFAULT_LEVELS, "strassen", "strassen",
                               DEFAULT_BLOCK, DEFAULT_BLOCK,
                               pipeline_depth=depth)
    spec1 = dataclasses.replace(spec, pipeline_depth=1)
    ms, runs = _time_ms(lambda: sf.leaf_program(spec, ap, ap, f32))
    ms1, runs1 = _time_ms(lambda: sf.leaf_program(spec1, ap, ap, f32))
    lib_ms, lib_runs = _time_ms(lambda: torch.tril(a.T @ a))
    e2e_ms, e2e_runs = _time_ms(lambda: ata(a))
    plain_ms, _ = _time_ms(lambda: plain(spec, ap, ap, f32), reps=1,
                           warmup=0)

    # The bound: the least work that computes tril(A^t A), each leaf
    # product once (SYRK leaves half) at the padded size or the classical
    # m n (n + 1), whichever is less.  The kernel's live steps, which
    # recompute a leaf product for each destination it feeds, are shown
    # beside it and do not enter the bound.
    prog = compile_program("ata", spec.levels, spec.variant, gram=spec.gram)
    leaf_flops = 2 * prog.mult_count(spec.n_k * spec.bc, spec.q_i * spec.bi)
    classical_flops = m * n * (n + 1)
    flops = min(leaf_flops, classical_flops)
    live_flops = sf.live_steps(spec) * 2 * spec.bi * spec.bj * spec.bc
    io_bytes = ap.numel() * ap.element_size() \
        + spec.n_out * spec.bi * spec.bj * 4
    model = sf.ata_traffic_model(m, n, levels=spec.levels, bk=spec.bc,
                                 bn=spec.bi)
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = io_bytes / PEAK_HBM_BYTES * 1e3
    live_ms = live_flops / PEAK_FP32_FLOPS * 1e3
    model_ms = (model["read_bytes"] + model["write_bytes"]) \
        / PEAK_HBM_BYTES * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    print(f"card: {smi}")
    print(f"ata kind depth {depth}: {ms:.3f} ms (runs {runs}); depth 1: "
          f"{ms1:.3f} ms (runs {runs1})")
    print(f"torch.tril(a.T @ a) fp32: {lib_ms:.3f} ms (runs {lib_runs})")
    print(f"ata(a) end to end (pad, kernel, unpack to dense): {e2e_ms:.3f} "
          f"ms (runs {e2e_runs})")
    print(f"ata plain executor, once: {plain_ms:.3f} ms")
    print(f"ata bound: min(leaf products once {leaf_flops:.4e}, classical "
          f"{classical_flops:.4e}) = {flops:.4e} flops at "
          f"{PEAK_FP32_FLOPS:.3g} FLOP/s -> {ops_ms:.3f} ms; inputs+outputs "
          f"once {io_bytes:.4e} B at {PEAK_HBM_BYTES:.3g} B/s -> "
          f"{bytes_ms:.3f} ms; bound_ms {bound_ms:.3f}")
    print(f"ata, not in the bound: the kernel's live-step flops (with the "
          f"per-destination recomputation) {live_flops:.4e} -> {live_ms:.3f}"
          f" ms; ata_traffic_model {model['read_bytes']:.4e} + "
          f"{model['write_bytes']:.4e} B -> {model_ms:.3f} ms")
    del ap

    # The symm kind at the main path's backward: dA = A (S + S^t), S the
    # packed tril(W), levels 2.
    sspec, xp, sp = sf._prepare_symm(a, s_main, DEFAULT_LEVELS, "strassen",
                                     DEFAULT_BLOCK, True,
                                     pipeline_depth=depth)
    sspec1 = dataclasses.replace(sspec, pipeline_depth=1)
    s_ms, s_runs = _time_ms(lambda: sf.leaf_program(sspec, xp, sp, f32))
    s_ms1, s_runs1 = _time_ms(lambda: sf.leaf_program(sspec1, xp, sp, f32))
    s_dense = torch.tril(w)

    def library_symm():
        with torch.no_grad():
            return a @ (s_dense + s_dense.T)
    s_lib_ms, s_lib_runs = _time_ms(library_symm)
    x = a.clone().requires_grad_()
    loss = (w * ata(x)).sum()
    bwd_ms, bwd_runs = _time_ms(
        lambda: torch.autograd.grad(loss, x, retain_graph=True))
    del x, loss
    s_plain_ms, _ = _time_ms(lambda: plain(sspec, xp, sp, f32), reps=1,
                             warmup=0)
    sprog = compile_program("symm", sspec.levels, sspec.variant)
    M, N = xp.shape
    s_leaf_flops = 2 * sprog.mult_count(M // sprog.blocks_m,
                                        N // sprog.blocks_n)
    s_classical = 2 * m * n * n
    s_flops = min(s_leaf_flops, s_classical)
    s_live = sf.live_steps(sspec) * 2 * sspec.bi * sspec.bj * sspec.bc
    s_io = xp.numel() * xp.element_size() + sp.numel() * sp.element_size() \
        + M * N * 4
    s_ops_ms = s_flops / PEAK_FP32_FLOPS * 1e3
    s_bytes_ms = s_io / PEAK_HBM_BYTES * 1e3
    s_bound = max(s_ops_ms, s_bytes_ms)
    print(f"symm kind (L{sspec.levels}, X {tuple(xp.shape)}, stack "
          f"{tuple(sp.shape)}, diag_sym) depth {depth}: {s_ms:.3f} ms (runs "
          f"{s_runs}); depth 1: {s_ms1:.3f} ms (runs {s_runs1})")
    print(f"a @ (s + s.T) fp32, the add included: {s_lib_ms:.3f} ms (runs "
          f"{s_lib_runs})")
    print(f"backward of ata(a) end to end (pack, pad, kernel; forward done):"
          f" {bwd_ms:.3f} ms (runs {bwd_runs})")
    print(f"symm plain executor, once: {s_plain_ms:.3f} ms")
    print(f"symm bound: min(leaf products once {s_leaf_flops:.4e}, classical"
          f" {s_classical:.4e}) = {s_flops:.4e} flops -> {s_ops_ms:.3f} ms; "
          f"inputs+outputs once {s_io:.4e} B -> {s_bytes_ms:.3f} ms; "
          f"bound_ms {s_bound:.3f}")
    print(f"symm, not in the bound: live-step flops {s_live:.4e} -> "
          f"{s_live / PEAK_FP32_FLOPS * 1e3:.3f} ms")
    print(f"symm configurations checked on the backward: {symm_cfgs}")

    # -- 6. summary -------------------------------------------------------------
    kernels = [{
        "name": "leaf_program", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES.format("ata"), "kind": "ata",
        "launches": launches[ATA], "max_abs_err": max_abs_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": lib_ms, "ms_depth1": ms1, "ata_e2e_ms": e2e_ms,
        "shape": [m, n], "card": smi,
    }, {
        "name": "leaf_program", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES.format("symm"), "kind": "symm",
        "launches": bwd_launches[SYMM], "max_abs_err": symm_err,
        "ms": s_ms, "plain_ms": s_plain_ms, "bound_ms": s_bound,
        "bound_by": "operations" if s_ops_ms >= s_bytes_ms else "bytes",
        "library_ms": s_lib_ms, "ms_depth1": s_ms1, "bwd_e2e_ms": bwd_ms,
        "peak_bwd_bytes": peaks, "shape": [M, N], "card": smi,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
