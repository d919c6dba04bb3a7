#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed 0] [--n 10000]

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit.  Phases, each of which asserts (nothing is caught, any
failure exits non-zero):

1. device: the card's name and power limit, torch/CUDA versions, and
   both TF32 flags, set off;
2. build: every kernel of ``src/repro_torch/kernels/csrc`` from source;
3. the ``leaf_program`` kernel against its plain torch version on the
   card, over algebra x gram x levels at 1000x777 (fp32, bk = bn = 64),
   bf16 input, a bf16 output and a tile-aligned 1024^2 at 128: kernel vs
   plain <= 1e-5 of max|C| (fp32 sums in another order), kernel vs
   float64 tril(A^t A) <= 1e-4 (the JAX suite's bar for the deeper
   algebras), ring depths 2-4 bit-equal to depth 1, and a depth whose
   shared memory would exceed 227 KB refused;
4. the main path, ``repro_torch.core.ata(a)`` and ``ata_full(a,
   levels="auto")`` at n x n fp32 from ``--seed`` (the paper's
   n = 10000), with launch counts zeroed just before and read just after,
   checked against float64 on the card (<= 1e-4 of max|C|), then
   ``ata`` on bf16 A; then each of those three kernel configurations
   (levels, dtype, ring depth at the main-path shape) against its plain
   version on the same operand, <= 1e-5 of max|C|;
5. times with CUDA events (median of 5 after 2 warm-ups): the kernel at
   the main-path shape (depths 2 and 1), ``torch.tril(a.T @ a)`` as the
   library yardstick, ``ata(a)`` end to end, the plain executor once,
   and the bound: the least flops that compute ``tril(A^t A)`` (each
   leaf product once, or classical, whichever is less) at the fp32
   CUDA-core peak against the kernel's inputs and outputs at HBM rate.
   The kernel's live-step flops, which include its per-destination
   recomputation, are printed beside the bound and kept out of it.

It prints one ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": ...}`` line.  Without a CUDA device it exits 1
and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
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
            "ata kind")


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
    from repro_torch.core import ata, ata_full, ata_levels_for
    from repro_torch.core.leaf_ir import compile_program
    from repro_torch.core.strassen import (
        AUTO_MAX_LEVELS, DEFAULT_LEAF, DEFAULT_LEVELS)
    from repro_torch.core.symmetry import unpack_tril_blocks
    from repro_torch.kernels import _build
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

    # -- 2. build -------------------------------------------------------------
    print("== 2. build")
    t0 = time.perf_counter()
    report = _build.build("leaf_program")
    print(f"leaf_program: {'built' if report else 'cached'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in (report or "").splitlines():
        if any(w in line for w in ("Function properties", "registers",
                                   "spill")):
            print(f"  {line.strip()}")

    # -- 3. kernel against its plain version ------------------------------------
    print("== 3. leaf_program against its plain version")
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def plain(spec, a, out_dtype):
        tables = sf._device_tables(spec.kind, spec.levels, spec.variant,
                                   spec.gram, str(a.device))
        return sf._leaf_program_plain(spec, tables, a, out_dtype)

    def check(a, levels, variant, gram, block, out_dtype=f32):
        spec, ap = sf._prepare_ata(a, levels, variant, gram, block, block)
        before = sf.KERNEL_LAUNCHES["leaf_program"]
        k1 = sf.leaf_program(spec, ap, out_dtype)
        assert sf.KERNEL_LAUNCHES["leaf_program"] == before + 1
        for depth in (2, 3, 4):
            deep = dataclasses.replace(spec, pipeline_depth=depth)
            smem = sf._lib().leaf_program_smem_bytes(
                spec.tmax, ap.element_size(), depth)
            if smem > sf.SMEM_LIMIT_BYTES:
                try:
                    sf.leaf_program(deep, ap, out_dtype)
                except ValueError:
                    continue
                raise AssertionError(f"depth {depth} over budget ran")
            kd = sf.leaf_program(deep, ap, out_dtype)
            torch.cuda.synchronize()
            assert torch.equal(kd, k1), (variant, gram, levels, depth)
        ref = plain(spec, ap, f32)
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
    assert launches["leaf_program"] >= 3, launches
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
    del ab64, a64, full, cb
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
        got = sf.leaf_program(spec, ap, f32)
        ref = plain(spec, ap, f32)
        err = float((got - ref).abs().max())
        rel = _rel(got, ref.double())
        print(f"  {label}: L{spec.levels} {tuple(ap.shape)} {ap.dtype} "
              f"depth {depth} tmax={spec.tmax} n_c={spec.n_c} n_k={spec.n_k}"
              f": kernel vs plain max|d| {err:.3e}, relative {rel:.3e} "
              f"(<= 1e-5)")
        assert rel <= 1e-5, (label, rel)
        max_abs_err = max(max_abs_err, err)
        del got, ref, ap
    del ab

    # -- 5. times -------------------------------------------------------------
    print("== 5. times (CUDA events, median of 5 after 2 warm-ups)")
    spec, ap = sf._prepare_ata(a, DEFAULT_LEVELS, "strassen", "strassen",
                               DEFAULT_BLOCK, DEFAULT_BLOCK,
                               pipeline_depth=depth)
    spec1 = dataclasses.replace(spec, pipeline_depth=1)
    ms, runs = _time_ms(lambda: sf.leaf_program(spec, ap, f32))
    ms1, runs1 = _time_ms(lambda: sf.leaf_program(spec1, ap, f32))
    lib_ms, lib_runs = _time_ms(lambda: torch.tril(a.T @ a))
    e2e_ms, e2e_runs = _time_ms(lambda: ata(a))
    plain_ms, _ = _time_ms(lambda: plain(spec, ap, f32), reps=1, warmup=0)

    # The bound: the least work that computes tril(A^t A), each leaf
    # product once (SYRK leaves half) at the padded size or the classical
    # m n (n + 1), whichever is less.  The kernel's live steps, which
    # recompute a leaf product for each destination it feeds, are shown
    # beside it and do not enter the bound.
    m, n = a.shape
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
    print(f"leaf_program depth {depth}: {ms:.3f} ms (runs {runs}); depth 1: "
          f"{ms1:.3f} ms (runs {runs1})")
    print(f"torch.tril(a.T @ a) fp32: {lib_ms:.3f} ms (runs {lib_runs})")
    print(f"ata(a) end to end (pad, kernel, unpack to dense): {e2e_ms:.3f} "
          f"ms (runs {e2e_runs})")
    print(f"plain executor, once: {plain_ms:.3f} ms")
    print(f"bound: min(leaf products once {leaf_flops:.4e}, classical "
          f"{classical_flops:.4e}) = {flops:.4e} flops at "
          f"{PEAK_FP32_FLOPS:.3g} FLOP/s -> {ops_ms:.3f} ms; inputs+outputs "
          f"once {io_bytes:.4e} B at {PEAK_HBM_BYTES:.3g} B/s -> "
          f"{bytes_ms:.3f} ms; bound_ms {bound_ms:.3f}")
    print(f"not in the bound: the kernel's live-step flops (with the "
          f"per-destination recomputation) {live_flops:.4e} -> {live_ms:.3f}"
          f" ms; ata_traffic_model {model['read_bytes']:.4e} + "
          f"{model['write_bytes']:.4e} B -> {model_ms:.3f} ms")

    # -- 6. summary -------------------------------------------------------------
    kernel = {
        "name": "leaf_program", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "kind": "ata",
        "launches": launches["leaf_program"], "max_abs_err": max_abs_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": lib_ms, "ms_depth1": ms1, "ata_e2e_ms": e2e_ms,
        "shape": [args.n, args.n], "card": smi,
    }
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
