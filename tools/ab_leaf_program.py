#!/usr/bin/env python3
"""Time the leaf program's kernel, and the syrk and matmul kernels, in two
checkouts of the port on one card.

    python3 tools/ab_leaf_program.py --parent DIR [--change DIR] [--rounds 2]
                                     [--cases ata,syrk,...]

Each checkout is a directory holding ``src/repro_torch`` (unpack the
parent with ``git archive <commit> | tar -x -C DIR`` into a directory
that ``.gitignore`` lists).  Both build ``leaf_products`` (and whatever
else their ``leaf_program`` launches) into their own ``build/`` first,
at once.  Then each round runs one process per side in the order
parent, change, change, parent, each timing ``strassen_fused.leaf_program``
on the main path's padded operands at n = 10000, seed 0, levels 2, tiles
of 256, at the default pipeline depth and block tile: the ata, aat and
rank_k kinds (one 2500-row chunk into a 40-tile stack) of the strassen
gram, the symm kind (the backward's X @ (S + S^t)), the matmul kind, ata
of the dps gram, ata on bf16 operands (``ata_bf16``) and ata into a bf16
output (``ata_bf16_out``); and ``syrk_packed`` and ``matmul_padded`` (blocks of
256, the default block tile) on the padded 10240^2 A (and B) of
``ops.syrk(a)`` and ``ops.matmul(a, b)`` and on the reference recursion's
2560^2 leaf (``syrk_leaf``, ``matmul_leaf``).  ``--cases`` picks some of
them.  A time is the median of 5 CUDA-event timings after 2 warm-ups; the
summary gives each side's median over its processes and the change over
the parent.  Each process also hashes each case's output (sha256 of its
bytes), and the summary says whether every run of both sides gave the
same bits.  It prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import statistics
import subprocess
import sys

CASES = ("ata", "aat", "rank_k", "symm", "matmul", "ata_dps", "ata_bf16",
         "ata_bf16_out", "syrk", "syrk_leaf", "matmul_padded", "matmul_leaf")
# the single-purpose kernels' cases, and their libraries
SINGLE = ("syrk", "syrk_leaf", "matmul_padded", "matmul_leaf")


def _time_side(root: pathlib.Path, cases: tuple) -> dict:
    sys.path.insert(0, str(root / "src"))
    import importlib

    import torch
    import torch.nn.functional as F
    from repro_torch.core.symmetry import pack_tril_blocks
    from repro_torch.kernels import strassen_fused as sf
    k_syrk, k_matmul = (importlib.import_module(f"repro_torch.kernels.{m}")
                        for m in ("syrk", "matmul"))

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, f32 = torch.device("cuda"), torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)
    n, rows, block, levels = 10000, 2500, 256, 2
    a = torch.randn(n, n, generator=gen, device=dev)
    depth = sf._resolve_pipeline_depth(None, dev)

    def timed(fn, reps=5, warmup=2):
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
        return statistics.median(times)

    def padded(x):
        return F.pad(x, (0, -x.shape[1] % block, 0, -x.shape[0] % block))

    def measured(fn):
        """(ms, sha256 of the output's bytes)."""
        out = fn()
        torch.cuda.synchronize()
        raw = out.contiguous().view(torch.uint8).cpu().numpy().tobytes()
        return {"ms": timed(fn), "hash": hashlib.sha256(raw).hexdigest()}

    out = {}
    for case in (c for c in cases if c in SINGLE):
        big = case in ("syrk", "matmul_padded")
        x = padded(a if big else a[:n // 4, :n // 4].contiguous())
        if case.startswith("syrk"):
            out[case] = measured(lambda: k_syrk.syrk_packed(x, bk=block,
                                                            bn=block))
        else:
            y = padded(torch.randn(x.shape, generator=gen, device=dev))
            out[case] = measured(lambda: k_matmul.matmul_padded(
                x, y, bm=block, bk=block, bn=block))
            del y
        del x
    for case in (c for c in cases if c not in SINGLE):
        seed, out_dtype = None, f32
        gram = "dps" if case == "ata_dps" else "strassen"
        if case.startswith("ata"):
            x = a.to(torch.bfloat16) if case == "ata_bf16" else a
            spec, left = sf._prepare_ata(x, levels, "strassen", gram, block,
                                         block, pipeline_depth=depth)
            right = left
            if case == "ata_bf16_out":
                out_dtype = torch.bfloat16
        elif case == "aat":
            spec, left = sf._prepare_aat(a, levels, "strassen", gram, block,
                                         block, pipeline_depth=depth)
            right = left
        elif case == "rank_k":
            T = -(-n // block)
            seed = pack_tril_blocks(torch.tril(torch.randn(
                T * block, T * block, generator=gen, device=dev)), block)
            spec, left = sf._prepare_rank_k(seed, a[:rows], levels,
                                            "strassen", gram, block,
                                            pipeline_depth=depth)
            right = left
        elif case == "symm":
            T = -(-n // block)
            stack = pack_tril_blocks(torch.tril(torch.randn(
                T * block, T * block, generator=gen, device=dev)), block)
            spec, left, right = sf._prepare_symm(a, stack, levels,
                                                 "strassen", block, True,
                                                 pipeline_depth=depth)
        else:
            spec, left, right = sf._prepare_matmul(
                a, a, levels, "strassen", block, block, block,
                pipeline_depth=depth)
        out[case] = measured(lambda: sf.leaf_program(spec, left, right,
                                                     out_dtype, seed=seed))
        del left, right
    return {case: out[case] for case in cases}


def _run(args: list) -> str:
    proc = subprocess.run([sys.executable, __file__, *args],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{args} failed:\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path)
    ap.add_argument("--change", type=pathlib.Path,
                    default=pathlib.Path(__file__).resolve().parents[1])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated, of " + ", ".join(CASES))
    ap.add_argument("--time", type=pathlib.Path, help=argparse.SUPPRESS)
    ap.add_argument("--build", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    cases = tuple(args.cases.split(","))
    if not set(cases) <= set(CASES):
        ap.error(f"--cases: unknown {sorted(set(cases) - set(CASES))}")
    if args.time is not None:
        print(json.dumps(_time_side(args.time.resolve(), cases)))
        return 0
    if args.build is not None:
        sys.path.insert(0, str(args.build.resolve() / "src"))
        from repro_torch.kernels import _build
        for name in ("leaf_products", "leaf_program", "syrk", "matmul"):
            if (_build.CSRC / f"{name}.cu").exists():
                _build.build(name)
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    import torch
    if not torch.cuda.is_available():
        print("ab_leaf_program: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    sides = {"parent": args.parent.resolve(), "change": args.change.resolve()}
    builds = [subprocess.Popen([sys.executable, __file__, "--build",
                                str(root)]) for root in sides.values()]
    if any(b.wait() for b in builds):
        return 1
    runs = {side: [] for side in sides}
    for r in range(args.rounds):
        for side in ("parent", "change", "change", "parent"):
            times = json.loads(_run(["--time", str(sides[side]),
                                     "--cases", args.cases]))
            runs[side].append(times)
            print(f"round {r} {side}: " + ", ".join(
                f"{k} {v['ms']:.3f} ms ({v['hash'][:12]})"
                for k, v in times.items()), flush=True)
    summary = {}
    for case in cases:
        med = {side: statistics.median(t[case]["ms"] for t in runs[side])
               for side in sides}
        hashes = {t[case]["hash"] for side in sides for t in runs[side]}
        summary[case] = {**med, "change_over_parent":
                         med["change"] / med["parent"],
                         "same_bits": len(hashes) == 1,
                         "hash": sorted(hashes)}
        print(f"{case}: parent {med['parent']:.3f} ms, change "
              f"{med['change']:.3f} ms, change / parent "
              f"{med['change'] / med['parent']:.4f}; every run's output "
              f"bits equal: {len(hashes) == 1}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
