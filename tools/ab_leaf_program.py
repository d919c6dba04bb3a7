#!/usr/bin/env python3
"""Time the leaf program's kernel, and the syrk and matmul kernels, in two
checkouts of the port on one card.

    python3 tools/ab_leaf_program.py --parent DIR [--change DIR] [--rounds 2]
                                     [--cases ata,syrk,...]

Each checkout is a directory holding ``src/repro_torch`` (unpack the
parent with ``git archive <commit> | tar -x -C DIR`` into a directory
that ``.gitignore`` lists).  Both build what the cases run (``leaf_products``
and whatever else their ``leaf_program`` launches; ``syrk`` and ``matmul``;
``flash_attention``) into their own ``build/`` first, at once.  Then each round runs one process per side in the order
parent, change, change, parent, each timing ``strassen_fused.leaf_program``
on the main path's padded operands at n = 10000, seed 0, levels 2, tiles
of 256, at the default pipeline depth and block tile: the ata, aat and
rank_k kinds (one 2500-row chunk into a 40-tile stack) of the strassen
gram, the symm kind (the backward's X @ (S + S^t)), the matmul kind, ata
of the dps gram, ata on bf16 operands (``ata_bf16``) and ata into a bf16
output (``ata_bf16_out``); ``syrk_packed`` and ``matmul_padded`` (blocks of
256, the default block tile) on the padded 10240^2 A (and B) of
``ops.syrk(a)`` and ``ops.matmul(a, b)`` and on the reference recursion's
2560^2 leaf (``syrk_leaf``, ``matmul_leaf``), in fp32 and, with the
suffix ``_f16`` or ``_bf16`` (``syrk_f16``, ``syrk_leaf_f16``,
``matmul_f16``, ``matmul_leaf_f16`` and their bf16 twins), on operands of
that type with an output of that type; the reference recursion on
kernel leaves end to end, ``ata(a, base_syrk=ops.kernel_base_syrk(),
base_matmul=ops.kernel_base_matmul())`` on fp32 A (``ata_leaves``) and
fp16 A (``ata_leaves_f16``), 16 syrk and 22 matmul leaves each; the main
path end to end, ``ata(a)`` (``ata_e2e``: the entry point's block
defaults, the kernel, the unpack); and flash attention at the serving prefill, q (1, 16,
2048, 128) over k, v (1, 2, 2048, 128), causal, in bf16 and fp16
(``flash_bf16``, ``flash_f16``).  ``--cases`` picks some of them.  A time is the median of 5 CUDA-event timings after 2 warm-ups; the
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

# the single-purpose kernels' cases: fp32, then 16-bit (the suffix names
# the operand and output type)
SINGLE32 = ("syrk", "syrk_leaf", "matmul_padded", "matmul_leaf")
SINGLE16 = tuple(f"{c}_{t}" for t in ("f16", "bf16")
                 for c in ("syrk", "syrk_leaf", "matmul", "matmul_leaf"))
SINGLE = SINGLE32 + SINGLE16
# the reference recursion on kernel leaves, end to end
LEAVES = ("ata_leaves", "ata_leaves_f16")
# the entry points end to end
E2E = ("ata_e2e",) + LEAVES
# flash attention at the serving prefill
FLASH = ("flash_bf16", "flash_f16")
CASES = ("ata", "aat", "rank_k", "symm", "matmul", "ata_dps", "ata_bf16",
         "ata_bf16_out") + SINGLE + E2E + FLASH


def _time_side(root: pathlib.Path, cases: tuple) -> dict:
    sys.path.insert(0, str(root / "src"))
    import importlib

    import torch
    import torch.nn.functional as F
    from repro_torch.core import ata
    from repro_torch.core.symmetry import pack_tril_blocks
    from repro_torch.kernels import ops
    from repro_torch.kernels import strassen_fused as sf
    k_syrk, k_matmul, k_flash = (
        importlib.import_module(f"repro_torch.kernels.{m}")
        for m in ("syrk", "matmul", "flash_attention"))

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
        base, _, suffix = case.rpartition("_") if case in SINGLE16 \
            else (case, "", "")
        dtype = {"f16": torch.float16, "bf16": torch.bfloat16}.get(suffix,
                                                                    f32)
        big = base in ("syrk", "matmul_padded", "matmul")
        x = padded(a if big else a[:n // 4, :n // 4].contiguous()).to(dtype)
        if case.startswith("syrk"):
            out[case] = measured(lambda: k_syrk.syrk_packed(x, bk=block,
                                                            bn=block))
        else:
            y = padded(torch.randn(x.shape, generator=gen,
                                   device=dev)).to(dtype)
            out[case] = measured(lambda: k_matmul.matmul_padded(
                x, y, bm=block, bk=block, bn=block))
            del y
        del x
    hooks = dict(base_syrk=ops.kernel_base_syrk(),
                 base_matmul=ops.kernel_base_matmul())
    if "ata_leaves" in cases:
        out["ata_leaves"] = measured(lambda: ata(a, **hooks))
    if "ata_leaves_f16" in cases:
        a16 = a.half()
        out["ata_leaves_f16"] = measured(lambda: ata(a16, **hooks))
        del a16
    if "ata_e2e" in cases:
        out["ata_e2e"] = measured(lambda: ata(a))
    for case in (c for c in cases if c in FLASH):
        dtype = torch.float16 if case == "flash_f16" else torch.bfloat16
        q, k, v = (torch.randn(1, heads, 2048, 128, generator=gen,
                               device=dev).to(dtype) for heads in (16, 2, 2))
        out[case] = measured(lambda: k_flash.flash_attention(q, k, v))
        del q, k, v
    for case in (c for c in cases if c not in SINGLE + E2E + FLASH):
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
        # the libraries the cases run: the leaf program's for a fused case,
        # syrk and matmul for the others
        names = (("leaf_products", "leaf_program")
                 if set(cases) - set(SINGLE + LEAVES + FLASH) else ()) + \
            (("syrk", "matmul") if set(cases) & set(SINGLE + LEAVES)
             else ()) + \
            (("flash_attention",) if set(cases) & set(FLASH) else ())
        for name in names:
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
                                str(root), "--cases", args.cases])
              for root in sides.values()]
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
