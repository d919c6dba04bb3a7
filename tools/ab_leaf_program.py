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
defaults, the kernel, the unpack); the accumulator library
(``leaf_products_acc``, an fp32 output): ata with a bf16 accumulator on
A and with an fp64 one on A in fp64 (``ata_acc_bf16``, ``ata_acc_f64``),
the same of the dps gram in pair mode (``ata_dps_acc_bf16``,
``ata_dps_acc_f64``) and the rank_k chunk (``rank_k_acc_bf16``,
``rank_k_acc_f64``, an fp64 stack for the latter); flash attention at the
serving prefill, q (1, 16, 2048, 128) over k, v (1, 2, 2048, 128),
causal, in bf16, fp16 and fp32 (``flash_bf16``, ``flash_f16``,
``flash_f32``: the CUDA-core body), and the fp32 one at the prefill's
first 512 and 1024 rows over the same cache (``flash_f32_s512``,
``flash_f32_s1024``); and the batched launch
(``leaf_program`` on a ``BoundGram``'s padded (K, m, n) stack, levels 1,
tiles of 256, fp32, seed 0): ``batched_ata_8192`` and ``batched_ata_256``
(4 slots of 8192^2 and 256^2), ``batched_aat_256``, and
``batched_shampoo``, the 24 stacks of one statistics step of Shampoo on
Qwen2.5-3B at 2 layers (blocks of 1024) launched in turn; and the same 24
stacks through their ``BoundGram`` (bound before the timing) end to end,
pad, launch and symmetric unpack (``batched_shampoo_sym``, what
``batched_gram`` runs).  ``--cases`` picks some of them.  A time is the median of 5 CUDA-event timings after 2 warm-ups; the
summary gives each side's median over its processes and the change over
the parent.  Flash cases also give their device time (``device_ms``: 20
calls captured in one CUDA graph, replayed between two events), which
leaves out the host's time to launch, the larger part of an event pair
around one 0.1 ms call.  Each process also hashes each case's output
(sha256 of its bytes), and the summary says whether every run of both
sides gave the same bits.  It prints the card's name and power limit.
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
FLASH = {"flash_bf16": ("bfloat16", 2048), "flash_f16": ("float16", 2048),
         "flash_f32": ("float32", 2048), "flash_f32_s512": ("float32", 512),
         "flash_f32_s1024": ("float32", 1024)}
# the accumulator library: (kind, gram, accumulator)
ACC = {f"{kind}{'_dps' if gram == 'dps' else ''}_acc_{short}":
       (kind, gram, acc)
       for kind, gram in (("ata", "strassen"), ("ata", "dps"),
                          ("rank_k", "strassen"))
       for short, acc in (("bf16", "bfloat16"), ("f64", "float64"))}
# the batched launch: (kind, stacks (K, m, n), launched in turn)
SHAMPOO_STACKS = ([(8, 1024, 1024)] * 4 + [(44, 1024, 1024)] * 6
                  + [(4, 256, 1024)] * 2 + [(4, 1024, 256)] * 2
                  + [(2, 2, 1024)] * 3 + [(2, 1024, 2)] * 3
                  + [(1, 2, 256)] * 2 + [(1, 256, 2)] * 2)
BATCHED = {"batched_ata_8192": ("ata", [(4, 8192, 8192)]),
           "batched_ata_256": ("ata", [(4, 256, 256)]),
           "batched_aat_256": ("aat", [(4, 256, 256)]),
           "batched_shampoo": ("ata", SHAMPOO_STACKS)}
# the batched program end to end, its symmetric grams out
SYM = ("batched_shampoo_sym",)
CASES = ("ata", "aat", "rank_k", "symm", "matmul", "ata_dps", "ata_bf16",
         "ata_bf16_out") + tuple(ACC) + SINGLE + E2E + tuple(FLASH) \
    + tuple(BATCHED) + SYM


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

    def device_ms(fn, calls=20):
        """One call's device time: ``calls`` calls in one CUDA graph."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        return timed(graph.replay) / calls

    def measured(fn, device=False):
        """(ms, sha256 of the output's bytes; of each in turn where ``fn``
        returns a list) and, where asked, the device time."""
        res = fn()
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for x in res if isinstance(res, list) else [res]:
            digest.update(x.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes())
        return {"ms": timed(fn), "hash": digest.hexdigest(),
                **({"device_ms": device_ms(fn)} if device else {})}

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
    for case in (c for c in cases if c in ACC):
        kind, gram, acc = ACC[case]
        x = a.double() if acc == "float64" else a
        seed = None
        if kind == "ata":
            spec, left = sf._prepare_ata(x, levels, "strassen", gram, block,
                                         block, pipeline_depth=depth,
                                         acc_dtype=acc)
        else:
            T = -(-n // block)
            seed = pack_tril_blocks(torch.tril(torch.randn(
                T * block, T * block, generator=gen, device=dev)),
                block).to(x.dtype)
            spec, left = sf._prepare_rank_k(seed, x[:rows], levels,
                                            "strassen", gram, block,
                                            pipeline_depth=depth,
                                            acc_dtype=acc)
        out[case] = measured(lambda: sf.leaf_program(spec, left, left, f32,
                                                     seed=seed))
        del x, left, seed
    for case in (c for c in cases if c in FLASH):
        dtype, sq = getattr(torch, FLASH[case][0]), FLASH[case][1]
        q, k, v = (torch.randn(1, heads, 2048, 128, generator=gen,
                               device=dev).to(dtype) for heads in (16, 2, 2))
        q = q[:, :, :sq].contiguous()
        out[case] = measured(lambda: k_flash.flash_attention(q, k, v),
                             device=True)
        del q, k, v
    for case in (c for c in cases if c in BATCHED):
        kind, stacks = BATCHED[case]
        runs = []
        for slots, rows_, cols_ in stacks:
            x = torch.randn((slots, rows_, cols_), generator=gen, device=dev)
            bound = sf.BoundGram(rows_, cols_, batch=slots,
                                 gram_of="cols" if kind == "ata" else "rows",
                                 levels=1, b_out=block, b_k=block,
                                 out_dtype=f32, device=dev)
            runs.append((bound.spec, sf._pad_stored(x, *bound.padded, None)))
            del x
        out[case] = measured(lambda: [sf.leaf_program(spec, sp, sp, f32)
                                      for spec, sp in runs])
        del runs
    if "batched_shampoo_sym" in cases:
        runs = []
        for slots, rows_, cols_ in SHAMPOO_STACKS:
            x = torch.randn((slots, rows_, cols_), generator=gen, device=dev)
            runs.append((sf.BoundGram(rows_, cols_, batch=slots, levels=1,
                                      b_out=block, b_k=block, out_dtype=f32,
                                      device=dev), x))
        out["batched_shampoo_sym"] = measured(
            lambda: [bound(x, symmetrize=True) for bound, x in runs])
        del runs
    for case in (c for c in cases if c not in SINGLE + E2E + tuple(FLASH)
                 + tuple(ACC) + tuple(BATCHED) + SYM):
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
        # the libraries the cases run: the leaf program's for a fused case
        # (the accumulator library's for its own), syrk and matmul for the
        # others
        names = (("leaf_products", "leaf_program")
                 if set(cases) - set(SINGLE + LEAVES + tuple(FLASH)
                                     + tuple(ACC))
                 else ()) + \
            (("leaf_products_acc",) if set(cases) & set(ACC) else ()) + \
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
        line = (f"{case}: parent {med['parent']:.3f} ms, change "
                f"{med['change']:.3f} ms, change / parent "
                f"{med['change'] / med['parent']:.4f}")
        if "device_ms" in runs["parent"][0][case]:
            dev = {side: statistics.median(t[case]["device_ms"]
                                           for t in runs[side])
                   for side in sides}
            summary[case]["device_ms"] = dev
            line += (f"; device {dev['parent']:.4f} -> {dev['change']:.4f} "
                     f"ms, {dev['change'] / dev['parent']:.4f}")
        print(f"{line}; every run's output bits equal: {len(hashes) == 1}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
