#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed 0] [--n 10000]

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit.  Phases, each of which asserts (nothing is caught, any
failure exits non-zero):

1. device: the card's name and power limit, torch/CUDA versions, and
   both TF32 flags, set off;
2. build: every kernel library of ``src/repro_torch/kernels/csrc`` from
   source, one ``nvcc`` each, all started together, each one's build
   time, and the registers and spills of every flash-attention
   instantiation, by core and block tile of the syrk and matmul ones, and
   of the leaf program's three libraries by operand type, accumulator,
   layout, tile and mode; no wgmma serialized by ptxas (C7514) in syrk,
   matmul or flash; ``cuobjdump -sass``: HGMMA in each of the 12
   tensor-core kernels of syrk and of matmul and in none of their
   CUDA-core ones; the core the C side picks for each of the 3 x 3
   operand pairs equal to ``_launch.product_core``'s;
3. the leaf program's kernel, ``leaf_products.cuh`` (``leaf_products.cu``
   for fp32 and bf16 operands; ``_lowp`` and ``_acc`` below), against its plain
   torch version ``_leaf_products_plain`` on the card, for every kind
   and both grams (the dps gram's programs, whose destinations may be
   transposed, in pair mode), one sub-phase per program kind, each over
   its sweep at ragged shapes (tiles of 64), with bf16 operands, a bf16
   output and a tile-aligned 1024^2 at 128, each launch counted: kernel
   vs plain <= 1e-5 of max|out| (fp32 sums in another order; 2^-8 for a
   bf16 output) and bit-equal for the dps gram, the gram kinds also
   against the TPU kernel's destination walk ``_leaf_program_plain``
   (<= 1e-5), kernel vs float64 <= 1e-4 (the JAX suite's bar for the
   deeper algebras), ring depths 1-4 at block tiles 64 and 128 bit-equal
   to the default launch, and a depth and tile whose shared memory would
   exceed 227 KB refused:
   3. ata, tril(A^t A), algebra x gram x levels 0-3 at 1000x777;
   3b. symm, X @ Sym and X @ (S + S^t) from a packed stack, algebra x
       levels 0-3 x diag_sym at X 1000x777 against a 16-tile stack;
   3c. aat, tril(A A^t), algebra x gram x levels 0-3 at 1000x777;
   3d. rank_k, C + tril(A^t A) seeded from a packed 16-tile stack,
       algebra x gram x levels 0-3 at a 1000x777 chunk, a bf16 stack
       under an fp32 output and the reverse, and the update written over
       its own seed for each gram, in fp32 and bf16;
   3e. matmul, op(A) op(B), levels 0-3 x the four (trans_a, trans_b)
       cases x {strassen, winograd, classical, bb322, bb422} at
       1000x777 @ 777x555;
   3f-3i. the syrk, matmul, combine and transpose kernels against their
       plain versions over ragged shapes (tests/test_kernels.py's and
       1000x777[x555]) x blocks 8, 32, 40, 128, 256 (and 136, 200 at
       1000x777[x555]) x fp32 and bf16 (transpose also int32): syrk and
       matmul at both block tiles of their core (64 and 128), the two
       bit-equal, <= 1e-5 of max|out| of the plain version (2^-8 for a
       bf16 output) and <= 1e-4 against float64, bf16 A (and bf16 with
       bf16) on the tensor cores, where K and the tile edges are ragged to
       its 64-deep chunk and 128-wide tile; combine and transpose
       ``torch.equal``; what the wrappers refuse on the card;
   3k. the precision axes, ``leaf_products_lowp.cu`` (fp16, fp8 e4m3fn
       and e5m2 operand tiles) and ``leaf_products_acc.cu`` (a bf16 or
       fp64 accumulator) and fp64 operands stored as fp32, over every kind
       and both grams at 1000x777 (levels 2, tiles of 64; ata and aat
       also at 1024^2 and tiles of 128), pair mode, fp8 at block edges of
       40 (row strides of 8 mod 16 bytes, widened), fp64 and fp16 seeds
       and outputs: kernel vs plain <= 1e-5 of max|out| (2^-7 for the
       bf16 accumulator; the fp64 accumulator bit-equal, and on K blocks
       whose parts are 1 and 2^-30 in turn exactly 2 + 2^-29 where the
       fp32 one gives 2), vs the destination walk likewise, vs the
       float64 product of the quantized operands <= 1e-4 (the bf16
       accumulator: within 1.5x the destination walk's own error), every
       requested ring depth and both block tiles bit-equal (the ring depth
       that ran printed);
   3j. the flash_attention kernel (bf16 on the tensor cores, fp32 on the
       CUDA cores) against its plain version on (B, H, S, D) operands:
       tests/test_flash_attention.py's grid, windows 16 and 48, softcap
       50, non-causal (Skv 64 and 96), Qwen2.5-3B's shapes (B 1, H 16, Hkv
       2, D 128, Sq 128, 1000 and 2048 over Skv 2048), D 256 with window
       and softcap and non-causal, D 80 (causal, GQA, a ragged Sq, window
       with softcap, non-causal), each in fp32 and bf16, held of max|out|
       and row by row (each row's max|d| over that row's max|plain|): fp32
       <= 1e-5 both, bf16 <= 5e-3 and <= 2^-6 (a one-ulp flip of a bf16
       row maximum is up to 2^-7 of it); the same measures of the kernel's
       output with its rows past the first q tile (128 rows in bf16, 64
       in fp32) zeroed (a kernel wrong past tile 0) must exceed the bars;
       ``ops.flash_mha``
       over the grid and a causal Sq 80 over Skv 40 (kv zero-padded as in
       the JAX package) against itself on the CPU; a bad head_dim, a view
       and an operand that requires grad refused;
   3l. fp16 operands in the single-purpose kernels, through 3f-3j's
       sweeps: syrk (fp16 in, out, or both; fp16 with bf16) and matmul
       (fp16, and fp16 mixed with fp32 and bf16, which promote to fp32, and
       fp16 outputs; fp16 into bf16 and bf16 into fp16 on the tensor
       cores) at both tiles, bit-equal across tiles, within 1e-5 of
       max|out| of the plain version for an fp32 output and 2^-10 for an
       fp16 one (tighter than bf16's 2^-8); combine in fp16 bit-equal;
       flash attention in fp16 on the tensor cores within fp16's own bars
       (1.5e-3 of max|out|, 2^-8 row by row: bf16-precision arithmetic
       would fail them), its planted fault above them;
4. the main paths at n x n fp32 from ``--seed`` (the paper's n = 10000),
   each with the launch counts zeroed just before it and read just
   after, by kind and by library, checked against float64 on the card
   (<= 1e-4 of max|out|; outputs stored in bf16 <= 2^-8), then each
   kernel configuration the path ran held against the plain version on
   the same operands (<= 1e-5):
   4. ``ata(a)``, ``ata_full(a, levels="auto")``, ``ata(bf16 a)`` and
      ``ata(a, gram="dps")``, each on ``leaf_products.cu`` (the last in
      pair mode, also held against the destination walk);
   4b. their backward, ``torch.autograd.grad`` through ``ata``,
       ``ata_full``, ``ata(bf16 a)`` and ``ops.ata_fused_packed``, dA
       against float64 ``A (S + S^t)``, and the peak memory of one
       backward with ``bwd="fused"`` below that with ``bwd="dense"``;
   4c. ``ata(a, gram_of="rows")`` at n x n and at n x 777, and on bf16 A;
   4d. ``ops.rank_k_update``: A streamed in 4 row chunks into a zero
       packed stack (bn 256), against the one-shot ``ops.ata_fused_packed``
       (<= 1e-5 of max|C|) and float64; then one gradient through a chunk
       update, the stack's cotangent passed through exactly and dA against
       float64 ``A (S + S^t)``;
   4e. ``strassen_matmul(a, b)``, ``strassen_matmul(a, b, trans_a=True)``
       (the distributed block task's form) and on bf16 operands, then
       ``torch.autograd.grad`` through the first two (``bwd="fused"``),
       da and db against float64;
   4f. the reference recursion with kernel leaves, ``ata(a, base_syrk=
       ops.kernel_base_syrk(), base_matmul=ops.kernel_base_matmul())`` at
       n x n and n x 777 with its syrk and matmul launches asserted (16
       and 22 at n = 10000), ``strassen_matmul(a, b, base_matmul=...)``
       (49), ``ops.syrk``, ``ops.matmul``, ``ops.strassen_combine`` on the
       seven products of one Strassen level (C against float64 A B),
       ``ops.transpose``, and the refusal of an A that requires grad;
       the same recursion on fp16 A (16 and 22 fp16 leaves, fp32 out,
       <= 2^-8 of max|C| against float64 of the fp16 A), timed end to end
       (its leaves on the tensor cores), and combine on the seven products
       in fp16 (bit-equal to plain); then each leaf configuration against
       its plain version;
   4g. ``ServingEngine`` serving Qwen2.5-3B at full width (36 layers, d
       2048, vocab 151936), bf16, ``attn_impl="flash"``, weights from a
       ``torch.Generator`` on the card seeded with ``--seed``: slots 4,
       max_seq 2048, greedy, 8 requests of 16 new tokens, prompt lengths
       drawn from 100-1500 by numpy with ``--seed`` plus one of 2032 (the
       2048 bucket fills the cache).  36 x 8 = 288 flash launches and no
       other kernel; time to first token, prefill and decode tokens/s,
       peak memory; each prefill's last-position logits against the same
       bf16 forward with plain torch attention (only the attention
       differs), against the same with plain attention in fp32, and
       against the bf16 flash forward with no cache and no bucket padding,
       and request 0's decode logits against a no-cache train-mode
       forward, each <= 0.1 of max|logits| (bf16 noise through 36 layers
       of random weights); the same bf16 forward with a planted fault in
       its attention (the kernel's rows past its first q tile zeroed, or
       each row past it blind to the first kv tile) must exceed that bar
       against plain attention at every prompt; in fp32, the flash kernel
       in the model against plain attention at each prompt, and request
       0's prefill and decode through a cache against no cache, each <=
       1e-4;
   4h. where the serving time goes: one 2032-token prefill and one
       decode tick of 4 slots under ``torch.profiler``, the wall time,
       the device's kernel time, its busy share, the flash kernel's time
       and share, and the top kernels;
   4i. the precision axes at n x n: ``ata(a, operand_dtype=...)`` for
       e4m3fn, e5m2 and fp16, and ``ops.rank_k_update`` streaming e4m3fn
       chunks, each within 1e-4 of the float64 product of the quantized
       operands and passing ``repro_torch.gram.verify.verify_gram`` at
       ``default_rtol``; ``ata(a, acc_dtype="bfloat16")`` within 1.5x the
       destination walk's error against float64, ``ata(fp64 a,
       acc_dtype="float64")`` in fp64; ``ata`` on fp64 and fp16 input and
       into an fp16 output; ``ata(a, out_dtype=bf16, sr_seed=7)`` twice
       (the same bits), with seed 8 (other bits) and through a backward
       (the fp32 core's gradient, exactly); an input past e4m3fn's range
       (NaN once quantized) whose NaNs in the kernel's output lie where
       the plain version's do; each configuration then against its plain
       version (the fp64 accumulator bit-equal);
   4j. the streamed Gram (``repro_torch.gram``): A in 4 chunks of n / 4
       rows through ``GramStream`` (4 ata-kind launches, the n(n+1)/2
       packed state) and ``GramStackStream`` (4 rank_k launches into the
       T(T+1)/2-tile stack), each asserted, each finalize against the
       one-shot ``ata(a)`` (<= 1e-5 of max|C|) and float64 (<= 1e-4), the
       update ms of each chunk and the finalize ms printed;
       ``CheckpointedGramStream`` in both layouts, committing every 2
       chunks into a temporary directory, killed after 3 chunks and resumed
       at chunk 2: ``torch.equal`` to the uninterrupted run, the commit and
       restore ms (the port's tracer spans) and MB printed; one gradient
       through each layout's update, dA against float64 A (S + S^t) <=
       1e-4;
   4k. the distributed layer (``core.distributed``) on a one-rank NCCL
       world (a ``HashStore``, rank 0 of 1) and ``make_gram_mesh(1)`` on
       the card: ``distributed_gram`` on the n x n A for "allreduce",
       "reducescatter", "ring", "bfs25d" and "auto", each against
       ``ata_full(a)`` (<= 1e-5 of max|C|; bit-equality printed), its
       ``gram_dist:<scheme>`` profiler span, and ``distributed_update``
       over 4 chunks of n / 4 rows for "reducescatter" and "ring" against
       it; the launches of ``leaf_products.cu`` counted (a one-rank ring
       has no off-diagonal block: no matmul kind); each scheme's ms beside
       ``ata_full``'s, each update's; the NCCL version; the group
       destroyed at the end;
   4l. autotune on the card: ``autotune(n, n, kind="ata", measure=True)``
       (the 16384^2 bucket at n = 10000) into the script's own cache (a
       fresh temporary file, set before anything reads the cache, so no
       cache on the machine moves an earlier phase's blocks): the
       candidate count, the model's top 3, the measured winner and the
       seconds; where the reference recursion wins, the fused candidates'
       own contest too; then ``ops.ata_fused(a)`` with no block hits the
       cache (the hit counter rises by one) and runs the tuned blocks,
       against the 256-block result (<= 1e-5), both timed; a lookup's
       host cost, hit and miss; the entry then dropped, so phase 5 runs
       the 256 default;
5. times with CUDA events (median of 5 after 2 warm-ups): each kind at
   its main-path shape (depths 2 and 1), its library yardstick (timed
   only, never called by the port), the end-to-end calls, the plain
   versions once, and each kind's bound: the least flops of its function
   (each leaf product once, or classical, whichever is less) at the fp32
   CUDA-core peak against its inputs and outputs once at HBM rate.  The
   kernel's own flops are printed beside the bounds and kept out of
   them: each leaf product once (``product_flops``), every kind also
   timed at both block tiles with its positions, blocks, blocks an SM
   and waves on the 132 SMs; the dps gram's ata, aat and rank_k in pair
   mode beside the strassen gram's, with the TPU walk's live-step flops
   (the per-destination recomputation) printed for comparison.
   The syrk, matmul, combine and transpose kernels are timed on the
   padded operands of the main path's ``ops`` calls (syrk and matmul at
   both block tiles, each launch's shape printed, and at the recursion's
   2560 leaf with its own bound and library call), with ``ata`` and
   ``strassen_matmul`` end to end on kernel leaves beside their
   ``torch.matmul`` leaves and the fused path.  flash_attention is timed
   at the serving prefill, q (1, 16, 2048, 128) over k/v (1, 2, 2048,
   128), causal, bf16, beside ``F.scaled_dot_product_attention`` (timed
   only), by events and as device time (20 calls in a CUDA graph,
   replayed), and at that prefill's first 512 and 1024 rows over the
   same cache; its bound is 4 D flops for each unmasked (q, k) pair at the
   bf16 tensor-core peak against q, k, v and o once at HBM rate.  The
   precision axes' libraries at their main-path shapes: the ata kind on
   e4m3fn, e5m2 and fp16 tiles and the rank_k kind on an e4m3fn chunk
   (``leaf_products_lowp``), ata with a bf16 and an fp64 accumulator
   (``leaf_products_acc``), each bound counting the stored bytes at
   their own element size and the kind's yardstick beside it.  16-bit
   operands in the single-purpose kernels: ``syrk`` and ``matmul`` in
   fp16 and in bf16 on the tensor cores at the padded 10240^2 and the
   2560^2 leaf (each at both tiles), combine on seven fp16 5120^2 and
   flash attention at the serving prefill in fp16, each against its plain
   version and beside its library call in the same type
   (``torch.tril(x.T @ x)``, ``x @ y``, fp16 SDPA), bound at the 16-bit
   tensor-core peak (989 TFLOP/s) or its bytes, whichever is larger.
   Each syrk and matmul row names its core.

It prints one ``{"distributed": ..., "autotune": ...}`` line (phases 4k
and 4l), one ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": ...}`` line.  Without a CUDA device it exits 1
and prints no result.
"""
from __future__ import annotations

import argparse
import atexit
import concurrent.futures
import ctypes
import dataclasses
import importlib
import json
import pathlib
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

# H100 SXM data-sheet peaks at the 700 W limit (NVIDIA H100 data sheet):
# fp32 on the CUDA cores (no tensor cores, no TF32) and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# the leaf program's kernel, built as three libraries (one translation unit
# each): leaf_products.cu runs every kind and gram on fp32 and bf16 tiles,
# _lowp on fp16 and fp8 ones, _acc with a bf16 or fp64 accumulator
PRODUCTS_SOURCE = "src/repro_torch/kernels/csrc/leaf_products.cuh"
REPLACES = ("src/repro/kernels/strassen_fused.py:474 (_leaf_kernel) and "
            "src/repro/kernels/strassen_fused.py:533 (_pipelined_kernel), "
            "{} kind")
# the H100 SXM's SMs, for the waves of a leaf_products launch
SMS = 132
# the bf16 tensor-core peak (dense), for flash attention's bound
PEAK_BF16_FLOPS = 989e12
LIBRARIES = ("leaf_products", "leaf_products_lowp", "leaf_products_acc",
             "syrk", "matmul", "combine", "transpose", "flash_attention")
# the single-purpose kernels: their sources and the TPU kernels they replace
KERNELS = {
    "syrk": ("src/repro_torch/kernels/csrc/syrk.cu",
             "src/repro/kernels/syrk.py:37 (_syrk_kernel, launched by "
             "syrk_packed :54)"),
    "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
               "src/repro/kernels/matmul.py:21 (_matmul_kernel, launched by "
               "matmul_padded :37)"),
    "combine": ("src/repro_torch/kernels/csrc/combine.cu",
                "src/repro/kernels/combine.py:17 (_combine_kernel, launched "
                "by strassen_combine :25)"),
    "transpose": ("src/repro_torch/kernels/csrc/transpose.cu",
                  "src/repro/kernels/transpose.py:17 (_transpose_kernel, "
                  "launched by transpose_padded :21)"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:27 "
                        "(_flash_kernel, launched by flash_attention :82)"),
}
# tests/test_flash_attention.py's grid: (b, sq, skv, h, hkv, d)
FLASH_GRID = [(2, 64, 64, 4, 4, 32), (2, 64, 64, 8, 2, 32),
              (1, 128, 128, 4, 1, 16), (1, 48, 48, 2, 2, 64),
              (2, 32, 96, 4, 4, 32)]
# Qwen2.5-3B's attention: 16 query heads, 2 kv heads, head_dim 128, a
# 2048-slot cache
QWEN_HEADS, QWEN_KV_HEADS, QWEN_HEAD_DIM, MAX_SEQ = 16, 2, 128, 2048
# Phase 3j's, 3l's and phase 5's bars for the flash kernel against its
# plain version, by dtype: (of max|out|, row by row).  The two round p at
# the same place, so bf16 differs by the output's rounding: a one-ulp flip
# is up to 2^-7 of an element.  fp16's flip is up to 2^-10: its bars sit
# ~3-4x above its sound readings (4.55e-4 of max|out|, 9.61e-4 by row on
# an H100) and below what bf16-precision arithmetic reads there (2.8e-3,
# 7.7e-3), so an fp16 kernel that packed p or staged operands in bf16
# fails them.
FLASH_BARS = {"float32": (1e-5, 1e-5), "bfloat16": (5e-3, 2 ** -6),
              "float16": (1.5e-3, 2 ** -8)}
# Phases 3f-3g's and 3l's bars for syrk and matmul against their plain
# version, of max|out|, by output dtype: fp32 sums in another order, then
# one rounding to a bf16 or fp16 output (a one-ulp flip of an element is
# at most 2^-8, 2^-10 of max|out|: fp16's bar is the tighter).
PRODUCT_BARS = {"float32": 1e-5, "bfloat16": 2.0 ** -8, "float16": 2.0 ** -10}
# Phase 4g's bars, of max|logits|.  bf16: the engine's logits against the
# same model with plain attention, in bf16 and in fp32, and its decode
# against a no-cache bf16 forward.  Any bf16 rounding that differs, even
# another matmul shape, grows through 36 layers of random weights to
# 4e-2 - 5e-2 of max|logits|; a planted fault in the attention reads
# 0.4 - 1.4 (PERF.md, PR 15).  fp32: the same comparisons with the flash
# kernel and the cache in fp32, where sums in another order are all that
# differ.
SERVE_BF16_BAR, SERVE_F32_BAR = 1e-1, 1e-4
# tests/test_kernels.py's shapes, and the phase-3 ragged shape
SHAPES_MM = [(32, 32, 32), (64, 128, 32), (100, 70, 50), (256, 256, 256),
             (257, 129, 65), (16, 512, 16), (1000, 777, 555)]
SHAPES_SYRK = [(64, 64), (128, 32), (96, 96), (100, 40), (33, 65),
               (256, 128), (1000, 777)]
SHAPES_2D = [(64, 64), (32, 96), (100, 50), (256, 256), (257, 65),
             (1000, 777)]
# the JAX suite's 32, the main path's 256, and edges that are not
# multiples of the syrk and matmul core's 64 or 128 sub-tile or 16-deep
# chunk; at the 1000x777[x555] shape also edges ragged at tile 128
BLOCKS = (8, 32, 40, 128, 256)
WIDE_BLOCKS = (136, 200)


def _rel(got, want) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


def _row_rel(got, want) -> float:
    """The largest, over rows (the last axis), of a row's max|got - want|
    over that row's max|want|."""
    got, want = got.double(), want.double()
    return float(((got - want).abs().amax(-1) / want.abs().amax(-1)).max())


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


_TYPE_NAMES = {"f": "fp32", "d": "fp64", "__nv_bfloat16": "bf16",
               "__half": "fp16", "__nv_fp8_e4m3": "e4m3fn",
               "__nv_fp8_e5m2": "e5m2"}


def _leaf_instantiation(mangled: str):
    """(operand types, accumulator, tri right side, tile, ring depth, pair
    mode) of a ``leaf_products`` kernel from its mangled name
    (``leaf_products_kernel<Tl, Tr, TRI, TILE, STAGES, PAIRS>`` or
    ``leaf_products_acc_kernel<Tl, Tr, Acc, ...>``), or None.  A
    substitution (``S1_``) names the class type named last."""
    found = re.search(r"leaf_products(_acc)?_kernelI(.*?)Lb(\d)ELi(\d+)ELi"
                      r"(\d)ELb(\d)E", mangled)
    if not found:
        return None
    args, types, last = found.group(2), [], None
    while args:
        if args[0] in "fd":
            types.append(_TYPE_NAMES[args[0]])
            args = args[1:]
        elif args[0] == "S":
            types.append(last)
            args = args[args.index("_") + 1:]
        else:
            digits = re.match(r"\d+", args).group(0)
            name = args[len(digits):len(digits) + int(digits)]
            last = _TYPE_NAMES.get(name, name)
            types.append(last)
            args = args[len(digits) + int(digits):]
    acc = types[2] if found.group(1) else "fp32"
    return (f"{types[0]}/{types[1]}", acc, found.group(3) == "1",
            int(found.group(4)), int(found.group(5)), found.group(6) == "1")


def _ptxas_summary(report: str, by_depth: bool = False) -> list:
    """Registers and spills of a ``leaf_products`` library from ``nvcc
    -Xptxas -v``, one line per operand types, accumulator, right-side
    layout, block tile and mode: the ring depths together, or each alone
    (``by_depth``)."""
    stats, key = {}, None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            inst = _leaf_instantiation(entry.group(1))
            key = None if inst is None else (inst[0], inst[1], inst[2],
                                             inst[3], inst[5],
                                             inst[4] if by_depth else None)
        regs = re.search(r"Used (\d+) registers", line)
        spill = re.search(r"(\d+) bytes spill stores", line)
        if key and (regs or spill):
            entry = stats.setdefault(key, {"regs": [], "spill": [0]})
            if regs:
                entry["regs"].append(int(regs.group(1)))
            if spill:
                entry["spill"].append(int(spill.group(1)))
    return [f"{types} tiles, {acc} accumulator, "
            f"{'tri' if tri else 'dense'} right side, tile {tile}"
            f"{', pair mode' if pair else ''}"
            f"{f', ring depth {depth}' if depth else ''}: {len(v['regs'])} "
            f"instantiation(s), {min(v['regs'])}-{max(v['regs'])} registers, "
            f"spill stores up to {max(v['spill'])} B"
            for (types, acc, tri, tile, pair, depth), v in
            sorted(stats.items(), key=lambda kv: str(kv[0]))]


def _device_ms(fn, n=20):
    """The device time of one call of ``fn``: ``n`` calls captured in one
    CUDA graph, the graph replayed between two events (``_time_ms``), over
    ``n``.  Unlike an event pair around one call, it leaves out the host's
    time to launch."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # first use outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    ms, _ = _time_ms(graph.replay)
    return ms / n


def _ptxas_flash(report: str) -> list:
    """Registers and spills of each flash-attention instantiation from
    ``nvcc -Xptxas -v``: the tensor-core kernel by its type (bf16, fp16)
    and head_dim, the fp32 CUDA-core body by its head_dim.  The
    tensor-core kernel's count is its entry budget (384 threads);
    setmaxnreg moves the producer warpgroup to 24 and the consumers to
    240 after entry."""
    stats, kind = {}, None
    for line in report.splitlines():
        found = re.search(r"(flash_tc_kernel|flash_kernel)ILi(\d+)E"
                          r"(?:\d+(__nv_bfloat16|__half)E)?", line)
        if found:
            kind = (f"{_TYPE_NAMES[found.group(3)]} tensor cores, D "
                    f"{found.group(2)}" if found.group(1) == "flash_tc_kernel"
                    else f"fp32 CUDA cores, D {found.group(2)}")
            stats[kind] = {"regs": None, "spill": 0}
        spill = re.search(r"(\d+) bytes spill stores", line)
        regs = re.search(r"Used (\d+) registers", line)
        if kind and spill:
            stats[kind]["spill"] = int(spill.group(1))
        if kind and regs:
            stats[kind]["regs"] = int(regs.group(1))
    return [f"{k}: {v['regs']} registers, {v['spill']} B of spill stores"
            for k, v in stats.items()] + [
        f"wgmma serialized by ptxas (C7514): {report.count('C7514')} times"]


def _ptxas_tiles(report: str, kernel: str) -> list:
    """Instantiations, registers and spills of the syrk or matmul kernel
    by core (``<kernel>_kernel``: the CUDA cores, ``<kernel>_tc_kernel``:
    the tensor cores) and block tile (the first template argument) from
    ``nvcc -Xptxas -v``, and the count of ptxas's C7514 warnings (wgmma
    serialized)."""
    stats, key = {}, None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            found = re.search(rf"{kernel}(_tc)?_kernelILi(\d+)E",
                              entry.group(1))
            key = None if found is None else (
                "tensor" if found.group(1) else "cuda", int(found.group(2)))
            if key:
                stats.setdefault(key, {"regs": [], "spill": [0]})
        regs = re.search(r"Used (\d+) registers", line)
        spill = re.search(r"(\d+) bytes spill stores", line)
        if key is not None and regs:
            stats[key]["regs"].append(int(regs.group(1)))
        if key is not None and spill:
            stats[key]["spill"].append(int(spill.group(1)))
    return [f"{core} cores, tile {t}: {len(v['regs'])} instantiations, "
            f"{min(v['regs'])}-{max(v['regs'])} registers, spill stores up "
            f"to {max(v['spill'])} B" for (core, t), v in
            sorted(stats.items())] + [
        f"wgmma serialized by ptxas (C7514): {report.count('C7514')} times"]


def _sass_hgmma(library: pathlib.Path) -> dict:
    """The HGMMA (wgmma) instructions of each kernel of a built library,
    from ``cuobjdump -sass``: {mangled name: count}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            counts[name] = 0
        elif name is not None and "HGMMA" in line:
            counts[name] += 1
    return counts


def _ptxas_registers(report: str) -> str:
    """Instantiations, registers and spills of a library from ``nvcc
    -Xptxas -v``."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
    spill = [int(b) for b in re.findall(r"(\d+) bytes spill stores", report)]
    if not regs:
        return "no ptxas report"
    return (f"{len(regs)} instantiations, {min(regs)}-{max(regs)} registers, "
            f"spill stores up to {max(spill, default=0)} B")


def hooked_leaves(m: int, n: int, levels: int, leaf: int):
    """(syrk, matmul) leaves of the reference ATA recursion on an m x n A,
    as ``core/ata._ata_rec`` and ``core/strassen._strassen_rec`` split."""
    def strassen(m, k, n, levels):
        if levels <= 0 or min(m, k, n) <= leaf:
            return 1
        return 7 * strassen((m + 1) // 2, (k + 1) // 2, (n + 1) // 2,
                            levels - 1)

    if levels <= 0 or m <= leaf or n <= leaf:
        return 1, 0
    m2, n2 = (m + 1) // 2, (n + 1) // 2
    syrk, mm = hooked_leaves(m2, n2, levels - 1, leaf)
    return 4 * syrk, 4 * mm + 2 * strassen(n2, m2, n2, levels - 1)


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
    t_start = time.perf_counter()
    # the autotune cache the block defaults read: a fresh file of the
    # script's own (phase 4l fills it, then drops its entry), so no cache
    # on the machine changes an earlier phase's blocks
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    atexit.register(shutil.rmtree, tune_dir, True)
    os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(tune_dir,
                                                      "gram_autotune.json")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    import torch.nn.functional as F
    from repro_torch.core import ata, ata_full, ata_levels_for, strassen_matmul
    from repro_torch.core.leaf_ir import compile_program
    from repro_torch.core.strassen import (
        AUTO_MAX_LEVELS, DEFAULT_LEAF, DEFAULT_LEVELS)
    from repro_torch.core.symmetry import (pack_tril_blocks, unpack_tril,
                                           unpack_tril_blocks)
    from repro_torch.gram import stream
    from repro_torch.obs import trace as obs_trace
    from repro_torch.kernels import _build, _launch, ops
    from repro_torch.core.symmetry import tri_count
    from repro_torch.kernels import strassen_fused as sf
    from repro_torch.kernels.ops import DEFAULT_BLOCK
    # the package exports the ops functions under the modules' names
    k_syrk, k_matmul, k_combine, k_transpose, k_flash = (
        importlib.import_module(f"repro_torch.kernels.{name}")
        for name in ("syrk", "matmul", "combine", "transpose",
                     "flash_attention"))
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import (decode_step, forward, init_cache,
                                    init_params, prefill)
    from repro_torch.models.model import param_count
    from repro_torch.runtime import ServingEngine

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
    ATA, SYMM, AAT, RANK_K, MATMUL = (
        f"leaf_program/{k}" for k in ("ata", "symm", "aat", "rank_k",
                                      "matmul"))

    # -- 2. build -------------------------------------------------------------
    print("== 2. build")
    t0 = time.perf_counter()

    def timed_build(name):
        start = time.perf_counter()
        return _build.build(name), time.perf_counter() - start

    with concurrent.futures.ThreadPoolExecutor(len(LIBRARIES)) as pool:
        built = dict(zip(LIBRARIES, pool.map(timed_build, LIBRARIES)))
    reports = {name: report for name, (report, _) in built.items()}
    print(f"{len(LIBRARIES)} libraries, one nvcc each in parallel: "
          f"{sum(r is not None for r in reports.values())} built, the rest "
          f"cached, in {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{name} {secs:.1f} s" for name, (_, secs)
                      in built.items()) + ")")
    for name in sf.PRODUCT_LIBRARIES:
        # each instantiation of the precision axes' libraries on its own line
        lines = _ptxas_summary(reports[name] or "",
                               by_depth=name != "leaf_products")
        print(f"  {name}: {_ptxas_registers(reports[name] or '')}")
        for line in lines:
            print(f"    {line}")
    for name in LIBRARIES:
        if name in ("syrk", "matmul"):
            lines = _ptxas_tiles(reports[name] or "", name)
            assert reports[name] is None or len(lines) == 5, (name, lines)
            for line in lines:
                print(f"  {name} {line}")
        elif name not in (*sf.PRODUCT_LIBRARIES, "flash_attention"):
            print(f"  {name}: {_ptxas_registers(reports[name] or '')}")
    for line in _ptxas_flash(reports["flash_attention"] or ""):
        print(f"  flash_attention {line}")
    # the wgmma kernels: no wgmma serialized by ptxas
    for name in ("syrk", "matmul", "flash_attention"):
        assert (reports[name] or "").count("C7514") == 0, name
    # each core as built: wgmma (HGMMA in the SASS) in every tensor-core
    # kernel of syrk and matmul and in none of the CUDA-core ones
    for name in ("syrk", "matmul"):
        hgmma = _sass_hgmma(_build._target(name))
        by_core = {core: [v for k, v in hgmma.items() if kernel in k]
                   for core, kernel in (("tensor", f"{name}_tc_kernel"),
                                        ("cuda", f"{name}_kernel"))}
        print(f"  {name} SASS: {len(by_core['tensor'])} tensor-core kernels, "
              f"HGMMA {min(by_core['tensor'])}-{max(by_core['tensor'])} "
              f"each; {len(by_core['cuda'])} CUDA-core kernels, HGMMA "
              f"{max(by_core['cuda'])}")
        assert len(by_core["tensor"]) == 12 and min(by_core["tensor"]) > 0
        assert by_core["cuda"] and max(by_core["cuda"]) == 0
    # the core each operand pair runs on: the C side's choice is the one
    # _launch.product_core names
    codes = _launch.DTYPE_CODES
    mm_core = _launch.entry("matmul", "matmul_core", (ctypes.c_int,) * 2)
    syrk_core = _launch.entry("syrk", "syrk_core", (ctypes.c_int,))
    cores = {1: "tensor", 0: "cuda"}
    for dta in codes:
        assert cores[syrk_core(codes[dta])] == _launch.product_core(dta, dta)
        for dtb in codes:
            assert cores[mm_core(codes[dta], codes[dtb])] == \
                _launch.product_core(dta, dtb), (dta, dtb)
    print("  syrk and matmul pick the core _launch.product_core names for "
          "each of the 3 x 3 operand pairs (tensor: bf16/bf16, fp16/fp16)")
    smem = _build.library("flash_attention").flash_attention_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    print("  flash_attention dynamic shared memory by head_dim, fp32 / bf16 / "
          "fp16: " + ", ".join(f"{d}: {smem(d, 0)} / {smem(d, 1)} / "
                               f"{smem(d, 2)} B" for d in k_flash.HEAD_DIMS))

    plain = sf._leaf_products_plain

    def destination_walk(spec, left, right, seed=None):
        """The TPU kernel's own walk (a gram kind), the oracle the op walk
        is held against."""
        return sf._leaf_program_plain(spec, sf._spec_tables(spec, dev), left,
                                      right, f32, seed)

    def mode(spec):
        """How leaf_products.cu walks ``spec``."""
        return "pair mode" if sf._pairs(spec) else "one position a block"

    def reset_counts():
        for counts in (sf.KERNEL_LAUNCHES, sf.LIBRARY_LAUNCHES,
                       _launch.KERNEL_LAUNCHES):
            for key in counts:
                counts[key] = 0

    def read_counts(label):
        torch.cuda.synchronize()
        counts = {**sf.KERNEL_LAUNCHES, **_launch.KERNEL_LAUNCHES}
        by_library = {k: v for k, v in sf.LIBRARY_LAUNCHES.items() if v}
        print(f"launches on {label}: {counts}; by library: {by_library}")
        return counts | sf.LIBRARY_LAUNCHES

    refused = dict.fromkeys(("ata", "symm", "aat", "rank_k", "matmul"), 0)

    def depths_tiles_bit_equal(spec, left, right, out_dtype, k1, label,
                               seed=None):
        """Depths 1-4 at block tiles 64 and 128 (the sub-tiles ragged where
        the tile does not divide the output tile) give the default
        launch's bits; a depth and tile over budget raise."""
        stored = [torch.empty((), dtype=t).element_size() for t in
                  sf._kernel_types(left.dtype, right.dtype, spec.acc_dtype)]
        for depth in range(1, sf.MAX_PIPELINE_DEPTH + 1):
            deep = dataclasses.replace(spec, pipeline_depth=depth)
            for tile in sf.PRODUCT_TILES:
                if sf.smem_bytes(deep, *stored, tile) > sf.SMEM_LIMIT_BYTES:
                    try:
                        sf.leaf_program(deep, left, right, out_dtype,
                                        seed=seed, tile=tile)
                    except ValueError:
                        refused[spec.kind] += 1
                        continue
                    raise AssertionError(f"{label}: depth {depth} tile "
                                         f"{tile} over budget ran")
                kd = sf.leaf_program(deep, left, right, out_dtype, seed=seed,
                                     tile=tile)
                torch.cuda.synchronize()
                assert torch.equal(kd, k1), (label, depth, tile)
                tiles_checked[tile] += 1

    tiles_checked = dict.fromkeys(sf.PRODUCT_TILES, 0)
    checked = {}            # launches held against plain, by kind and mode

    def check(spec, left, right, out_dtype, to_dense, want, label,
              seed=None):
        """One counted launch against its plain version (bit for bit in
        pair mode), the destination walk (a gram kind) and float64, and
        the ring depths and block tiles against it."""
        key = f"leaf_program/{spec.kind}"
        lib_key = f"leaf_products.cu/{spec.kind}"
        before = sf.KERNEL_LAUNCHES[key], sf.LIBRARY_LAUNCHES[lib_key]
        k1 = sf.leaf_program(spec, left, right, out_dtype, seed=seed)
        assert (sf.KERNEL_LAUNCHES[key], sf.LIBRARY_LAUNCHES[lib_key]) == \
            (before[0] + 1, before[1] + 1), (label, lib_key)
        checked_key = f"{spec.kind}, {mode(spec)}"
        checked[checked_key] = checked.get(checked_key, 0) + 1
        depths_tiles_bit_equal(spec, left, right, out_dtype, k1, label, seed)
        ref = plain(spec, left, right, out_dtype, seed)
        equal = torch.equal(k1, ref)
        e_plain = _rel(k1, ref.double())
        e64 = _rel(to_dense(k1), want)
        bar = 1e-5 if out_dtype == f32 else 2.0 ** -8
        line = (f"  {label} {tuple(left.shape)} {left.dtype} x "
                f"{tuple(right.shape)} {right.dtype} -> {out_dtype} L"
                f"{spec.levels} tmax={spec.tmax} n_c={spec.n_c} in "
                f"{mode(spec)}: vs plain {e_plain:.2e} (<= {bar:.0e}, "
                f"bit-equal {equal}), vs float64 {e64:.2e}")
        if spec.kind in ("ata", "aat", "rank_k"):
            e_walk = _rel(k1.float(), destination_walk(
                spec, left, right, seed).double())
            line += f", vs the destination walk {e_walk:.2e}"
            assert e_walk <= max(1e-5, bar), (label, e_walk)
        print(line)
        assert e_plain <= bar, (label, e_plain)
        assert equal or not sf._pairs(spec), (label, "pair mode bits")
        assert e64 <= max(1e-4, bar), (label, e64)
        return k1

    def main_vs_plain(label, spec, left, right, seed=None):
        """A main-path configuration against its plain version, uncounted;
        returns max|kernel - plain|."""
        got = sf.leaf_program(spec, left, right, f32, seed=seed)
        ref = plain(spec, left, right, f32, seed)
        err = float((got - ref).abs().max())
        rel = _rel(got, ref.double())
        print(f"  {label}: {spec.kind} L{spec.levels} {tuple(left.shape)} "
              f"{left.dtype} x {tuple(right.shape)} {right.dtype} in "
              f"{mode(spec)}, depth "
              f"{spec.pipeline_depth} tmax={spec.tmax} n_c={spec.n_c} "
              f"n_k={spec.n_k}: kernel vs plain max|d| {err:.3e}, relative "
              f"{rel:.3e} (<= 1e-5)")
        assert rel <= 1e-5, (label, rel)
        return err

    def tril_dense(n, n_pad, bn):
        """The leading n x n of the lower triangle a packed stack holds."""
        return lambda k: torch.tril(unpack_tril_blocks(
            k, n_pad, bn, symmetrize=False))[:n, :n]

    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def randn(*shape, dtype=f32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    # -- 3. each kind against its plain version ----------------------------------
    print("== 3. leaf_program (ata kind) against its plain version")

    def check_ata(a, levels, variant, gram, block, out_dtype=f32):
        spec, ap = sf._prepare_ata(a, levels, variant, gram, block, block)
        a64 = a.double()
        check(spec, ap, ap, out_dtype,
              tril_dense(a.shape[1], ap.shape[1], block),
              torch.tril(a64.T @ a64), f"{variant:9s} {gram:8s} L{levels}")

    a = randn(1000, 777)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # the fan-in clamp's notice
        for variant in ("strassen", "winograd", "classical"):
            for gram in ("strassen", "dps"):
                for levels in range(4):
                    check_ata(a, levels, variant, gram, 64)
    check_ata(a.to(bf16), 2, "strassen", "strassen", 64)
    check_ata(a.to(bf16), 2, "strassen", "dps", 64)
    check_ata(a, 2, "strassen", "dps", 64, out_dtype=bf16)
    x = randn(1024, 1024)
    for gram in ("strassen", "dps"):
        check_ata(x, 2, "strassen", gram, 128)

    print("== 3b. leaf_program (symm kind) against its plain version")

    def check_symm(x, T, bs, bm, levels, variant, diag_sym):
        s = randn(T * bs, T * bs)
        low = torch.tril(s)
        sym = low + torch.tril(s, -1).T
        # diag_sym reads the stack as block-lower S (diagonal tiles full);
        # otherwise as the symmetric completion of its lower triangle
        stack = pack_tril_blocks(low if diag_sym else sym, bs)
        spec, xp, sp = sf._prepare_symm(x, stack, levels, variant, bm,
                                        diag_sym)
        op = (low + low.T) if diag_sym else sym
        want = F.pad(x.double(), (0, T * bs - x.shape[1])) @ op.double()
        m = x.shape[0]
        check(spec, xp, sp, f32, lambda k: k[:m], want,
              f"{variant:9s} L{levels} diag_sym={int(diag_sym)} T={T} "
              f"bs={bs} bm={bm}")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for variant in ("strassen", "winograd", "classical"):
            for levels in range(4):
                for diag_sym in (False, True):
                    check_symm(a, 16, 64, 64, levels, variant, diag_sym)
    check_symm(a.to(bf16), 8, 128, 64, 2, "strassen", True)
    check_symm(randn(1024, 1024), 8, 128, 128, 2, "strassen", True)

    print("== 3c. leaf_program (aat kind) against its plain version")

    def check_aat(a, levels, variant, gram, block, out_dtype=f32):
        spec, ap = sf._prepare_aat(a, levels, variant, gram, block, block)
        a64 = a.double()
        check(spec, ap, ap, out_dtype,
              tril_dense(a.shape[0], ap.shape[0], block),
              torch.tril(a64 @ a64.T), f"{variant:9s} {gram:8s} L{levels}")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for variant in ("strassen", "winograd", "classical"):
            for gram in ("strassen", "dps"):
                for levels in range(4):
                    check_aat(a, levels, variant, gram, 64)
    check_aat(a.to(bf16), 2, "strassen", "strassen", 64)
    check_aat(a, 2, "strassen", "dps", 64, out_dtype=bf16)
    for gram in ("strassen", "dps"):
        check_aat(x, 2, "strassen", gram, 128)

    print("== 3d. leaf_program (rank_k kind) against its plain version")

    def check_rank_k(x, T, bn, levels, variant, gram, bk, out_dtype=f32,
                     stack_dtype=f32):
        low = torch.tril(randn(T * bn, T * bn)).to(stack_dtype)
        stack = pack_tril_blocks(low, bn)
        spec, xp = sf._prepare_rank_k(stack, x, levels, variant, gram, bk)
        x64 = F.pad(x.double(), (0, T * bn - x.shape[1]))
        want = low.double() + torch.tril(x64.T @ x64)
        k1 = check(spec, xp, xp, out_dtype, tril_dense(T * bn, T * bn, bn),
                   want,
                   f"{variant:9s} {gram:8s} L{levels} T={T} bn={bn} "
                   f"stack {stack_dtype}", seed=stack)
        return spec, xp, stack, k1

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for variant in ("strassen", "winograd", "classical"):
            for gram in ("strassen", "dps"):
                for levels in range(4):
                    check_rank_k(a, 16, 64, levels, variant, gram, 64)
    check_rank_k(a.to(bf16), 16, 64, 2, "strassen", "strassen", 64)
    check_rank_k(a, 16, 64, 2, "strassen", "dps", 64, out_dtype=bf16,
                 stack_dtype=bf16)
    check_rank_k(a, 16, 64, 2, "strassen", "dps", 64, stack_dtype=bf16)
    check_rank_k(a, 16, 64, 2, "strassen", "dps", 64, out_dtype=bf16)
    # the seed's dtype apart from the output's
    check_rank_k(a, 16, 64, 2, "strassen", "strassen", 64, stack_dtype=bf16)
    check_rank_k(a, 16, 64, 2, "strassen", "strassen", 64, out_dtype=bf16)
    check_rank_k(a, 16, 64, 2, "strassen", "strassen", 64, out_dtype=bf16,
                 stack_dtype=bf16)
    # the donated update: the kernel writes over its own seed, for each
    # gram, in fp32 and bf16
    for xr, T, bn, gram, dt in ((x, 8, 128, "strassen", f32),
                                (x, 8, 128, "dps", f32),
                                (a, 16, 64, "dps", f32),
                                (a, 16, 64, "dps", bf16),
                                (a, 16, 64, "strassen", bf16)):
        spec, xp, stack, k1 = check_rank_k(xr, T, bn, 2, "strassen", gram,
                                           bn, out_dtype=dt, stack_dtype=dt)
        inplace = stack.clone()
        sf.leaf_program(spec, xp, xp, dt, seed=inplace, out=inplace)
        torch.cuda.synchronize()
        assert torch.equal(inplace, k1), (gram, dt)
        print(f"  the update written over its own seed in {mode(spec)} "
              f"({gram} gram, {dt}) equals the fresh one")

    print("== 3e. leaf_program (matmul kind) against its plain version")

    def check_matmul(m, k, n, levels, variant, trans_a, trans_b, block,
                     dtype=f32, out_dtype=f32):
        x, y = randn(m, k, dtype=dtype), randn(k, n, dtype=dtype)
        xs = x.T.contiguous() if trans_a else x
        ys = y.T.contiguous() if trans_b else y
        spec, ap, bp = sf._prepare_matmul(xs, ys, levels, variant, block,
                                          block, block, trans_a, trans_b)
        check(spec, ap, bp, out_dtype, lambda c: c[:m, :n],
              x.double() @ y.double(),
              f"{variant:9s} L{levels} trans_a={int(trans_a)} "
              f"trans_b={int(trans_b)}")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for variant in ("strassen", "winograd", "classical", "bb322",
                        "bb422"):
            for trans_a in (False, True):
                for trans_b in (False, True):
                    for levels in range(4):
                        check_matmul(1000, 777, 555, levels, variant,
                                     trans_a, trans_b, 64)
    check_matmul(1000, 777, 555, 2, "strassen", True, False, 64, dtype=bf16)
    check_matmul(1000, 777, 555, 2, "bb322", False, True, 64,
                 out_dtype=bf16)
    check_matmul(1024, 1024, 1024, 2, "strassen", False, False, 128)
    del a, x
    print(f"depths and tiles over {sf.SMEM_LIMIT_BYTES} B of shared memory "
          f"refused with ValueError, per kind: {refused}")
    assert all(refused.values()), refused
    print(f"ring depths and block tiles bit-equal to the default launch, "
          f"launches per tile: {tiles_checked}")
    assert all(tiles_checked.values()), tiles_checked
    print(f"launches held against their plain version, by kind and mode: "
          f"{checked}")
    assert all(checked.get(f"{k}, one position a block") for k in
               ("ata", "symm", "aat", "rank_k", "matmul")), checked
    assert all(checked.get(f"{k}, pair mode") for k in
               ("ata", "aat", "rank_k")), checked

    # -- 3f-3i. the single-purpose kernels ------------------------------------
    def counted_launch(name, fn):
        before = _launch.KERNEL_LAUNCHES[name]
        out = fn()
        torch.cuda.synchronize()
        assert _launch.KERNEL_LAUNCHES[name] == before + 1, name
        return out

    def product_errors(errs, got, plain_out, want64):
        """Add (vs plain, vs float64) of a product, each of max|out|, to
        ``errs`` under its output dtype; held to 1e-5 and 1e-4 (2^-8 for a
        bf16 output, 2^-10 for an fp16 one: one rounding of the largest
        element, tighter than bf16's bar)."""
        bar = PRODUCT_BARS[str(got.dtype).removeprefix("torch.")]
        e_plain, e64 = _rel(got, plain_out.double()), _rel(got, want64)
        assert e_plain <= bar and e64 <= max(1e-4, bar), (e_plain, e64)
        errs.setdefault(got.dtype, []).append((e_plain, e64))

    def error_summary(errs):
        return "; ".join(
            f"{str(dt).removeprefix('torch.')} out: vs plain "
            f"{max(e for e, _ in v):.2e}, vs float64 "
            f"{max(e for _, e in v):.2e}"
            for dt, v in errs.items())

    def both_tiles(name, fn):
        """One counted launch at each block tile of the core, the two
        bit-equal; returns the result."""
        got = {t: counted_launch(name, lambda: fn(tile=t))
               for t in _launch.PRODUCT_TILES}
        assert torch.equal(got[64], got[128]), (name, "tiles 64 and 128")
        return got[64]

    def sweep_blocks(shape):
        return BLOCKS + WIDE_BLOCKS if shape[0] == 1000 else BLOCKS

    # launches of the tensor-core instantiations in phases 3f, 3g and 3l, by
    # kernel and operand type (each case at both tiles)
    tc_launches = {}

    def cores_of(pairs):
        return " and ".join(sorted({_launch.product_core(*p_) for p_ in pairs}))

    def syrk_sweep(pairs, label):
        """Every shape and block of 3f at each (input, output) dtype pair of
        ``pairs``, at both tiles (16-bit A on the tensor cores, with K and
        the tile edges ragged to their 64-deep chunk and 128-wide tile)."""
        for m, k in SHAPES_SYRK:
            errs = {}
            for blk in sweep_blocks((m, k)):
                for dt, out_dt in pairs:
                    xp = ops._pad_to(randn(m, k, dtype=dt), (blk, blk))
                    got = both_tiles("syrk", lambda tile: k_syrk.syrk_packed(
                        xp, bk=blk, bn=blk, out_dtype=out_dt, tile=tile))
                    if _launch.product_core(dt, dt) == "tensor":
                        tc_launches[("syrk", dt)] = tc_launches.get(
                            ("syrk", dt), 0) + len(_launch.PRODUCT_TILES)
                    x64 = xp.double()
                    product_errors(errs, got,
                                   k_syrk._syrk_packed_plain(xp, blk, f32),
                                   pack_tril_blocks(x64.T @ x64, blk))
            print(f"  {m} x {k}, blocks {sweep_blocks((m, k))}, {label} ("
                  f"{cores_of((dt, dt) for dt, _ in pairs)} cores): "
                  f"{error_summary(errs)}")

    def matmul_sweep(cases, label):
        """Every shape and block of 3g at each (a, b, output) dtype case of
        ``cases`` (output None: the promoted type), at both tiles (a and b
        of one 16-bit type on the tensor cores)."""
        for m, k, n_ in SHAPES_MM:
            errs = {}
            for blk in sweep_blocks((m, k, n_)):
                for dta, dtb, out_dt in cases:
                    xp = ops._pad_to(randn(m, k, dtype=dta), (blk, blk))
                    yp = ops._pad_to(randn(k, n_, dtype=dtb), (blk, blk))
                    got = both_tiles("matmul", lambda tile: k_matmul
                                     .matmul_padded(xp, yp, bm=blk, bk=blk,
                                                    bn=blk, out_dtype=out_dt,
                                                    tile=tile))
                    if _launch.product_core(dta, dtb) == "tensor":
                        tc_launches[("matmul", dta)] = tc_launches.get(
                            ("matmul", dta), 0) + len(_launch.PRODUCT_TILES)
                    assert got.dtype == (out_dt
                                         or torch.promote_types(dta, dtb))
                    product_errors(errs, got,
                                   k_matmul._matmul_padded_plain(xp, yp, f32),
                                   xp.double() @ yp.double())
            print(f"  {m} x {k} x {n_}, blocks {sweep_blocks((m, k, n_))}, "
                  f"{label} ({cores_of((a_, b_) for a_, b_, _ in cases)} "
                  f"cores): {error_summary(errs)}")

    print("== 3f. syrk against its plain version, at tiles 64 and 128 "
          "(bit-equal); bf16 A on the tensor cores")
    syrk_sweep(((f32, f32), (bf16, bf16), (bf16, f32), (f32, bf16)),
               "fp32 and bf16 in")

    print("== 3g. matmul against its plain version, at tiles 64 and 128 "
          "(bit-equal); bf16 with bf16 on the tensor cores")
    matmul_sweep(((f32, f32, None), (bf16, bf16, None), (bf16, f32, None),
                  (bf16, bf16, f32), (f32, f32, bf16)),
                 "fp32, bf16 and mixed in")
    # what the wrappers pick at the wide blocks (1000x777, padded)
    for name, shape in (("syrk", k_syrk.syrk_launch_shape(
            816, bn=136, a_dtype=f32, out_dtype=f32)),
            ("matmul", k_matmul.matmul_launch_shape(
                1000, 600, bm=200, bn=200, a_dtype=f32, b_dtype=f32,
                out_dtype=f32))):
        print(f"  {name} default launch at the wide blocks: {shape}")

    def combine_sweep(dtypes, label):
        for m, k in SHAPES_2D:
            for blk in BLOCKS:
                for dt in dtypes:
                    mp = [ops._pad_to(randn(m, k, dtype=dt), (blk, blk))
                          for _ in range(7)]
                    got = counted_launch("combine", lambda: k_combine
                                         .strassen_combine(*mp, bm=blk,
                                                           bn=blk))
                    want = k_combine._strassen_combine_plain(*mp)
                    assert all(torch.equal(g, w)
                               for g, w in zip(got, want)), (m, k, blk, dt)
            print(f"  {m} x {k}, blocks {BLOCKS}, {label}: bit-equal")

    print("== 3h. combine against its plain version (torch.equal)")
    combine_sweep((f32, bf16), "fp32 and bf16")

    print("== 3i. transpose against its plain version (torch.equal)")
    for m, k in SHAPES_2D:
        for blk in BLOCKS:
            for dt in (f32, bf16, torch.int32):
                x = randn(m, k) if dt != torch.int32 else torch.randint(
                    -2 ** 31, 2 ** 31 - 1, (m, k), generator=gen, device=dev,
                    dtype=dt)
                xp = ops._pad_to(x.to(dt), (blk, blk))
                got = counted_launch("transpose", lambda: k_transpose
                                     .transpose_padded(xp, bm=blk, bn=blk))
                assert torch.equal(got, k_transpose._transpose_padded_plain(
                    xp)), (m, k, blk, dt)
        print(f"  {m} x {k}, blocks {BLOCKS}, fp32, bf16 and int32: "
              f"bit-equal")
    # what the wrappers refuse on the card, before any launch
    x = randn(64, 64)
    refusals = (
        (ValueError, lambda: k_matmul.matmul_padded(x.T, x, bm=32, bk=32,
                                                    bn=32)),
        (ValueError, lambda: k_syrk.syrk_packed(
            torch.empty(64 * 64 + 1, device=dev)[1:].view(64, 64), bk=32,
            bn=32)),
        (ValueError, lambda: k_transpose.transpose_padded(x[:, :32], bm=32,
                                                          bn=32)),
        (TypeError, lambda: k_combine.strassen_combine(*[x.double()] * 7,
                                                       bm=32, bn=32)),
        (RuntimeError, lambda: ops.matmul(x.clone().requires_grad_(), x)))
    before = dict(_launch.KERNEL_LAUNCHES)
    for error, call in refusals:
        try:
            call()
        except error:
            continue
        raise AssertionError(f"not refused with {error.__name__}")
    assert _launch.KERNEL_LAUNCHES == before
    print("  a transposed view, a misaligned view, a strided view, fp64 and "
          "an operand that requires grad are refused, nothing launched")

    print("== 3j. flash_attention against its plain version")

    # per dtype: the largest sound errors, and the least a fault reads
    flash_read = {n_: {"sound": [0.0, 0.0], "fault": [np.inf, np.inf]}
                  for n_ in FLASH_BARS}

    def flash_check(b, h, hkv, sq, skv, d, dt, **kw):
        """One counted launch on (B, H, S, D) operands against the plain
        version, of max|out| and row by row, within ``FLASH_BARS``; where
        Sq exceeds the kernel's q tile (128 rows in bf16, 64 in fp32), the
        output with its rows past the first q tile zeroed must exceed both
        bars.  Returns max|kernel - plain|."""
        q, k, v = (randn(b, heads, s_, d, dtype=dt) for heads, s_ in
                   ((h, sq), (hkv, skv), (hkv, skv)))
        got = counted_launch("flash_attention",
                             lambda: k_flash.flash_attention(q, k, v, **kw))
        opts = {"causal": True, "window": 0, "softcap": 0.0, **kw}
        want = k_flash._flash_attention_plain(q, k, v, scale=d ** -0.5,
                                              **opts)
        assert got.dtype == dt and bool(torch.isfinite(got).all())
        name = str(dt).removeprefix("torch.")
        bars, read = FLASH_BARS[name], flash_read[name]
        errs = (_rel(got, want.double()), _row_rel(got, want))
        read["sound"] = [max(a_, e_) for a_, e_ in zip(read["sound"], errs)]
        line = (f"  B {b} H {h} Hkv {hkv} Sq {sq} Skv {skv} D {d} {name} "
                f"{kw or ''}: vs plain {errs[0]:.2e}, by row {errs[1]:.2e}")
        if sq > k_flash.q_tile(dt):
            bad = got.clone()
            bad[:, :, k_flash.q_tile(dt):] = 0
            faults = (_rel(bad, want.double()), _row_rel(bad, want))
            read["fault"] = [min(a_, e_)
                             for a_, e_ in zip(read["fault"], faults)]
            line += (f"; rows past tile 0 zeroed: {faults[0]:.2e}, by row "
                     f"{faults[1]:.2e}")
            assert all(f_ > b_ for f_, b_ in zip(faults, bars)), faults
        print(line)
        assert all(e_ <= b_ for e_, b_ in zip(errs, bars)), (
            b, h, hkv, sq, skv, d, dt, kw, errs)
        return float((got.float() - want.float()).abs().max())

    def flash_sweep(dt):
        """3j's sweep in ``dt``; returns the largest max|kernel - plain| at
        Qwen2.5-3B's shapes."""
        worst = 0.0
        for b_, sq, skv, h_, hkv, d in FLASH_GRID:
            flash_check(b_, h_, hkv, sq, skv, d, dt)
        for kw in ({"window": 16}, {"window": 48}):
            flash_check(1, 4, 2, 128, 128, 32, dt, **kw)
        flash_check(1, 2, 2, 64, 64, 32, dt, softcap=50.0)
        flash_check(2, 4, 2, 64, 64, 32, dt, causal=False)
        flash_check(1, 2, 2, 64, 96, 32, dt, causal=False)
        for sq in (128, 1000, MAX_SEQ):
            worst = max(worst, flash_check(1, QWEN_HEADS, QWEN_KV_HEADS, sq,
                                           MAX_SEQ, QWEN_HEAD_DIM, dt))
        flash_check(1, 4, 2, 512, 512, 256, dt, window=100, softcap=50.0)
        flash_check(1, 4, 2, 256, 320, 256, dt, causal=False, softcap=30.0)
        # head_dim 80 (zamba2-2.7b's): the tensor-core kernel runs it as 128
        # with zero columns
        flash_check(2, 4, 4, 64, 64, 80, dt)
        flash_check(1, 8, 2, 300, 300, 80, dt)
        flash_check(1, 4, 2, 200, 260, 80, dt, window=50, softcap=30.0)
        flash_check(1, 4, 2, 160, 200, 80, dt, causal=False)
        dt_name = str(dt).removeprefix("torch.")
        read = flash_read[dt_name]
        print(f"  {dt_name}: largest sound error of max|out| "
              f"{read['sound'][0]:.3e}, by row {read['sound'][1]:.3e} (<= "
              f"{FLASH_BARS[dt_name][0]:.1e}, {FLASH_BARS[dt_name][1]:.3e}); "
              f"least with rows past tile 0 zeroed {read['fault'][0]:.3e}, "
              f"by row {read['fault'][1]:.3e}")
        return worst

    flash_sweep(f32)
    flash_err = flash_sweep(bf16)
    # the ops entry point on (B, S, H, D) against itself on the CPU (the
    # plain version), over the grid and a causal Sq > Skv, where kv is
    # zero-padded to the block as in the JAX package
    for b_, sq, skv, h_, hkv, d in FLASH_GRID + [(1, 80, 40, 2, 1, 16)]:
        q, k, v = (randn(b_, s_, heads, d) for s_, heads in
                   ((sq, h_), (skv, hkv), (skv, hkv)))
        got = counted_launch("flash_attention", lambda: ops.flash_mha(
            q, k, v, block_q=32, block_kv=32))
        want = ops.flash_mha(*(x.cpu() for x in (q, k, v)), block_q=32,
                             block_kv=32, device="cpu")
        assert _rel(got.cpu(), want.double()) <= 1e-5, (b_, sq, skv, h_,
                                                        hkv, d)
    print("  ops.flash_mha over the grid and Sq 80 over Skv 40 at blocks of "
          "32: vs itself on the CPU <= 1e-5")
    q = randn(1, 2, 64, 48)
    x = randn(1, 2, 64, 64)
    refusals = (
        (ValueError, lambda: k_flash.flash_attention(q, q, q)),
        (ValueError, lambda: k_flash.flash_attention(
            x.transpose(2, 3), x, x)),
        (RuntimeError, lambda: k_flash.flash_attention(
            x.clone().requires_grad_(), x, x)))
    before = dict(_launch.KERNEL_LAUNCHES)
    for error, call in refusals:
        try:
            call()
        except error:
            continue
        raise AssertionError(f"not refused with {error.__name__}")
    assert _launch.KERNEL_LAUNCHES == before
    print("  head_dim 48, a transposed view and an operand that requires "
          "grad are refused, nothing launched")

    # -- 3k. the precision axes ----------------------------------------------
    print("== 3k. leaf_program's precision axes (fp16, fp8 and fp64 operand "
          "tiles, bf16 and fp64 accumulators) against its plain version")
    precision_checked = {}      # launches by library, kind and mode
    bars = {"float32": 1e-5, "bfloat16": 2.0 ** -7, "float64": 1e-5}
    out_bars = {bf16: 2.0 ** -8, torch.float16: 2.0 ** -10}

    def library_of(spec, left, right):
        return sf._products_library(spec.acc_dtype, sf._kernel_types(
            left.dtype, right.dtype, spec.acc_dtype)[0])

    def check_precision(spec, left, right, to_dense, want, label,
                        out_dtype=f32, seed=None):
        """One counted launch of a precision branch against its plain
        version, the destination walk (a gram kind) and the float64
        product of its quantized operands, and every requested ring depth
        and both block tiles against it."""
        lib = library_of(spec, left, right)
        key = f"{lib}.cu/{spec.kind}"
        before = sf.LIBRARY_LAUNCHES[key]
        k1 = sf.leaf_program(spec, left, right, out_dtype, seed=seed)
        assert sf.LIBRARY_LAUNCHES[key] == before + 1, (label, key)
        ck = f"{lib}: {spec.kind}, {mode(spec)}"
        precision_checked[ck] = precision_checked.get(ck, 0) + 1
        depths_tiles_bit_equal(spec, left, right, out_dtype, k1, label, seed)
        ref = plain(spec, left, right, out_dtype, seed)
        bar = max(bars[spec.acc_dtype], out_bars.get(out_dtype, 0.0))
        e_plain = _rel(k1, ref.double())
        e64 = _rel(to_dense(k1), want)
        line = (f"  {label} {spec.kind} L{spec.levels} {tuple(left.shape)} "
                f"{left.dtype} x {tuple(right.shape)} {right.dtype}, "
                f"{spec.acc_dtype} accumulator -> {out_dtype}, in "
                f"{mode(spec)} on {lib}, ring depth {sf.ring_depth(spec)}: "
                f"vs plain {e_plain:.2e} (<= {bar:.1e}, bit-equal "
                f"{torch.equal(k1, ref)}), vs float64 {e64:.2e}")
        oracle = ref            # whose error a bf16 accumulator is held to
        if spec.kind in ("ata", "aat", "rank_k"):
            oracle = sf._leaf_program_plain(spec, sf._spec_tables(spec, dev),
                                            left, right, torch.float64, seed)
            e_walk = _rel(k1, oracle)
            line += f", vs the destination walk {e_walk:.2e}"
            assert e_walk <= bar, (label, e_walk)
        if spec.acc_dtype == "bfloat16":
            e_ref = _rel(to_dense(oracle), want)
            line += f" (the {'walk' if oracle is not ref else 'plain'}'s " \
                    f"{e_ref:.2e})"
            assert e64 <= 1.5 * e_ref, (label, e64, e_ref)
        else:
            assert e64 <= max(1e-4, bar), (label, e64)
        print(line)
        assert e_plain <= bar, (label, e_plain)
        # the fp64 accumulator's parts add in one order in both: any fp32
        # step would show as a change of bits, not of error
        assert spec.acc_dtype != "float64" or torch.equal(k1, ref), label
        return k1

    def q64(x, od):
        """The float64 values of ``x`` as the kernel stores them."""
        return sf._stored(x, od).double()

    a = randn(1000, 777)
    x = randn(1024, 1024)
    T, bs = 16, 64
    low = torch.tril(randn(T * bs, T * bs))
    stack = pack_tril_blocks(low, bs)
    b = randn(1000, 555)
    fp16, e4m3, e5m2, fp64 = (torch.float16, torch.float8_e4m3fn,
                              torch.float8_e5m2, torch.float64)
    precision = ((fp16, "float32"), (e4m3, "float32"), (e5m2, "float32"),
                 (fp64, "float32"), (None, "bfloat16"), (None, "float64"),
                 (e4m3, "bfloat16"), (fp16, "float64"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for od, acc in precision:
            tag = f"{str(od).removeprefix('torch.')} tiles"
            aq = q64(a, od)
            for gram in ("strassen", "dps"):
                spec, ap = sf._prepare_ata(a, 2, "strassen", gram, 64, 64,
                                           operand_dtype=od, acc_dtype=acc)
                check_precision(spec, ap, ap, tril_dense(777, ap.shape[1], 64),
                                torch.tril(aq.T @ aq), f"{tag}, {gram}")
                spec, ap = sf._prepare_aat(a, 2, "strassen", gram, 64, 64,
                                           operand_dtype=od, acc_dtype=acc)
                check_precision(spec, ap, ap,
                                tril_dense(1000, ap.shape[0], 64),
                                torch.tril(aq @ aq.T), f"{tag}, {gram}")
                spec, ap = sf._prepare_rank_k(stack, a, 2, "strassen", gram,
                                              64, operand_dtype=od,
                                              acc_dtype=acc)
                a_pad = F.pad(aq, (0, T * bs - 777))
                check_precision(spec, ap, ap, tril_dense(T * bs, T * bs, bs),
                                low.double() + torch.tril(a_pad.T @ a_pad),
                                f"{tag}, {gram}", seed=stack)
            spec, xp, sp = sf._prepare_symm(a, stack, 2, "strassen", 64, True,
                                            operand_dtype=od, acc_dtype=acc)
            lq = q64(low, od)
            check_precision(spec, xp, sp, lambda k: k[:1000],
                            F.pad(aq, (0, T * bs - 777)) @ (lq + lq.T), tag)
            spec, ap, bp = sf._prepare_matmul(a, b, 2, "strassen", 64, 64, 64,
                                              True, False, operand_dtype=od,
                                              acc_dtype=acc)
            check_precision(spec, ap, bp, lambda c: c[:777, :555],
                            aq.T @ q64(b, od), f"{tag}, a^t b")
        # tiles of 128 (the main path's), both grams
        for od, acc in ((e4m3, "float32"), (None, "bfloat16"),
                        (None, "float64")):
            xq = q64(x, od)
            for gram in ("strassen", "dps"):
                spec, xp = sf._prepare_ata(x, 2, "strassen", gram, 128, 128,
                                           operand_dtype=od, acc_dtype=acc)
                check_precision(spec, xp, xp, tril_dense(1024, 1024, 128),
                                torch.tril(xq.T @ xq),
                                f"{str(od).removeprefix('torch.')} tiles, "
                                f"{gram}, tile 128")
        # fp8 at block edges of 40: row strides 8 mod 16 bytes, widened
        a760 = randn(500, 760)
        low5 = torch.tril(randn(200, 200))
        stack5 = pack_tril_blocks(low5, 40)
        for od in (e4m3, e5m2):
            tag = f"{str(od).removeprefix('torch.')} tiles, block 40"
            aq = q64(a760, od)
            for levels in (0, 2):
                spec, ap = sf._prepare_ata(a760, levels, "strassen",
                                           "strassen", 40, 40,
                                           operand_dtype=od)
                check_precision(spec, ap, ap,
                                tril_dense(760, ap.shape[1], 40),
                                torch.tril(aq.T @ aq), tag)
            xs = a760[:, :200]
            xq = q64(xs, od)
            lq = q64(low5, od)
            spec, xp, sp = sf._prepare_symm(xs, stack5, 0, "strassen", 40,
                                            True, operand_dtype=od)
            check_precision(spec, xp, sp, lambda k: k[:500],
                            xq @ (lq + lq.T), tag)
            spec, xp = sf._prepare_rank_k(stack5, xs, 0, "strassen", "dps",
                                          40, operand_dtype=od)
            check_precision(spec, xp, xp, tril_dense(200, 200, 40),
                            low5.double() + torch.tril(xq.T @ xq), tag,
                            seed=stack5)
            spec, ap, bp = sf._prepare_matmul(a760[:, :440], a760[:440, :280],
                                              0, "strassen", 40, 40, 40,
                                              operand_dtype=od)
            check_precision(spec, ap, bp, lambda c: c[:500, :280],
                            q64(a760[:, :440], od) @ q64(a760[:440, :280], od),
                            tag)
        # fp64 and fp16 inputs, seeds and outputs
        a64_, a16 = a.double(), a.half()
        spec, ap = sf._prepare_ata(a64_, 2, "strassen", "dps", 64, 64)
        aq = q64(a64_, None)
        check_precision(spec, ap, ap, tril_dense(777, ap.shape[1], 64),
                        torch.tril(aq.T @ aq), "fp64 input", out_dtype=fp64)
        spec, ap = sf._prepare_ata(a16, 2, "strassen", "strassen", 64, 64)
        aq = a16.double()
        check_precision(spec, ap, ap, tril_dense(777, ap.shape[1], 64),
                        torch.tril(aq.T @ aq), "fp16 input")
        spec, ap = sf._prepare_ata(a, 2, "strassen", "strassen", 64, 64)
        check_precision(spec, ap, ap, tril_dense(777, ap.shape[1], 64),
                        torch.tril(a.double().T @ a.double()),
                        "fp16 output", out_dtype=fp16)
        for sd, acc in ((fp64, "float32"), (fp64, "float64"),
                        (fp16, "float32"), (fp16, "bfloat16")):
            st = stack.to(sd)
            spec, ap = sf._prepare_rank_k(st, a, 2, "strassen", "dps", 64,
                                          acc_dtype=acc)
            a_pad = F.pad(a.double(), (0, T * bs - 777))
            k1 = check_precision(
                spec, ap, ap, tril_dense(T * bs, T * bs, bs),
                low.to(sd).double() + torch.tril(a_pad.T @ a_pad),
                f"{str(sd).removeprefix('torch.')} stack", out_dtype=sd,
                seed=st)
            inplace = st.clone()
            sf.leaf_program(spec, ap, ap, sd, seed=inplace, out=inplace)
            torch.cuda.synchronize()
            assert torch.equal(inplace, k1), (sd, acc)
        # K blocks whose parts are 1 and 2^-30 in turn: an fp64 accumulator
        # keeps every 2^-30, an fp32 one loses them all
        parts = torch.zeros(4 * 64, 128, device=dev)
        parts[0::128], parts[64::128] = 1.0, 2.0 ** -15
        stack0 = torch.zeros(3 * 64, 64, dtype=fp64, device=dev)
        kept = {}
        for gram in ("strassen", "dps"):
            for acc, value in (("float64", 2 + 2.0 ** -29), ("float32", 2.0)):
                for kind in ("ata", "aat", "rank_k"):
                    seed = stack0 if kind == "rank_k" else None
                    if kind == "ata":
                        spec, pp = sf._prepare_ata(parts, 1, "strassen", gram,
                                                   64, 64, acc_dtype=acc)
                    elif kind == "aat":
                        spec, pp = sf._prepare_aat(parts.T.contiguous(), 1,
                                                   "strassen", gram, 64, 64,
                                                   acc_dtype=acc)
                    else:
                        spec, pp = sf._prepare_rank_k(stack0, parts, 1,
                                                      "strassen", gram, 64,
                                                      acc_dtype=acc)
                    got = sf.leaf_program(spec, pp, pp, fp64, seed=seed)
                    ref = plain(spec, pp, pp, fp64, seed)
                    assert torch.equal(got, ref), (gram, acc, kind)
                    assert bool((got == value).all()), (gram, acc, kind)
                    kept[f"{kind}, {gram}, {acc}"] = f"{float(got[0, 0])!r}"
        print(f"  K block parts of 1 and 2^-30 in turn, fp64 output, bit-equal "
              f"to plain: {kept}")
    del a, x, b, stack, low
    print(f"precision branches held against their plain version, by library, "
          f"kind and mode: {precision_checked}")
    for lib in ("leaf_products_lowp", "leaf_products_acc"):
        assert all(precision_checked.get(f"{lib}: {k}, one position a block")
                   for k in ("ata", "symm", "aat", "rank_k", "matmul")), lib
        assert all(precision_checked.get(f"{lib}: {k}, pair mode")
                   for k in ("ata", "aat", "rank_k")), lib

    # -- 3l. fp16 operands in the single-purpose kernels ---------------------
    print("== 3l. fp16 operands in syrk, matmul, combine and flash_attention "
          "against their plain versions")
    fp16 = torch.float16
    before = dict(_launch.KERNEL_LAUNCHES)
    print("  syrk, at tiles 64 and 128 (bit-equal):")
    syrk_sweep(((fp16, fp16), (fp16, f32), (f32, fp16), (bf16, fp16),
                (fp16, bf16)), "fp16 in or out")
    print("  matmul, at tiles 64 and 128 (bit-equal):")
    matmul_sweep(((fp16, fp16, None), (fp16, bf16, None), (bf16, fp16, None),
                  (fp16, f32, None), (f32, fp16, None), (fp16, fp16, f32),
                  (f32, f32, fp16), (fp16, fp16, bf16), (bf16, bf16, fp16)),
                 "fp16, and fp16 mixed with fp32 and bf16")
    print("  combine (torch.equal):")
    combine_sweep((fp16,), "fp16")
    print("  flash_attention, on the tensor cores:")
    flash_err16 = flash_sweep(fp16)
    f16_launches = {k: v - before[k]
                    for k, v in _launch.KERNEL_LAUNCHES.items()}
    print(f"  fp16 branches held against their plain versions: "
          f"{f16_launches}; tensor-core launches in 3f, 3g and 3l: "
          + ", ".join(f"{k_} {str(d_).removeprefix('torch.')} {v_}"
                      for (k_, d_), v_ in sorted(tc_launches.items(),
                                                 key=str)))
    assert all(tc_launches.get((k_, d_)) for k_ in ("syrk", "matmul")
               for d_ in (bf16, fp16))
    assert all(f16_launches[k] for k in ("syrk", "matmul", "combine",
                                         "flash_attention"))

    # -- 4. main paths ----------------------------------------------------------
    n = args.n
    depth = sf._resolve_pipeline_depth(None, dev)
    auto = min(ata_levels_for(n, n, DEFAULT_LEAF), AUTO_MAX_LEVELS)
    print(f"== 4. main path: ata / ata_full at {n} x {n}, and ata with the "
          f"dps gram")
    a = randn(n, n)
    ab = a.to(bf16)
    reset_counts()
    c = ata(a)
    full = ata_full(a, levels="auto")
    cb = ata(ab)
    before = sf.LIBRARY_LAUNCHES["leaf_products.cu/ata"]
    cd = ata(a, gram="dps")
    dps_launches = sf.LIBRARY_LAUNCHES["leaf_products.cu/ata"] - before
    launches = read_counts("the main path")
    assert launches[ATA] >= 4, launches
    # both grams on leaf_products.cu: ata(a, gram="dps") launched it once
    assert launches["leaf_products.cu/ata"] == launches[ATA], launches
    assert dps_launches == 1, dps_launches
    assert set(sf.LIBRARY_LAUNCHES) == {
        f"{lib}.cu/{k}" for lib in sf.PRODUCT_LIBRARIES for k in
        ("ata", "symm", "aat", "rank_k", "matmul")}, sf.LIBRARY_LAUNCHES
    print(f"ata(a, gram='dps') launched leaf_products.cu/ata "
          f"{dps_launches} time")
    for out in (c, full, cb, cd):
        assert out.shape == (n, n) and out.dtype == f32
        assert bool(torch.isfinite(out).all())
    a64 = a.double()
    want = a64.T @ a64
    e_c = _rel(c, torch.tril(want))
    e_full = _rel(full, want)
    e_d = _rel(cd, torch.tril(want))
    del want
    ab64 = ab.double()
    e_b = _rel(cb, torch.tril(ab64.T @ ab64))
    del ab64, a64, full, cb, c, cd
    print(f"ata(a) L2 vs float64: {e_c:.3e}; ata_full(a, levels='auto') vs "
          f"float64: {e_full:.3e}; ata(bf16 a) vs float64: {e_b:.3e}; "
          f"ata(a, gram='dps') vs float64: {e_d:.3e} (each <= 1e-4 of "
          f"max|C|)")
    assert max(e_c, e_full, e_b, e_d) <= 1e-4

    # The main path's kernel configurations, each held against the plain
    # version on the same padded operand.  These launches come after the
    # counts were read, so they are not counted.
    max_abs_err = 0.0
    for label, x, levels in (("ata(a)", a, DEFAULT_LEVELS),
                             ("ata_full(a, levels='auto')", a, auto),
                             ("ata(bf16 a)", ab, DEFAULT_LEVELS)):
        spec, ap = sf._prepare_ata(x, levels, "strassen", "strassen",
                                   DEFAULT_BLOCK, DEFAULT_BLOCK,
                                   pipeline_depth=depth)
        max_abs_err = max(max_abs_err, main_vs_plain(label, spec, ap, ap))
        del ap
    spec, ap = sf._prepare_ata(a, DEFAULT_LEVELS, "strassen", "dps",
                               DEFAULT_BLOCK, DEFAULT_BLOCK,
                               pipeline_depth=depth)
    dps_err = main_vs_plain("ata(a, gram='dps')", spec, ap, ap)
    got = sf.leaf_program(spec, ap, ap, f32)
    same = torch.equal(got, plain(spec, ap, ap, f32))
    e_walk = _rel(got, destination_walk(spec, ap, ap).double())
    print(f"  ata(a, gram='dps') in {mode(spec)}: bit-equal to the plain "
          f"version {same}; vs the destination walk {e_walk:.3e} (<= 1e-5)")
    assert same and e_walk <= 1e-5, (same, e_walk)
    del ap, got

    # -- 4b. the main path's backward --------------------------------------------
    print(f"== 4b. main path backward: dA of ata / ata_full / ata(bf16) / "
          f"ata_fused_packed at {n} x {n}")
    w = randn(n, n)
    n_pad = sf._ata_geometry(n, n, DEFAULT_LEVELS, "strassen", DEFAULT_BLOCK,
                             DEFAULT_BLOCK)["N"]
    wp = pack_tril_blocks(F.pad(torch.tril(w), (0, n_pad - n, 0, n_pad - n)),
                          DEFAULT_BLOCK)

    def grad_of(x, loss):
        x = x.clone().requires_grad_()
        (g,) = torch.autograd.grad(loss(x), x)
        return g

    reset_counts()
    da = grad_of(a, lambda x: (w * ata(x)).sum())
    da_full = grad_of(a, lambda x: (w * ata_full(x, levels="auto")).sum())
    da_b = grad_of(ab, lambda x: (w * ata(x)).sum())
    da_p = grad_of(a, lambda x: (wp * ops.ata_fused_packed(x)).sum())
    bwd_launches = read_counts("the main path's backward (forwards included)")
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
        if label == "ata(bf16 a)":
            # the fp32 product behind the bf16 dA, against float64
            got = sf.leaf_program(spec, xp, sp, f32)
            lw = torch.tril(w).double()
            want = F.pad(x.double(), (0, n_pad - n)) @ F.pad(
                lw + lw.T, (0, n_pad - n, 0, n_pad - n))
            e64 = _rel(got[:n], want)
            del want, lw, got
            print(f"  {label}: fp32 product behind dA vs float64 {e64:.3e} "
                  f"(<= 1e-4)")
            assert e64 <= 1e-4
        symm_err = max(symm_err, main_vs_plain(label, spec, xp, sp))
        symm_cfgs.append((spec.levels, str(xp.dtype), depth))
        del xp, sp

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

    # -- 4c. the row gram ----------------------------------------------------------
    wide = 777
    print(f"== 4c. main path: ata(a, gram_of='rows') at {n} x {n}, "
          f"{n} x {wide} and bf16")
    aw = randn(n, wide)
    reset_counts()
    r = ata(a, gram_of="rows")
    rw = ata(aw, gram_of="rows")
    rb = ata(ab, gram_of="rows")
    aat_launches = read_counts("the row-gram path")
    assert aat_launches[AAT] >= 3, aat_launches
    assert aat_launches["leaf_products.cu/aat"] == aat_launches[AAT], \
        aat_launches
    errs = []
    for out, x in ((r, a), (rw, aw), (rb, ab)):
        assert out.shape == (n, n) and out.dtype == f32
        assert bool(torch.isfinite(out).all())
        x64 = x.double()
        errs.append(_rel(out, torch.tril(x64 @ x64.T)))
        del x64
    del r, rw, rb
    print(f"row gram vs float64: {n} x {n} {errs[0]:.3e}, {n} x {wide} "
          f"{errs[1]:.3e}, bf16 {errs[2]:.3e} (each <= 1e-4 of max|C|)")
    assert max(errs) <= 1e-4
    aat_err = 0.0
    for label, x in (("ata(a, rows)", a), ("ata(a_wide, rows)", aw),
                     ("ata(bf16 a, rows)", ab)):
        spec, xp = sf._prepare_aat(x, DEFAULT_LEVELS, "strassen", "strassen",
                                   DEFAULT_BLOCK, DEFAULT_BLOCK,
                                   pipeline_depth=depth)
        aat_err = max(aat_err, main_vs_plain(label, spec, xp, xp))
        del xp
    del aw

    # -- 4d. the streamed update -----------------------------------------------------
    chunks = 4
    rows = n // chunks
    T = n_pad // DEFAULT_BLOCK
    print(f"== 4d. main path: ops.rank_k_update, {chunks} chunks of {rows} "
          f"rows into a zero stack of T = {T} (bn {DEFAULT_BLOCK})")
    stack = torch.zeros(T * (T + 1) // 2 * DEFAULT_BLOCK, DEFAULT_BLOCK,
                        device=dev)
    print(f"  stack {tuple(stack.shape)}, "
          f"{stack.numel() * stack.element_size()} B")
    reset_counts()
    for i in range(chunks):
        stack = ops.rank_k_update(stack, a[i * rows:(i + 1) * rows])
    rk_launches = read_counts("the streamed update")
    assert rk_launches[RANK_K] >= chunks, rk_launches
    assert rk_launches["leaf_products.cu/rank_k"] == rk_launches[RANK_K], \
        rk_launches
    assert bool(torch.isfinite(stack).all())
    one = ops.ata_fused_packed(a)
    e_one = _rel(stack, one.double())
    del one
    a64 = a.double()
    dense = torch.tril(unpack_tril_blocks(stack, n_pad, DEFAULT_BLOCK,
                                          symmetrize=False))[:n, :n]
    e64 = _rel(dense, torch.tril(a64.T @ a64))
    del dense
    print(f"streamed stack vs one-shot ata_fused_packed: {e_one:.3e} "
          f"(<= 1e-5 of max|C|); vs float64: {e64:.3e} (<= 1e-4)")
    assert e_one <= 1e-5 and e64 <= 1e-4
    # One gradient through a chunk update: the stack's cotangent passes
    # through, dA = A (S + S^t) with S the block-lower cotangent stack.
    chunk = a[:rows]
    s0 = stack.clone().requires_grad_()
    x = chunk.clone().requires_grad_()
    reset_counts()
    out = ops.rank_k_update(s0, x, donate=False)
    g_stack, g_chunk = torch.autograd.grad((wp * out).sum(), (s0, x))
    rkg_launches = read_counts("a gradient through a chunk update")
    assert rkg_launches[RANK_K] >= 1 and rkg_launches[SYMM] >= 1
    assert torch.equal(g_stack, wp)
    sw = unpack_tril_blocks(wp, n_pad, DEFAULT_BLOCK,
                            symmetrize=False).double()
    want = (F.pad(chunk.double(), (0, n_pad - n)) @ (sw + sw.T))[:, :n]
    e_dx = _rel(g_chunk, want)
    del want, sw, out, s0, x, g_stack, g_chunk, a64
    print(f"chunk dA vs float64 A (S + S^t): {e_dx:.3e} (<= 1e-4); the "
          f"stack's cotangent passed through exactly")
    assert e_dx <= 1e-4
    rk_spec, rk_x = sf._prepare_rank_k(stack, chunk, DEFAULT_LEVELS,
                                       "strassen", "strassen", DEFAULT_BLOCK,
                                       pipeline_depth=depth)
    rank_k_err = main_vs_plain("rank_k_update(stack, chunk)", rk_spec, rk_x,
                               rk_x, seed=stack)
    lv = sf._rank_k_geometry(rows, T, DEFAULT_LEVELS, "strassen",
                             DEFAULT_BLOCK)["levels"]
    spec, xp, sp = sf._prepare_symm(chunk, wp, lv, "strassen", DEFAULT_BLOCK,
                                    True, pipeline_depth=depth)
    symm_err = max(symm_err, main_vs_plain("its backward", spec, xp, sp))
    del xp, sp

    # -- 4e. the Strassen product --------------------------------------------------
    print(f"== 4e. main path: strassen_matmul at {n} x {n}, plain and "
          f"trans_a, bf16, and their backward")
    b = randn(n, n)
    bb = b.to(bf16)
    reset_counts()
    m0 = strassen_matmul(a, b)
    m1 = strassen_matmul(a, b, trans_a=True)
    mb = strassen_matmul(ab, bb)
    mm_launches = read_counts("the matmul path")
    assert mm_launches[MATMUL] >= 3, mm_launches
    a64, b64 = a.double(), b.double()
    errs = []
    for out, want in ((m0, lambda: a64 @ b64), (m1, lambda: a64.T @ b64),
                      (mb, lambda: ab.double() @ bb.double())):
        assert out.shape == (n, n) and out.dtype == f32
        assert bool(torch.isfinite(out).all())
        errs.append(_rel(out, want()))
    del m0, m1, mb
    print(f"matmul vs float64: a @ b {errs[0]:.3e}, a^t @ b {errs[1]:.3e}, "
          f"bf16 {errs[2]:.3e} (each <= 1e-4 of max|C|)")
    assert max(errs) <= 1e-4
    xa, xb = a.clone().requires_grad_(), b.clone().requires_grad_()
    reset_counts()
    g0 = torch.autograd.grad((w * strassen_matmul(xa, xb)).sum(), (xa, xb))
    g1 = torch.autograd.grad(
        (w * strassen_matmul(xa, xb, trans_a=True)).sum(), (xa, xb))
    mmg_launches = read_counts("the matmul backward (forwards included)")
    assert mmg_launches[MATMUL] >= 6, mmg_launches
    w64 = w.double()
    errs = []
    # C = a b: da = W b^t, db = a^t W; C = a^t b: da = b W^t, db = a W
    for g, want in ((g0[0], lambda: w64 @ b64.T), (g0[1], lambda: a64.T @ w64),
                    (g1[0], lambda: b64 @ w64.T), (g1[1], lambda: a64 @ w64)):
        assert g.shape == (n, n) and g.dtype == f32
        errs.append(_rel(g, want()))
    del g0, g1, xa, xb, a64, b64, w64
    print(f"matmul grads vs float64: a @ b da {errs[0]:.3e} db {errs[1]:.3e};"
          f" a^t @ b da {errs[2]:.3e} db {errs[3]:.3e} (each <= 1e-4)")
    assert max(errs) <= 1e-4
    # The forward and backward configurations, against the plain version.
    matmul_err = 0.0
    for label, x, y, ta, tb in (
            ("a @ b", a, b, False, False), ("a^t @ b", a, b, True, False),
            ("bf16 a @ b", ab, bb, False, False),
            ("its da = W b^t", w, b, False, True),
            ("its db = a^t W", a, w, True, False),
            ("a^t @ b's da = b W^t", b, w, False, True),
            ("a^t @ b's db = a W", a, w, False, False)):
        spec, xp, yp = sf._prepare_matmul(
            x, y, DEFAULT_LEVELS, "strassen", DEFAULT_BLOCK, DEFAULT_BLOCK,
            DEFAULT_BLOCK, ta, tb, pipeline_depth=depth)
        matmul_err = max(matmul_err, main_vs_plain(label, spec, xp, yp))
        del xp, yp

    # -- 4f. the reference recursion with kernel leaves ----------------------
    print(f"== 4f. main path: the reference recursion with kernel leaves at "
          f"{n} x {n}, the ops entry points")
    hooks = dict(base_syrk=ops.kernel_base_syrk(),
                 base_matmul=ops.kernel_base_matmul())
    path_launches = dict.fromkeys(_launch.KERNEL_LAUNCHES, 0)

    def counted(label, fn, tally=path_launches, **want):
        """Run ``fn`` with the counts zeroed just before and read just
        after; every count of ``want`` must match, and no leaf program
        may run.  The counts add up in ``tally``."""
        reset_counts()
        out = fn()
        got = read_counts(label)
        assert all(got[k] == v for k, v in want.items()), (label, want)
        assert not any(got[k] for k in sf.KERNEL_LAUNCHES), label
        for k in tally:
            tally[k] += got[k]
        return out

    s_leaves, m_leaves = hooked_leaves(n, n, DEFAULT_LEVELS, DEFAULT_LEAF)
    sw_leaves, mw_leaves = hooked_leaves(n, wide, DEFAULT_LEVELS,
                                         DEFAULT_LEAF)
    print(f"  expected leaves: {s_leaves} syrk + {m_leaves} matmul at {n} x "
          f"{n}, {sw_leaves} + {mw_leaves} at {n} x {wide}")
    aw = randn(n, wide)
    c = counted("ata(a) with kernel leaves", lambda: ata(a, **hooks),
                syrk=s_leaves, matmul=m_leaves, combine=0, transpose=0)
    cw = counted(f"ata(a {n} x {wide}) with kernel leaves",
                 lambda: ata(aw, **hooks), syrk=sw_leaves, matmul=mw_leaves,
                 combine=0, transpose=0)
    cm = counted("strassen_matmul(a, b) with the kernel leaf",
                 lambda: strassen_matmul(a, b,
                                         base_matmul=hooks["base_matmul"]),
                 syrk=0, matmul=7 ** DEFAULT_LEVELS, combine=0, transpose=0)
    cs = counted("ops.syrk(a)", lambda: ops.syrk(a), syrk=1, matmul=0)
    cp = counted("ops.matmul(a, b)", lambda: ops.matmul(a, b), syrk=0,
                 matmul=1)
    errs = []
    for out, x in ((c, a), (cw, aw), (cs, a)):
        assert out.shape == (x.shape[1],) * 2 and out.dtype == f32
        assert bool(torch.isfinite(out).all())
        x64 = x.double()
        errs.append(_rel(out, torch.tril(x64.T @ x64)))
        del x64
    a64, b64 = a.double(), b.double()
    want = a64 @ b64
    for out in (cm, cp):
        assert out.shape == (n, n) and out.dtype == f32
        assert bool(torch.isfinite(out).all())
        errs.append(_rel(out, want))
    del c, cw, cm, cs, cp
    print(f"vs float64 (of max|C|): ata with kernel leaves {errs[0]:.3e}, on "
          f"{n} x {wide} {errs[1]:.3e}; ops.syrk {errs[2]:.3e}; "
          f"strassen_matmul with the kernel leaf {errs[3]:.3e}; ops.matmul "
          f"{errs[4]:.3e} (each <= 1e-4)")
    assert max(errs) <= 1e-4
    # The seven products of one Strassen level of a @ b, recombined.
    h = (n + 1) // 2
    qa = [F.pad(a, (0, 2 * h - n, 0, 2 * h - n))[r * h:(r + 1) * h,
                                                 c_ * h:(c_ + 1) * h]
          for r in (0, 1) for c_ in (0, 1)]
    qb = [F.pad(b, (0, 2 * h - n, 0, 2 * h - n))[r * h:(r + 1) * h,
                                                 c_ * h:(c_ + 1) * h]
          for r in (0, 1) for c_ in (0, 1)]
    (a11, a12, a21, a22), (b11, b12, b21, b22) = qa, qb
    with torch.no_grad():
        prods = [(a11 + a22) @ (b11 + b22), (a21 + a22) @ b11,
                 a11 @ (b12 - b22), a22 @ (b21 - b11), (a11 + a12) @ b22,
                 (a21 - a11) @ (b11 + b12), (a12 - a22) @ (b21 + b22)]
    del qa, qb, a11, a12, a21, a22, b11, b12, b21, b22
    quads = counted("ops.strassen_combine on seven products",
                    lambda: ops.strassen_combine(*prods), combine=1)
    plain_quads = k_combine._strassen_combine_plain(*prods)
    assert all(torch.equal(q, p_) for q, p_ in zip(quads, plain_quads))
    full = torch.cat([torch.cat(quads[:2], 1), torch.cat(quads[2:], 1)])
    e_comb = _rel(full[:n, :n], want)
    del full, plain_quads, quads, want
    print(f"strassen_combine of the seven {h} x {h} products: bit-equal to "
          f"plain; C vs float64 A B {e_comb:.3e} (<= 1e-4)")
    assert e_comb <= 1e-4
    t = counted("ops.transpose(a)", lambda: ops.transpose(a), transpose=1)
    assert torch.equal(t, a.T)
    del t, a64, b64
    print("ops.transpose(a) equals a.T")
    # fp16 A through the same recursion: every leaf a kernel's fp16
    # instantiation, the result in fp32 (the promoted type, as the JAX
    # package's); the seven products in fp16, recombined in fp16
    path16 = dict.fromkeys(_launch.KERNEL_LAUNCHES, 0)
    a16 = a.half()
    c16 = counted("ata(fp16 a) with kernel leaves", lambda: ata(a16, **hooks),
                  tally=path16, syrk=s_leaves, matmul=m_leaves, combine=0,
                  transpose=0)
    assert c16.shape == (n, n) and c16.dtype == f32
    assert bool(torch.isfinite(c16).all())
    x64 = a16.double()
    e16 = _rel(c16, torch.tril(x64.T @ x64))
    del c16, x64
    prods16 = [p_.half() for p_ in prods]
    q16 = counted("ops.strassen_combine on seven fp16 products",
                  lambda: ops.strassen_combine(*prods16), tally=path16,
                  combine=1)
    assert all(q.dtype == torch.float16 and torch.equal(q, p_) for q, p_ in
               zip(q16, k_combine._strassen_combine_plain(*prods16)))
    del q16, prods16
    print(f"ata(fp16 a) with kernel leaves vs float64 of the fp16 A: "
          f"{e16:.3e} (<= 2^-8: fp16 leaves and sums, bf16's bar); "
          f"strassen_combine of the fp16 products bit-equal to plain; "
          f"fp16 launches {path16}")
    assert e16 <= 2.0 ** -8
    # the same recursion end to end: its 16 + 22 leaves on the tensor-core
    # core, the sums and pads in torch
    ata16_ms, ata16_runs = _time_ms(lambda: ata(a16, **hooks))
    print(f"ata(fp16 a) with kernel leaves end to end: {ata16_ms:.3f} ms "
          f"(runs {ata16_runs})")
    x = a.clone().requires_grad_()
    for call in (lambda: ata(x, **hooks), lambda: ops.syrk(x),
                 lambda: ops.matmul(x, b)):
        try:
            counted("a refused call", call, syrk=0, matmul=0)
        except RuntimeError as err:
            assert "forward-only" in str(err)
            continue
        raise AssertionError("an operand that requires grad ran")
    del x
    print(f"an A that requires grad is refused; launches on this path: "
          f"{path_launches}")
    # Each leaf configuration the path ran, against the plain version on
    # the same operands; uncounted.
    leaf_err = dict.fromkeys(("syrk", "matmul"), 0.0)
    B = DEFAULT_BLOCK
    hs = (h + 1) // 2
    for label, x in (("ata leaf", a[:hs, :hs]),
                     (f"ata {n} x {wide} leaf", aw[:hs, :(wide + 3) // 4]),
                     ("ops.syrk(a)", a)):
        xp = ops._pad_to(x, (B, B))
        got = k_syrk.syrk_packed(xp, bk=B, bn=B)
        ref = k_syrk._syrk_packed_plain(xp, B, f32)
        err = float((got - ref).abs().max())
        print(f"  syrk, {label} {tuple(xp.shape)}: kernel vs plain max|d| "
              f"{err:.3e}, relative {_rel(got, ref.double()):.3e} (<= 1e-5)")
        assert _rel(got, ref.double()) <= 1e-5
        leaf_err["syrk"] = max(leaf_err["syrk"], err)
    ww = (wide + 3) // 4
    for label, x, y in (("ata leaf", a[:hs, :hs].T, a[:hs, :hs]),
                        (f"ata {n} x {wide} leaf", aw[:hs, :ww].T,
                         aw[:hs, :ww]),
                        ("strassen_matmul leaf", a[:hs, :hs], b[:hs, :hs]),
                        ("ops.matmul(a, b)", a, b)):
        xp, yp = ops._pad_to(x, (B, B)), ops._pad_to(y, (B, B))
        got = k_matmul.matmul_padded(xp, yp, bm=B, bk=B, bn=B)
        ref = k_matmul._matmul_padded_plain(xp, yp, f32)
        err = float((got - ref).abs().max())
        print(f"  matmul, {label} {tuple(xp.shape)} @ {tuple(yp.shape)}: "
              f"kernel vs plain max|d| {err:.3e}, relative "
              f"{_rel(got, ref.double()):.3e} (<= 1e-5)")
        assert _rel(got, ref.double()) <= 1e-5
        leaf_err["matmul"] = max(leaf_err["matmul"], err)
    del aw, xp, yp, got, ref

    # -- 4g. serving Qwen2.5-3B at full width ---------------------------------
    cfg = dataclasses.replace(get_arch("qwen2.5-3b"), attn_impl="flash")
    print(f"== 4g. main path: ServingEngine on {cfg.name} at full width "
          f"({cfg.num_layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab_size}), {cfg.dtype}, attn_impl='flash'")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()    # the earlier phases' tensors
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed))
    n_params = param_count(params)
    rng = np.random.default_rng(args.seed)
    lens = rng.integers(100, 1501, size=7).tolist() + [MAX_SEQ - 16]
    prompts = [rng.integers(0, cfg.vocab_size, size=n_).tolist()
               for n_ in lens]
    print(f"  {n_params} parameters; prompt lengths {lens}, 16 new tokens "
          f"each, slots 4, max_seq {MAX_SEQ}, greedy")

    class Recorder(ServingEngine):
        """Keeps the logits each request's tokens were sampled from: the
        prefill's last position, then request 0's decode rows."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.first_logits, self.decode_logits = [], []

        def _sample(self, logits):
            if logits.shape[0] == 1:                      # admission
                self.first_logits.append(logits[0].float())
            else:
                for slot, r in self.active.items():
                    if r is not None and r.uid == 0:
                        self.decode_logits.append(logits[slot].float())
            return super()._sample(logits)

    eng = Recorder(cfg, params, slots=4, max_seq=MAX_SEQ)
    for p_ in prompts:
        eng.add_request(p_, max_new_tokens=16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    finished = eng.run_to_completion()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = read_counts("the serving path")
    # weights, cache and activations: the peak less what was held before
    peak_bytes = torch.cuda.max_memory_allocated() - held
    want = dict.fromkeys(serve_launches, 0)
    want["flash_attention"] = cfg.num_layers * len(prompts)
    assert serve_launches == want, serve_launches
    assert len(finished) == len(prompts)
    assert all(r.status == "ok" and len(r.generated) == 16
               and all(0 <= t_ < cfg.vocab_size for t_ in r.generated)
               for r in finished)
    st = eng.stats
    ttft = {r.uid: r.t_first - r.t_submit for r in finished}
    print(f"  {len(finished)} requests in {serve_s:.3f} s; flash_attention "
          f"launches {serve_launches['flash_attention']} (= {cfg.num_layers}"
          f" layers x {len(prompts)} prefills)")
    print(f"  time to first token, s (from submission, queueing included): "
          + ", ".join(f"{u}: {t_:.4f}" for u, t_ in sorted(ttft.items())))
    prefill_rate = st["prefill_tokens"] / st["prefill_s"]
    print(f"  prefill: {st['prefill_tokens']} tokens in "
          f"{st['prefill_s']:.4f} s, {prefill_rate:.1f} tokens/s; decode: "
          f"{st['decode_tokens']} tokens in {st['ticks']} ticks, "
          f"{st['decode_s']:.4f} s, "
          f"{st['decode_tokens'] / st['decode_s']:.1f} tokens/s; peak "
          f"memory {peak_bytes} B")
    # bf16: each prefill's last-position logits against the same forward
    # with plain torch attention (attn_impl="xla", one-shot below 2048
    # tokens) in bf16 and in fp32, and against the bf16 flash forward with
    # no cache and no bucket padding; request 0's decode logits against a
    # train-mode forward with no cache.  Then the bf16 forward with a
    # planted fault in its attention, against plain attention.  fp32: the
    # flash kernel in the model against plain attention at each prompt,
    # and request 0's prefill and 15 decode steps through a fresh B = 1
    # cache against the no-cache forward.
    cfg_plain = dataclasses.replace(cfg, attn_impl="xla")
    cfg32 = dataclasses.replace(cfg, dtype="float32", attn_impl="xla")
    cfg32_flash = dataclasses.replace(cfg32, attn_impl="flash")

    def to_f32(tree):
        if isinstance(tree, dict):
            return {k_: to_f32(v_) for k_, v_ in tree.items()}
        if isinstance(tree, list):
            return [to_f32(v_) for v_ in tree]
        return tree.float()
    params32 = to_f32(params)
    r0 = next(r for r in finished if r.uid == 0)
    seq0 = torch.tensor([prompts[0] + r0.generated[:-1]], device=dev)
    n0 = len(prompts[0])
    flash_mha = ops.flash_mha

    def rows_past_tile0_zeroed(q, k, v, **kw):
        out = flash_mha(q, k, v, **kw).clone()
        out[:, k_flash.q_tile(q.dtype):] = 0
        return out

    def blind_to_kv_tile0(q, k, v, **kw):
        """Causal attention in which each row past the first q tile misses
        the first kv tile, as a wrong tile skip would."""
        b_, sq_, h_, d_ = q.shape
        skv_, hkv_ = k.shape[1], k.shape[2]
        bq_, bk_ = k_flash.q_tile(q.dtype), k_flash.kv_tile(q.dtype, d_)
        qg = q.float().reshape(b_, sq_, hkv_, h_ // hkv_, d_)
        sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * d_ ** -0.5
        qp = torch.arange(sq_, device=dev)[:, None]
        kp = torch.arange(skv_, device=dev)[None]
        sc = sc.masked_fill((qp < kp) | ((qp >= bq_) & (kp < bk_)), -1e30)
        out = torch.einsum("bhgqk,bkhd->bqhgd", sc.softmax(-1), v.float())
        return out.reshape(b_, sq_, h_, d_).to(q.dtype)

    faults = {"rows past the first q tile zeroed": rows_past_tile0_zeroed,
              "rows past the first q tile blind to kv tile 0":
              blind_to_kv_tile0}
    fault_errs = {name: [] for name in faults}
    prefill_errs, f32_errs, plain_errs, no_pad_errs = [], [], [], []
    with torch.no_grad():
        for p_, got in zip(prompts, eng.first_logits):
            toks = torch.tensor([p_], device=dev)
            plain_row = forward(cfg_plain, params, toks,
                                mode="train")[0][0, -1]
            plain_errs.append(_rel(got, plain_row.double()))
            no_pad = forward(cfg, params, toks, mode="train")[0][0, -1]
            no_pad_errs.append(_rel(got, no_pad.double()))
            for fault_name, fault in faults.items():
                ops.flash_mha = fault
                try:
                    bad = forward(cfg, params, toks, mode="train")[0][0, -1]
                finally:
                    ops.flash_mha = flash_mha
                fault_errs[fault_name].append(_rel(bad, plain_row.double()))
            del plain_row, no_pad, bad
            ref32 = forward(cfg32, params32, toks, mode="train")[0][0, -1]
            flash32 = forward(cfg32_flash, params32, toks,
                              mode="train")[0][0, -1]
            prefill_errs.append(_rel(got, ref32.double()))
            f32_errs.append(_rel(flash32, ref32.double()))
            del ref32, flash32
        want32 = forward(cfg32, params32, seq0, mode="train")[0][0, n0 - 1:]
        cache = init_cache(cfg32_flash, 1, MAX_SEQ)
        got32, cache = prefill(cfg32_flash, params32, seq0[:, :n0], cache)
        got32 = [got32[0]]
        for i in range(15):
            step, cache = decode_step(cfg32_flash, params32,
                                      seq0[:, n0 + i:n0 + i + 1], cache)
            got32.append(step[0])
        e_dec32 = _rel(torch.stack(got32), want32.double())
        del params32, cache, got32, want32
        full0 = forward(cfg, params, seq0, mode="train")[0][0, n0:].float()
    dec = torch.stack(eng.decode_logits)
    assert dec.shape == full0.shape == (15, cfg.vocab_size)
    e_dec = _rel(dec, full0.double())
    print(f"  bf16 engine, prefill logits, of max|logits| (each <= "
          f"{SERVE_BF16_BAR:.0e}): vs bf16 plain attention "
          + ", ".join(f"{e:.3e}" for e in plain_errs)
          + "; vs fp32 plain attention "
          + ", ".join(f"{e:.3e}" for e in prefill_errs)
          + "; vs the bf16 flash forward with no cache and no bucket "
          "padding " + ", ".join(f"{e:.3e}" for e in no_pad_errs)
          + f"; request 0's 15 decode steps vs a no-cache bf16 forward: "
          f"{e_dec:.3e}")
    for fault_name, errs in fault_errs.items():
        print(f"  planted fault, {fault_name}: bf16 vs bf16 plain attention "
              + ", ".join(f"{e:.3e}" for e in errs)
              + f" (each > {SERVE_BF16_BAR:.0e})")
    print(f"  fp32, flash vs plain attention at each prompt: "
          + ", ".join(f"{e:.3e}" for e in f32_errs)
          + f"; request 0's prefill and 15 decode steps through the cache "
          f"vs no cache: {e_dec32:.3e} (each <= {SERVE_F32_BAR:.0e})")
    assert max(prefill_errs + plain_errs + no_pad_errs + [e_dec]) \
        <= SERVE_BF16_BAR
    assert min(min(errs) for errs in fault_errs.values()) > SERVE_BF16_BAR
    assert max(f32_errs) <= SERVE_F32_BAR and e_dec32 <= SERVE_F32_BAR
    del eng, full0, dec

    # -- 4h. where the serving time goes -------------------------------------
    print("== 4h. where the serving time goes: one 2032-token prefill and "
          "one decode tick of 4 slots under torch.profiler (warm)")
    from torch.profiler import ProfilerActivity, profile

    def profiled(label, step):
        """Wall time of ``step`` (ending in a sync), the device's kernel
        time inside it, the busy share and the top kernels."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
        flash_ms = sum(e.self_device_time_total for e in kern
                       if "flash_tc_kernel" in e.key
                       or "flash_kernel" in e.key) / 1e3
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
        print(f"  {label}: wall {wall_ms:.3f} ms, device kernels "
              f"{dev_ms:.3f} ms, busy {dev_ms / wall_ms:.1%}; the flash "
              f"kernel {flash_ms:.3f} ms, {flash_ms / dev_ms:.1%} of the "
              f"device time; top: "
              + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f}"
                          f" ms x {e.count}" for e in top))
        return {"wall_ms": wall_ms, "device_ms": dev_ms, "flash_ms": flash_ms,
                "top": [[e.key, e.self_device_time_total / 1e3, e.count]
                        for e in top]}

    one = ServingEngine(cfg, params, slots=1, max_seq=MAX_SEQ)
    one.add_request(prompts[-1], max_new_tokens=1)
    prof_prefill = profiled("prefill of 2032 tokens", one.step)
    four = ServingEngine(cfg, params, slots=4, max_seq=MAX_SEQ)
    for p_ in prompts[:4]:
        four.add_request(p_, max_new_tokens=3)
    four.step()                          # the four prefills, one tick
    prof_decode = profiled("decode tick, 4 live slots", four.step)
    del one, four, params

    # -- 4i. the precision axes ----------------------------------------------
    print(f"== 4i. main path: the precision axes at {n} x {n}: quantized "
          f"operands, bf16 and fp64 accumulators, fp64 and fp16 input and "
          f"output, stochastic rounding")
    from repro_torch.gram.verify import default_rtol, verify_gram
    fp16, e4m3, e5m2, fp64 = (torch.float16, torch.float8_e4m3fn,
                              torch.float8_e5m2, torch.float64)
    a64 = a.double()
    a_nan = a.clone()
    a_nan[n // 3, (2 * n) // 3] = 500.0     # past e4m3fn's 464: NaN
    gb = randn(n, n, dtype=bf16)            # a cotangent for the bf16 output
    reset_counts()
    quant = {od: ata(a, operand_dtype=od) for od in (e4m3, e5m2, fp16)}
    stack8 = torch.zeros(T * (T + 1) // 2 * DEFAULT_BLOCK, DEFAULT_BLOCK,
                         device=dev)
    for i in range(chunks):
        stack8 = ops.rank_k_update(stack8, a[i * rows:(i + 1) * rows],
                                   operand_dtype=e4m3)
    c_nan = ata(a_nan, operand_dtype=e4m3)
    c_bf = ata(a, acc_dtype="bfloat16")
    c_f64 = ata(a64, acc_dtype="float64")
    c_in64, c_in16 = ata(a64), ata(a.half())
    c_out16 = ata(a, out_dtype=fp16)
    sr = [ata(a, out_dtype=bf16, sr_seed=seed) for seed in (7, 7, 8)]
    xa = a.clone().requires_grad_()
    (g_sr,) = torch.autograd.grad(ata(xa, out_dtype=bf16, sr_seed=7), xa, gb)
    xa = a.clone().requires_grad_()
    (g_core,) = torch.autograd.grad(ata(xa), xa, gb.float())
    del xa
    prec_launches = read_counts("the precision axes")
    for key, least in (("leaf_products_lowp.cu/ata", 5),
                       ("leaf_products_lowp.cu/rank_k", chunks),
                       ("leaf_products_acc.cu/ata", 2),
                       ("leaf_products.cu/ata", 7)):
        assert prec_launches[key] >= least, (key, prec_launches)
    assert prec_launches[SYMM] >= 2, prec_launches
    # each quantized path against the float64 product of its quantized
    # operands, and the Freivalds guard against the original A
    quant_errs = {}
    for od, out in [*quant.items(), ("rank_k", None)]:
        if od == "rank_k":
            od, out = e4m3, torch.tril(unpack_tril_blocks(
                stack8, n_pad, DEFAULT_BLOCK, symmetrize=False))[:n, :n]
            label = "rank_k_update(e4m3fn chunks)"
        else:
            label = f"ata(a, operand_dtype={str(od).removeprefix('torch.')})"
        aq = sf._quantize(a, od).double()
        err = _rel(out, torch.tril(aq.T @ aq))
        del aq
        verdict = verify_gram(a, out, probes=2, full=False,
                              rtol=default_rtol(od))
        quant_errs[label] = err
        print(f"  {label}: {out.dtype}, vs float64 of the quantized A "
              f"{err:.3e} (<= 1e-4); verify_gram at default_rtol "
              f"{default_rtol(od):.2e}: ok={verdict.ok}, Freivalds error "
              f"{verdict.max_rel_err:.3e}")
        assert out.shape == (n, n) and out.dtype == f32
        assert err <= 1e-4 and verdict.ok, (label, err, verdict)
    del quant, out
    want = torch.tril(a64.T @ a64)
    e_bf, e_f64 = _rel(c_bf, want), _rel(c_f64, want)
    e_in64, e_out16 = _rel(c_in64, want), _rel(c_out16, want)
    ah = a.half().double()
    e_in16 = _rel(c_in16, torch.tril(ah.T @ ah))
    del ah
    # the bf16 accumulator against the TPU kernel's own order (the
    # destination walk, on the card) at the same rounding points
    bspec, bap = sf._prepare_ata(a, DEFAULT_LEVELS, "strassen", "strassen",
                                 DEFAULT_BLOCK, DEFAULT_BLOCK,
                                 pipeline_depth=depth, acc_dtype="bfloat16")
    walk = sf._leaf_program_plain(bspec, sf._spec_tables(bspec, dev), bap, bap,
                                  fp64)
    e_walk = _rel(tril_dense(n, n_pad, DEFAULT_BLOCK)(walk), want)
    del walk, want
    print(f"  ata(a, acc_dtype='bfloat16'): vs float64 {e_bf:.3e}, the "
          f"destination walk's in bf16 {e_walk:.3e} (<= 1.5x); ata(fp64 a, "
          f"acc_dtype='float64') -> {c_f64.dtype}: {e_f64:.3e} (<= 1e-5); "
          f"ata(fp64 a) -> {c_in64.dtype}: {e_in64:.3e}; ata(fp16 a) -> "
          f"{c_in16.dtype}: {e_in16:.3e} (<= 1e-4); ata(a, out_dtype=fp16) "
          f"-> {c_out16.dtype}: {e_out16:.3e} (<= 2^-10)")
    assert c_bf.dtype == f32 and e_bf <= 1.5 * e_walk, (e_bf, e_walk)
    assert c_f64.dtype == fp64 and e_f64 <= 1e-5, e_f64
    assert c_in64.dtype == fp64 and c_in16.dtype == f32 and \
        c_out16.dtype == fp16
    assert max(e_in64, e_in16) <= 1e-4 and e_out16 <= 2.0 ** -10
    del c_bf, c_f64, c_in64, c_in16, c_out16
    # stochastic rounding: the same seed the same bits, another seed not,
    # every element a bf16 neighbour of the fp32 result; straight-through
    sr_equal, sr_other = torch.equal(sr[0], sr[1]), torch.equal(sr[0], sr[2])
    core = ata(a)
    ulp = (sr[0].float() - core).abs().max() / core.abs().max()
    del core
    print(f"  ata(a, out_dtype=bf16, sr_seed=7) twice: bit-equal {sr_equal}; "
          f"with sr_seed=8: bit-equal {sr_other}; max|sr - fp32| of max|C| "
          f"{float(ulp):.3e} (<= 2^-7); its gradient equals the fp32 core's "
          f"{torch.equal(g_sr, g_core)}")
    assert all(x.dtype == bf16 for x in sr) and sr_equal and not sr_other
    assert float(ulp) <= 2.0 ** -7 and torch.equal(g_sr, g_core)
    del sr, g_sr, g_core
    # the NaN of an input past e4m3fn's range, spread by the signed sums:
    # the kernel's NaNs lie where the plain version's do
    nspec, nap = sf._prepare_ata(a_nan, DEFAULT_LEVELS, "strassen",
                                 "strassen", DEFAULT_BLOCK, DEFAULT_BLOCK,
                                 pipeline_depth=depth, operand_dtype=e4m3)
    p_nan = tril_dense(n, n_pad, DEFAULT_BLOCK)(plain(nspec, nap, nap, f32))
    same_nans = torch.equal(torch.isnan(c_nan), torch.isnan(p_nan))
    n_nans = int(torch.isnan(c_nan).sum())
    fin = ~torch.isnan(p_nan)
    e_fin = _rel(c_nan[fin], p_nan[fin].double())
    print(f"  ata(a with {float(a_nan[n // 3, (2 * n) // 3])} at "
          f"({n // 3}, {(2 * n) // 3}), operand_dtype=e4m3fn): {n_nans} NaNs "
          f"of {n * n}, in the plain version's elements {same_nans}; the rest "
          f"vs plain {e_fin:.3e}")
    assert same_nans and 0 < n_nans < n * n and e_fin <= 1e-5
    del c_nan, p_nan, fin, nap, a_nan
    # each configuration of the path against its plain version, uncounted

    def vs_plain(label, spec, left, right, bar, seed=None, out_dtype=f32):
        """The kernel against its plain version; ``bar=0`` asks for
        their bits to be equal."""
        got = sf.leaf_program(spec, left, right, out_dtype, seed=seed)
        ref = plain(spec, left, right, out_dtype, seed)
        err = float((got - ref).abs().max())
        rel = _rel(got, ref.double())
        print(f"  {label}: {spec.kind} L{spec.levels} {tuple(left.shape)} "
              f"{left.dtype}, {spec.acc_dtype} accumulator -> {out_dtype}, "
              f"on {library_of(spec, left, right)}, ring depth "
              f"{sf.ring_depth(spec)}: kernel vs plain max|d| {err:.3e}, "
              f"relative {rel:.3e} "
              f"({'bit-equal' if bar == 0 else f'<= {bar:.1e}'})")
        assert torch.equal(got, ref) if bar == 0 else rel <= bar, (label, rel)
        return err

    prec_specs = {}
    for od in (e4m3, e5m2, fp16):
        prec_specs[od] = sf._prepare_ata(a, DEFAULT_LEVELS, "strassen",
                                         "strassen", DEFAULT_BLOCK,
                                         DEFAULT_BLOCK, pipeline_depth=depth,
                                         operand_dtype=od)
    lowp_err = max(vs_plain(f"ata, {od}", *prec_specs[od], prec_specs[od][1],
                            1e-5) for od in prec_specs)
    rk8_spec, rk8_x = sf._prepare_rank_k(stack8, chunk, DEFAULT_LEVELS,
                                         "strassen", "strassen", DEFAULT_BLOCK,
                                         pipeline_depth=depth,
                                         operand_dtype=e4m3)
    lowp_err = max(lowp_err, vs_plain("rank_k_update, e4m3fn chunk", rk8_spec,
                                      rk8_x, rk8_x, 1e-5, seed=stack8))
    acc_err = vs_plain("ata, bf16 accumulator", bspec, bap, bap, 2.0 ** -7)
    fspec, fap = sf._prepare_ata(a64, DEFAULT_LEVELS, "strassen", "strassen",
                                 DEFAULT_BLOCK, DEFAULT_BLOCK,
                                 pipeline_depth=depth, acc_dtype="float64")
    acc_err = max(acc_err, vs_plain("ata(fp64 a), fp64 accumulator", fspec,
                                    fap, fap, 0, out_dtype=fp64))
    del a64

    # -- 4j. streaming the Gram ------------------------------------------------
    print(f"== 4j. main path: the streamed Gram, A ({n} x {n}) in {chunks} "
          f"chunks of {rows} rows, packed (GramStream) and tile-stack "
          f"(GramStackStream), checkpointed every 2 chunks, killed after 3 "
          f"and resumed")
    parts = [a[i * rows:(i + 1) * rows] for i in range(chunks)]
    c_one = ata(a)
    a64 = a.double()
    want = torch.tril(a64.T @ a64)
    del a64

    def timed(fn):
        """``fn()`` and its time in ms between two CUDA events."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def vs_one_shot(label, c):
        """The lower triangle of a streamed Gram against the one-shot
        ``ata(a)`` (<= 1e-5 of max|C|) and float64 (<= 1e-4)."""
        low = torch.tril(c)
        e_one, e64 = _rel(low, c_one.double()), _rel(low, want)
        print(f"  {label} vs one-shot ata(a): {e_one:.3e} (<= 1e-5); vs "
              f"float64: {e64:.3e} (<= 1e-4)")
        assert e_one <= 1e-5 and e64 <= 1e-4, (label, e_one, e64)
        return {"vs_one_shot": e_one, "vs_float64": e64}

    streamed = {}
    for layout, kind in (("packed", "ata"), ("stack", "rank_k")):
        strm = stream.init(n) if layout == "packed" else stream.stack_init(n)
        step = stream.update if layout == "packed" else stream.stack_update
        reset_counts()
        update_ms = []
        for x in parts:
            strm, ms_ = timed(lambda: step(strm, x))
            update_ms.append(ms_)
        got = read_counts(f"the {layout} stream")
        lib_key = f"leaf_products.cu/{kind}"
        assert got[f"leaf_program/{kind}"] == got[lib_key] == chunks, got
        assert sum(v for k, v in got.items()
                   if k.startswith("leaf_program/")) == chunks, got
        assert int(strm.rows) == n and strm.rows.dtype == torch.int32
        state = strm.packed if layout == "packed" else strm.stack
        assert bool(torch.isfinite(state).all())
        fin = (lambda: stream.finalize(strm)) if layout == "packed" else \
            (lambda: stream.stack_finalize(strm, n))
        c_st, fin_ms = timed(fin)
        assert c_st.shape == (n, n) and torch.equal(c_st, c_st.T)
        shape = (f"{state.shape[0] // strm.block} tiles of {strm.block}^2"
                 if layout == "stack" else f"{state.numel()} words")
        print(f"  {layout}: {chunks} {kind}-kind launches of "
              f"leaf_products.cu; state {shape}, "
              f"{state.numel() * state.element_size() / 1e6:.1f} MB; update "
              f"ms by chunk {[round(t_, 3) for t_ in update_ms]}; finalize "
              f"(dense, mirrored) {fin_ms:.3f} ms")
        streamed[layout] = {"kind": kind, "launches": got[lib_key],
                            "update_ms": update_ms, "finalize_ms": fin_ms,
                            "state_bytes": state.numel()
                            * state.element_size(),
                            **vs_one_shot(layout, c_st)}
        del strm, state, c_st
    assert streamed["stack"]["state_bytes"] == \
        tri_count(-(-n // DEFAULT_BLOCK)) * DEFAULT_BLOCK ** 2 * 4
    # Crash recovery: an uninterrupted checkpointed run, and one killed
    # after 3 chunks (its last commit at chunk 2) and resumed there; the
    # commits' and the restore's times from the port's tracer.
    tracer = obs_trace.set_tracer(obs_trace.Tracer(enabled=True))
    with tempfile.TemporaryDirectory() as tmp:
        for layout in ("packed", "stack"):
            ref_s = stream.CheckpointedGramStream(n, f"{tmp}/{layout}-ref",
                                                every=2, layout=layout)
            for x in parts:
                ref_s.update(x)
            ref_c = ref_s.finalize()
            del ref_s
            shutil.rmtree(f"{tmp}/{layout}-ref")
            wal = f"{tmp}/{layout}-wal"
            s1 = stream.CheckpointedGramStream(n, wal, every=2, layout=layout)
            for x in parts[:3]:
                s1.update(x)
            del s1
            commits = [e_.duration_s * 1e3 for e_ in tracer.events()
                       if e_.name == "stream_commit"
                       and e_.attrs.get("layout") == layout]
            tracer.clear()
            s2 = stream.CheckpointedGramStream(n, wal, every=2, layout=layout)
            (restore,) = [e_.duration_s * 1e3 for e_ in tracer.events()
                          if e_.name == "stream_restore"]
            assert s2.resumed and s2.next_chunk == 2, s2.next_chunk
            state = s2.state.packed if layout == "packed" else s2.state.stack
            assert state.device.type == "cuda" and int(s2.state.rows) == \
                2 * rows
            for i, x in enumerate(parts):
                if i >= s2.next_chunk:
                    s2.update(x)
            out = s2.finalize()
            same = torch.equal(out, ref_c)
            npz = os.path.getsize(f"{wal}/step_{chunks:08d}/state.npz")
            print(f"  {layout}, checkpointed: resumed at chunk "
                  f"{2} after a kill at 3, finalize torch.equal to the "
                  f"uninterrupted run: {same}; commit ms "
                  f"{[round(t_, 1) for t_ in commits]}, restore "
                  f"{restore:.1f} ms, of {npz / 1e6:.1f} MB (state.npz)")
            assert same, layout
            streamed[layout].update(commit_ms=commits, restore_ms=restore,
                                    checkpoint_bytes=npz,
                                    resumed_bit_equal=same)
            del s2, state, out, ref_c
    obs_trace.set_tracer(None)
    # One gradient through each layout's update: the packed one through
    # the gather and the ata kind's backward, the stack one through the
    # rank_k kind's (not donated); dA against float64 A (S + S^t).
    x = parts[0].clone().requires_grad_()
    wv = randn(n * (n + 1) // 2)
    reset_counts()
    st1 = stream.update(stream.init(n), x)
    (g,) = torch.autograd.grad((wv * st1.packed).sum(), x)
    got = read_counts("a gradient through a packed update")
    assert got[ATA] == 1 and got[SYMM] >= 1, got
    wl = unpack_tril(wv, n, symmetrize=False).double()
    e_gp = _rel(g, parts[0].double() @ (wl + wl.T))
    del wl, wv, st1, g
    ss0 = stream.stack_init(n)
    s0 = ss0.stack.requires_grad_()
    wq = randn(*s0.shape)
    x = parts[0].clone().requires_grad_()
    reset_counts()
    out = stream.stack_update(stream.GramStackStream(stack=s0, rows=ss0.rows),
                            x)
    g_stack, g = torch.autograd.grad((wq * out.stack).sum(), (s0, x))
    got = read_counts("a gradient through a stack update")
    assert got[RANK_K] == 1 and got[SYMM] >= 1, got
    assert torch.equal(g_stack, wq) and out.stack.data_ptr() != s0.data_ptr()
    sw = unpack_tril_blocks(wq, ss0.n_padded, DEFAULT_BLOCK,
                            symmetrize=False).double()
    e_gs = _rel(g, (F.pad(parts[0].double(), (0, ss0.n_padded - n))
                    @ (sw + sw.T))[:, :n])
    del sw, wq, s0, ss0, out, g_stack, g, x, parts, c_one, want
    print(f"  dA through a packed update vs float64 A (S + S^t): {e_gp:.3e}; "
          f"through a stack update: {e_gs:.3e} (each <= 1e-4)")
    assert e_gp <= 1e-4 and e_gs <= 1e-4
    streamed["packed"]["grad_vs_float64"] = e_gp
    streamed["stack"]["grad_vs_float64"] = e_gs

    # -- 4k. the distributed layer on the card ---------------------------------
    # One H100: a one-rank NCCL world, so every collective runs through
    # NCCL on the device; the multi-rank schedules are held on the CPU in
    # gloo worlds (tests/test_torch_distributed.py).
    import torch.distributed as dist
    from repro_torch.core import distributed as cdist
    from repro_torch.launch.mesh import make_gram_mesh
    print(f"== 4k. main path: distributed_gram and the distributed streams "
          f"on a one-rank NCCL world, A {n} x {n}")
    t_phase = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_gram_mesh(1)
        axes = cdist.default_gram_axes(mesh)
        nccl = ".".join(map(str, torch.cuda.nccl.version()))
        backend = dist.get_backend(mesh.get_group("data"))
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        print(f"  NCCL {nccl}, mesh {sizes} on {mesh.device_type}, groups "
              f"{backend}; axes {axes}")
        assert backend == "nccl", backend
        schemes = ("allreduce", "reducescatter", "ring", "bfs25d", "auto")
        reset_counts()
        c_full = ata_full(a)
        dist_out = {s_: cdist.distributed_gram(a, mesh, scheme=s_, **axes)
                    for s_ in schemes}
        got = read_counts("ata_full(a) and the five distributed_gram calls")
        # one ata-kind launch each, no block task on a one-rank ring
        assert got[ATA] == got["leaf_products.cu/ata"] == 1 + len(schemes), \
            got
        assert got[MATMUL] == 0 and sum(
            v for k_, v in got.items() if k_.startswith("leaf_program/")) \
            == got[ATA], got
        dist_launches = {"ata": got[ATA], "matmul": got[MATMUL]}
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            cdist.distributed_gram(a, mesh, scheme="auto", **axes)
        spans = sorted({e_.key for e_ in prof.key_averages()
                        if e_.key.startswith("gram_dist:")})
        print(f"  profiler span of scheme='auto': {spans}")
        assert spans == ["gram_dist:allreduce"], spans
        full_ms, _ = _time_ms(lambda: ata_full(a))
        print(f"  ata_full(a): {full_ms:.3f} ms")
        distributed = {"nccl": nccl, "ata_full_ms": full_ms,
                       "launches": dist_launches, "schemes": {}}
        for s_, out in dist_out.items():
            loc = out.to_local()
            assert loc.shape == (n, n) and loc.dtype == f32, (s_, loc.shape)
            e_ = _rel(loc, c_full.double())
            same = torch.equal(loc, c_full)
            ms, runs = _time_ms(lambda: cdist.distributed_gram(
                a, mesh, scheme=s_, **axes))
            print(f"  {s_}: {[repr(p_) for p_ in out.placements]}, vs "
                  f"ata_full(a) {e_:.3e} (<= 1e-5), bit-equal {same}; "
                  f"{ms:.3f} ms (runs {[round(t_, 3) for t_ in runs]}), "
                  f"{ms - full_ms:+.3f} over ata_full")
            assert e_ <= 1e-5, (s_, e_)
            distributed["schemes"][s_] = {
                "vs_ata_full": e_, "bit_equal": same, "ms": ms,
                "over_ata_full_ms": ms - full_ms,
                "placements": [repr(p_) for p_ in out.placements]}
        del dist_out, loc, out
        d_parts = [a[i * rows:(i + 1) * rows] for i in range(chunks)]
        for s_ in ("reducescatter", "ring"):
            state = stream.distributed_init(n, mesh, scheme=s_)
            reset_counts()
            upd_ms = []
            for x in d_parts:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                new = stream.distributed_update(state, x, mesh, scheme=s_)
                end.record()
                end.synchronize()
                assert new is state          # in place
                upd_ms.append(start.elapsed_time(end))
            got = read_counts(f"the distributed {s_} stream")
            assert got[ATA] == chunks and got[MATMUL] == 0, got
            fin = stream.distributed_finalize(state, mesh,
                                              scheme=s_).to_local()
            e_ = _rel(fin, c_full.double())
            print(f"  distributed_update, {s_}: {chunks} chunks of {rows} "
                  f"rows, update ms {[round(t_, 3) for t_ in upd_ms]}; "
                  f"finalize vs ata_full(a) {e_:.3e} (<= 1e-5)")
            assert e_ <= 1e-5, (s_, e_)
            distributed["schemes"][s_]["stream"] = {
                "update_ms": upd_ms, "vs_ata_full": e_,
                "launches": got[ATA]}
            del state, fin, new
        del d_parts, c_full
    finally:
        dist.destroy_process_group()
    distributed["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 4k: {distributed['phase_s']:.1f} s")

    # -- 4l. autotune on the card --------------------------------------------
    from repro_torch.gram import autotune as at
    from repro_torch.obs import metrics as obs_metrics
    bucket = at.bucket_shape(n, n)
    print(f"== 4l. autotune: the ata bucket {bucket} of A {n} x {n}, "
          f"measured on the card")
    t_phase = time.perf_counter()
    hits = obs_metrics.counter("gram_autotune_cache_total")

    def lookup_us(reps=2000):
        """The host cost, in microseconds, of the block defaults an entry
        point reads (``ops._resolve_blocks``: the hook's answer, re-read
        from the file at most once a second) and of one ``at.lookup``
        (a stat of the cache file, every call)."""
        out = []
        for fn in (lambda: ops._resolve_blocks("ata", n, n, f32, dev,
                                               bk=None, bn=None),
                   lambda: at.lookup(n, n, kind="ata")):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            out.append((time.perf_counter() - t0) / reps * 1e6)
        return out

    miss_us = lookup_us()
    assert ops._resolve_blocks("ata", n, n, f32, dev, bk=None, bn=None) == \
        {"bk": DEFAULT_BLOCK, "bn": DEFAULT_BLOCK}
    cands = at.candidate_space(*bucket, kind="ata")
    fused_c = sorted((c_ for c_ in cands if c_["mode"] == "fused"),
                     key=lambda c_: at.model_score(*bucket, c_))
    knobs = ("levels", "variant", "gram", "bk", "bn", "pipeline_depth")
    top3 = [{k_: c_[k_] for k_ in knobs} | {
        "model_bytes": at.model_score(*bucket, c_)} for c_ in fused_c[:3]]
    print(f"  {len(cands)} candidates ({len(fused_c)} fused); the model's "
          f"top 3: {top3}")
    reset_counts()
    t0 = time.perf_counter()
    entry = at.autotune(n, n, kind="ata", measure=True)
    tune_s = time.perf_counter() - t0
    print(f"  autotune(measure=True): {tune_s:.1f} s; winner "
          f"{ {k_: entry[k_] for k_ in ('mode', *knobs)} }, measured "
          f"{entry['measured_s'] * 1e3:.3f} ms at {bucket}")
    autotune = {"bucket": list(bucket), "candidates": len(cands),
                "model_top3": top3, "winner": entry, "tune_s": tune_s,
                "lookup_miss_us": miss_us}
    if entry["mode"] != "fused":
        # the blocks the kernel's entry points read come from a fused
        # winner: the fused candidates' own contest
        t0 = time.perf_counter()
        entry = at.autotune(n, n, kind="ata", measure=True,
                            modes=("fused",), refresh=True)
        autotune["fused_tune_s"] = time.perf_counter() - t0
        autotune["fused_winner"] = entry
        print(f"  the fused candidates alone: {autotune['fused_tune_s']:.1f} "
              f"s; winner { {k_: entry[k_] for k_ in knobs} }, measured "
              f"{entry['measured_s'] * 1e3:.3f} ms")
    before = hits.value(outcome="hit")
    c_tuned = ops.ata_fused(a)
    assert hits.value(outcome="hit") == before + 1
    got = read_counts("autotune and ops.ata_fused(a) with the tuned blocks")
    autotune["launches"] = {"ata": got[ATA], "matmul": got[MATMUL]}
    tuned = {k_: entry[k_] for k_ in ("bk", "bn")}
    hit_us = lookup_us()
    c_256 = ops.ata_fused(a, bk=DEFAULT_BLOCK, bn=DEFAULT_BLOCK)
    e_ = _rel(c_tuned, c_256.double())
    tuned_ms, _ = _time_ms(lambda: ops.ata_fused(a))
    d_ms, _ = _time_ms(lambda: ops.ata_fused(a, bk=DEFAULT_BLOCK,
                                             bn=DEFAULT_BLOCK))
    print(f"  ops.ata_fused(a) hit the cache: blocks {tuned}, vs the "
          f"{DEFAULT_BLOCK}-block result {e_:.3e} (<= 1e-5); {tuned_ms:.3f} "
          f"ms against {d_ms:.3f} at {DEFAULT_BLOCK}; on the host, an entry "
          f"point's block defaults {miss_us[0]:.2f} us (miss), "
          f"{hit_us[0]:.2f} us (hit), one at.lookup {miss_us[1]:.2f} us "
          f"(miss), {hit_us[1]:.2f} us (hit)")
    assert e_ <= 1e-5, e_
    del c_tuned, c_256
    assert at.invalidate(n, n, kind="ata")
    assert ops._resolve_blocks("ata", n, n, f32, dev, bk=None, bn=None) == \
        {"bk": DEFAULT_BLOCK, "bn": DEFAULT_BLOCK}
    autotune.update(tuned_blocks=tuned, vs_default=e_, tuned_ms=tuned_ms,
                    default_ms=d_ms, lookup_hit_us=hit_us,
                    phase_s=time.perf_counter() - t_phase)
    print(f"  phase 4l: {autotune['phase_s']:.1f} s")

    # -- 5. times -------------------------------------------------------------
    print("== 5. times (CUDA events, median of 5 after 2 warm-ups)")
    print(f"card: {smi}")

    def time_kind(spec, left, right, seed=None):
        spec1 = dataclasses.replace(spec, pipeline_depth=1)
        ms, runs = _time_ms(lambda: sf.leaf_program(spec, left, right, f32,
                                                    seed=seed))
        ms1, runs1 = _time_ms(lambda: sf.leaf_program(spec1, left, right, f32,
                                                      seed=seed))
        plain_ms, _ = _time_ms(lambda: plain(spec, left, right, f32, seed),
                               reps=1, warmup=0)
        gram = f" ({spec.gram} gram)" if spec.kind in ("ata", "aat",
                                                        "rank_k") else ""
        print(f"{spec.kind} kind{gram} in {mode(spec)} "
              f"L{spec.levels} {tuple(left.shape)} x "
              f"{tuple(right.shape)} depth {spec.pipeline_depth}: {ms:.3f} ms "
              f"(runs {runs}); depth 1: {ms1:.3f} ms (runs {runs1}); plain "
              f"executor, once: {plain_ms:.3f} ms")
        return ms, ms1, plain_ms

    def roofline(label, flops, io_bytes, peak=PEAK_FP32_FLOPS):
        """The larger of the flops at the ``peak`` rate (fp32 CUDA cores by
        default) and the bytes at the HBM rate; returns (bound_ms,
        bound_by)."""
        ops_ms = flops / peak * 1e3
        bytes_ms = io_bytes / PEAK_HBM_BYTES * 1e3
        print(f"{label} bound: {flops:.4e} flops at {peak:.3g} "
              f"FLOP/s -> {ops_ms:.3f} ms; inputs+outputs once "
              f"{io_bytes:.4e} B at {PEAK_HBM_BYTES:.3g} B/s -> "
              f"{bytes_ms:.3f} ms; bound_ms {max(ops_ms, bytes_ms):.3f}")
        return max(ops_ms, bytes_ms), \
            "operations" if ops_ms >= bytes_ms else "bytes"

    def bound(kind, flops_leaf, flops_classical, io_bytes, spec):
        own = sf.product_flops(spec)
        print(f"{kind}: the least flops are min(leaf products once "
              f"{flops_leaf:.4e}, classical {flops_classical:.4e}); not in "
              f"the bound, the kernel's own flops (each leaf product once) "
              f"{own:.4e} -> {own / PEAK_FP32_FLOPS * 1e3:.3f} ms")
        return roofline(kind, min(flops_leaf, flops_classical), io_bytes)

    def tiles(spec, left, right, seed=None):
        """leaf_products at each block tile: its time, blocks, blocks an SM
        holds at once and waves on the card's SMs."""
        out = {}
        for tile in sf.PRODUCT_TILES:
            shape = sf.products_launch_shape(spec, left.dtype, right.dtype,
                                             tile)
            ms, runs = _time_ms(lambda: sf.leaf_program(
                spec, left, right, f32, seed=seed, tile=tile))
            waves = shape["positions"] / (SMS * shape["blocks_per_sm"])
            print(f"  {spec.kind} ({spec.gram} gram) tile {tile}: {ms:.3f} ms "
                  f"(runs {runs}); {shape['positions']} positions, "
                  f"{waves:.2f} waves at {shape['blocks_per_sm']} blocks an "
                  f"SM on {SMS} SMs, "
                  f"{shape['positions'] - shape['whole_positions']} of them "
                  f"walked in quarters, {shape['blocks']} blocks"
                  f"{' of mirror pairs' if shape['pair'] else ''}, "
                  f"{shape['smem_bytes']} B of shared memory a block")
            out[tile] = {"ms": ms, "waves": waves, **shape}
        return out

    def kernel_entry(name, source, replaces, launches, err, ms, plain_ms,
                     bound_ms, bound_by, library_ms, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, **extra, "card": smi}

    def entry(spec, *args, **extra):
        return kernel_entry(
            "leaf_program", PRODUCTS_SOURCE, REPLACES.format(spec.kind),
            *args, kind=spec.kind, library="leaf_products",
            **({"gram": spec.gram} if spec.kind in ("ata", "aat", "rank_k")
               else {}), **extra)

    kernels = []

    # ata at the main path: tril(A^t A), levels 2
    spec, ap = sf._prepare_ata(a, DEFAULT_LEVELS, "strassen", "strassen",
                               DEFAULT_BLOCK, DEFAULT_BLOCK,
                               pipeline_depth=depth)
    ms, ms1, plain_ms = time_kind(spec, ap, ap)
    ata_tiles = tiles(spec, ap, ap)
    lib_ms, lib_runs = _time_ms(lambda: torch.tril(a.T @ a))
    e2e_ms, e2e_runs = _time_ms(lambda: ata(a))
    print(f"torch.tril(a.T @ a) fp32: {lib_ms:.3f} ms (runs {lib_runs}); "
          f"ata(a) end to end (pad, kernel, unpack to dense): {e2e_ms:.3f} "
          f"ms (runs {e2e_runs})")
    prog = compile_program("ata", spec.levels, spec.variant, gram=spec.gram)
    ata_least = 2 * prog.mult_count(spec.n_k * spec.bc, spec.q_i * spec.bi)
    ata_io = (ap.numel() * ap.element_size()
              + spec.n_out * spec.bi * spec.bj * 4)
    bound_ms, bound_by = bound("ata", ata_least, n * n * (n + 1), ata_io,
                               spec)
    kernels.append(entry(spec, launches["leaf_products.cu/ata"],
                         max_abs_err, ms, plain_ms, bound_ms, bound_by,
                         lib_ms, ms_depth1=ms1, ata_e2e_ms=e2e_ms,
                         product_flops=sf.product_flops(spec),
                         tiles=ata_tiles, shape=[n, n]))
    del ap
    # the dps gram's ata, whose transposed destinations run in pair mode:
    # its own row, against the same function's bound; its aat and rank_k
    # timed beside it
    spec, ap = sf._prepare_ata(a, DEFAULT_LEVELS, "strassen", "dps",
                               DEFAULT_BLOCK, DEFAULT_BLOCK,
                               pipeline_depth=depth)
    ms, ms1, plain_ms = time_kind(spec, ap, ap)
    dps_tiles = tiles(spec, ap, ap)
    e2e_ms, e2e_runs = _time_ms(lambda: ata(a, gram="dps"))
    print(f"ata(a, gram='dps') end to end: {e2e_ms:.3f} ms (runs "
          f"{e2e_runs})")
    live = sf.live_steps(spec) * 2 * spec.bi * spec.bj * spec.bc
    print(f"ata (dps gram): the TPU kernel's walk would do {live:.4e} "
          f"live-step flops, each product once per destination it feeds")
    bound_ms, bound_by = bound("ata (dps gram)", ata_least, n * n * (n + 1),
                               ata_io, spec)
    del ap
    dspec, dap = sf._prepare_aat(a, DEFAULT_LEVELS, "strassen", "dps",
                                 DEFAULT_BLOCK, DEFAULT_BLOCK,
                                 pipeline_depth=depth)
    aat_dps_ms, aat_dps_ms1, _ = time_kind(dspec, dap, dap)
    del dap
    rk_dps, rk_dps_x = sf._prepare_rank_k(stack, chunk, DEFAULT_LEVELS,
                                          "strassen", "dps", DEFAULT_BLOCK,
                                          pipeline_depth=depth)
    rk_dps_ms, rk_dps_ms1, _ = time_kind(rk_dps, rk_dps_x, rk_dps_x,
                                         seed=stack)
    kernels.append(entry(spec, dps_launches, dps_err, ms, plain_ms, bound_ms,
                         bound_by, lib_ms, ms_depth1=ms1, e2e_ms=e2e_ms,
                         product_flops=sf.product_flops(spec),
                         live_step_flops=live, tiles=dps_tiles,
                         aat_ms=aat_dps_ms, aat_ms_depth1=aat_dps_ms1,
                         rank_k_ms=rk_dps_ms, rank_k_ms_depth1=rk_dps_ms1,
                         rank_k_product_flops=sf.product_flops(rk_dps),
                         shape=[n, n]))
    del rk_dps_x

    # symm at the main path's backward: dA = A (S + S^t), levels 2
    sspec, xp, sp = sf._prepare_symm(a, s_main, DEFAULT_LEVELS, "strassen",
                                     DEFAULT_BLOCK, True,
                                     pipeline_depth=depth)
    ms, ms1, plain_ms = time_kind(sspec, xp, sp)
    symm_tiles = tiles(sspec, xp, sp)
    s_dense = torch.tril(w)

    def library_symm():
        with torch.no_grad():
            return a @ (s_dense + s_dense.T)
    lib_ms, lib_runs = _time_ms(library_symm)
    x = a.clone().requires_grad_()
    loss = (w * ata(x)).sum()
    bwd_ms, bwd_runs = _time_ms(
        lambda: torch.autograd.grad(loss, x, retain_graph=True))
    del x, loss, s_dense
    print(f"a @ (s + s.T) fp32, the add included: {lib_ms:.3f} ms (runs "
          f"{lib_runs}); backward of ata(a) end to end (pack, pad, kernel; "
          f"forward done): {bwd_ms:.3f} ms (runs {bwd_runs})")
    sprog = compile_program("symm", sspec.levels, sspec.variant)
    M, N = xp.shape
    bound_ms, bound_by = bound(
        "symm", 2 * sprog.mult_count(M // sprog.blocks_m, N // sprog.blocks_n),
        2 * n * n * n,
        xp.numel() * xp.element_size() + sp.numel() * sp.element_size()
        + M * N * 4, sspec)
    print(f"symm configurations checked on the backward: {symm_cfgs}")
    kernels.append(entry(sspec, bwd_launches[SYMM], symm_err, ms, plain_ms,
                         bound_ms, bound_by, lib_ms, ms_depth1=ms1,
                         bwd_e2e_ms=bwd_ms, peak_bwd_bytes=peaks,
                         product_flops=sf.product_flops(sspec),
                         tiles=symm_tiles, shape=[M, N]))
    del xp, sp

    # aat at the main path: tril(A A^t), levels 2
    spec, ap = sf._prepare_aat(a, DEFAULT_LEVELS, "strassen", "strassen",
                               DEFAULT_BLOCK, DEFAULT_BLOCK,
                               pipeline_depth=depth)
    ms, ms1, plain_ms = time_kind(spec, ap, ap)
    aat_tiles = tiles(spec, ap, ap)
    lib_ms, lib_runs = _time_ms(lambda: torch.tril(a @ a.T))
    e2e_ms, e2e_runs = _time_ms(lambda: ata(a, gram_of="rows"))
    print(f"torch.tril(a @ a.T) fp32: {lib_ms:.3f} ms (runs {lib_runs}); "
          f"ata(a, gram_of='rows') end to end: {e2e_ms:.3f} ms (runs "
          f"{e2e_runs})")
    prog = compile_program("aat", spec.levels, spec.variant, gram=spec.gram)
    bound_ms, bound_by = bound(
        "aat", 2 * prog.mult_count(spec.q_i * spec.bi, spec.n_k * spec.bc),
        n * (n + 1) * n,
        ap.numel() * ap.element_size() + spec.n_out * spec.bi * spec.bj * 4,
        spec)
    kernels.append(entry(spec, aat_launches[AAT], aat_err, ms, plain_ms,
                         bound_ms, bound_by, lib_ms, ms_depth1=ms1,
                         e2e_ms=e2e_ms, product_flops=sf.product_flops(spec),
                         tiles=aat_tiles, shape=[n, n]))
    del ap

    # rank_k: one chunk of the streamed update into the T-tile stack
    ms, ms1, plain_ms = time_kind(rk_spec, rk_x, rk_x, seed=stack)
    rk_tiles = tiles(rk_spec, rk_x, rk_x, seed=stack)
    chunk_pad = n_pad - n

    def library_rank_k(st):
        g = torch.tril(chunk.T @ chunk)
        return st + pack_tril_blocks(F.pad(g, (0, chunk_pad, 0, chunk_pad)),
                                     DEFAULT_BLOCK)
    lib_ms, lib_runs = _time_ms(lambda: library_rank_k(stack))
    print(f"torch.tril(c.T @ c) plus the packed add fp32: {lib_ms:.3f} ms "
          f"(runs {lib_runs})")
    prog = compile_program("rank_k", rk_spec.levels, rk_spec.variant,
                           gram=rk_spec.gram)
    stack_bytes = stack.numel() * stack.element_size()
    bound_ms, bound_by = bound(
        "rank_k",
        2 * prog.mult_count(rk_spec.n_k * rk_spec.bc,
                            rk_spec.q_i * rk_spec.bi),
        rows * n * (n + 1),
        rk_x.numel() * rk_x.element_size() + 2 * stack_bytes, rk_spec)
    kernels.append(entry(rk_spec, rk_launches[RANK_K], rank_k_err, ms,
                         plain_ms, bound_ms, bound_by, lib_ms, ms_depth1=ms1,
                         product_flops=sf.product_flops(rk_spec),
                         tiles=rk_tiles, shape=[rows, n], stack_tiles=T))
    del rk_x, stack

    # matmul at the main path: a @ b and a^t @ b, levels 2
    spec, ap, bp = sf._prepare_matmul(a, b, DEFAULT_LEVELS, "strassen",
                                      DEFAULT_BLOCK, DEFAULT_BLOCK,
                                      DEFAULT_BLOCK, pipeline_depth=depth)
    ms, ms1, plain_ms = time_kind(spec, ap, bp)
    matmul_tiles = tiles(spec, ap, bp)
    tspec, tap, tbp = sf._prepare_matmul(a, b, DEFAULT_LEVELS, "strassen",
                                         DEFAULT_BLOCK, DEFAULT_BLOCK,
                                         DEFAULT_BLOCK, True, False,
                                         pipeline_depth=depth)
    t_ms, _ = _time_ms(lambda: sf.leaf_program(tspec, tap, tbp, f32))
    lib_ms, lib_runs = _time_ms(lambda: a @ b)
    t_lib_ms, t_lib_runs = _time_ms(lambda: a.T @ b)
    e2e_ms, e2e_runs = _time_ms(lambda: strassen_matmul(a, b, trans_a=True))
    print(f"matmul kind trans_a depth {depth}: {t_ms:.3f} ms; a @ b fp32: "
          f"{lib_ms:.3f} ms (runs {lib_runs}); a.T @ b fp32: {t_lib_ms:.3f} "
          f"ms (runs {t_lib_runs}); strassen_matmul(a, b, trans_a=True) end "
          f"to end: {e2e_ms:.3f} ms (runs {e2e_runs})")
    prog = compile_program("matmul", spec.levels, spec.variant)
    M, K = ap.shape
    N = bp.shape[1]
    bound_ms, bound_by = bound(
        "matmul",
        2 * prog.mult_count(M // prog.blocks_m, N // prog.blocks_n,
                            K // prog.blocks_k),
        2 * n * n * n,
        (ap.numel() + bp.numel()) * ap.element_size() + M * N * 4, spec)
    kernels.append(entry(spec, mm_launches[MATMUL], matmul_err, ms,
                         plain_ms, bound_ms, bound_by, lib_ms, ms_depth1=ms1,
                         ms_trans_a=t_ms, library_ms_trans_a=t_lib_ms,
                         trans_a_e2e_ms=e2e_ms,
                         product_flops=sf.product_flops(spec),
                         tiles=matmul_tiles, shape=[n, n, n]))

    # The single-purpose kernels on the main path's padded operands.
    def time_kernel(label, kernel, plain_fn, library=None):
        ms, runs = _time_ms(kernel)
        plain_ms, _ = _time_ms(plain_fn, reps=1, warmup=0)
        line = (f"{label}: {ms:.3f} ms (runs {runs}); plain version, once: "
                f"{plain_ms:.3f} ms")
        lib_ms = None
        if library is not None:
            lib_ms, lib_runs = _time_ms(library[1])
            line += f"; {library[0]}: {lib_ms:.3f} ms (runs {lib_runs})"
        print(line)
        return ms, plain_ms, lib_ms

    def single(name, ms, plain_ms, lib_ms, flops, io_bytes, **extra):
        bound_ms, bound_by = roofline(name, flops, io_bytes)
        kernels.append(kernel_entry(
            name, *KERNELS[name], path_launches[name],
            0.0 if name in ("combine", "transpose") else leaf_err[name], ms,
            plain_ms, bound_ms, bound_by, lib_ms, **extra))

    def tile_times(label, launch, shape_of):
        """The kernel at each block tile of its core: its time and launch
        shape (``*_launch_shape``); returns the default tile and both."""
        default = shape_of(None)["tile"]
        out = {}
        for tile in _launch.PRODUCT_TILES:
            shape = shape_of(tile)
            t_ms, runs = _time_ms(lambda: launch(tile))
            print(f"  {label} tile {tile}"
                  f"{' (the default)' if tile == default else ''}: "
                  f"{t_ms:.3f} ms (runs {runs}); {shape['blocks']} blocks "
                  f"({shape['tiles']} tiles x {shape['sub_tiles']} "
                  f"sub-tiles), {shape['blocks_per_sm']} blocks an SM, "
                  f"{shape['waves']:.2f} waves on {shape['sms']} SMs, "
                  f"{shape['smem_bytes']} B of shared memory a block")
            out[tile] = {"ms": t_ms, **shape}
        return default, out

    def leaf_row(name, label, launch, plain_fn, flops, io_bytes, library,
                 shape_of, launches, shape):
        """The kernel at the recursion's leaf: its time against its own
        bound, plain version (once) and library call (timed only), at both
        tiles; ``launches``: the path's leaves of this shape, as phase 4f
        asserted them."""
        t_ms, runs = _time_ms(lambda: launch(None))
        p_ms, _ = _time_ms(plain_fn, reps=1, warmup=0)
        l_ms, l_runs = _time_ms(library[1])
        print(f"{name} kernel at the recursion's leaf {label}: {t_ms:.3f} ms "
              f"(runs {runs}); plain version, once: {p_ms:.3f} ms; "
              f"{library[0]}: {l_ms:.3f} ms (runs {l_runs})")
        b_ms, b_by = roofline(f"{name} at the leaf", flops, io_bytes)
        tile, by_tile = tile_times(f"{name} leaf", launch, shape_of)
        return {"shape": shape, "core": shape_of(None)["core"],
                "leaf_launches": launches, "ms": t_ms,
                "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": l_ms, "tile": tile, "tiles": by_tile}

    B = DEFAULT_BLOCK
    ap, bp = ops._pad_to(a, (B, B)), ops._pad_to(b, (B, B))
    N = ap.shape[0]
    T = N // B
    leaf = ops._pad_to(a[:hs, :hs], (B, B))
    leaf_b = ops._pad_to(b[:hs, :hs], (B, B))
    NL = leaf.shape[0]
    # syrk: ops.syrk(a), the kernel on the padded A; the least flops are
    # those of tril(A^t A), each input and output moved once
    ms, plain_ms, lib_ms = time_kernel(
        f"syrk kernel {tuple(ap.shape)} (bk = bn = {B})",
        lambda: k_syrk.syrk_packed(ap, bk=B, bn=B),
        lambda: k_syrk._syrk_packed_plain(ap, B, f32),
        ("torch.tril(a.T @ a) on the same padded A",
         lambda: torch.tril(ap.T @ ap)))
    tile, by_tile = tile_times(
        "syrk", lambda t: k_syrk.syrk_packed(ap, bk=B, bn=B, tile=t),
        lambda t: k_syrk.syrk_launch_shape(N, bn=B, a_dtype=f32,
                                           out_dtype=f32, tile=t))
    syrk_leaf = leaf_row(
        "syrk", f"{tuple(leaf.shape)}",
        lambda t: k_syrk.syrk_packed(leaf, bk=B, bn=B, tile=t),
        lambda: k_syrk._syrk_packed_plain(leaf, B, f32), hs * hs * (hs + 1),
        (leaf.numel() + tri_count(NL // B) * B * B) * 4,
        ("torch.tril(leaf.T @ leaf)", lambda: torch.tril(leaf.T @ leaf)),
        lambda t: k_syrk.syrk_launch_shape(NL, bn=B, a_dtype=f32,
                                           out_dtype=f32, tile=t),
        s_leaves, list(leaf.shape))
    single("syrk", ms, plain_ms, lib_ms, n * n * (n + 1),
           (ap.numel() + tri_count(T) * B * B) * 4,
           core=k_syrk.syrk_launch_shape(N, bn=B, a_dtype=f32,
                                         out_dtype=f32)["core"],
           tile=tile, tiles=by_tile, leaf=syrk_leaf, shape=list(ap.shape))
    # matmul: ops.matmul(a, b), the kernel on the padded operands
    ms, plain_ms, lib_ms = time_kernel(
        f"matmul kernel {tuple(ap.shape)} @ {tuple(bp.shape)} (blocks {B})",
        lambda: k_matmul.matmul_padded(ap, bp, bm=B, bk=B, bn=B),
        lambda: k_matmul._matmul_padded_plain(ap, bp, f32),
        ("a @ b on the same padded operands", lambda: ap @ bp))
    tile, by_tile = tile_times(
        "matmul",
        lambda t: k_matmul.matmul_padded(ap, bp, bm=B, bk=B, bn=B, tile=t),
        lambda t: k_matmul.matmul_launch_shape(
            N, N, bm=B, bn=B, a_dtype=f32, b_dtype=f32, out_dtype=f32,
            tile=t))
    matmul_leaf = leaf_row(
        "matmul", f"{tuple(leaf.shape)} @ {tuple(leaf_b.shape)}",
        lambda t: k_matmul.matmul_padded(leaf, leaf_b, bm=B, bk=B, bn=B,
                                         tile=t),
        lambda: k_matmul._matmul_padded_plain(leaf, leaf_b, f32),
        2 * hs ** 3, 3 * NL * NL * 4, ("leaf @ leaf_b", lambda: leaf @ leaf_b),
        lambda t: k_matmul.matmul_launch_shape(
            NL, NL, bm=B, bn=B, a_dtype=f32, b_dtype=f32, out_dtype=f32,
            tile=t),
        m_leaves + 7 ** DEFAULT_LEVELS, [NL, NL, NL])
    single("matmul", ms, plain_ms, lib_ms, 2 * n * n * n, 3 * N * N * 4,
           core=k_matmul.matmul_launch_shape(N, N, bm=B, bn=B, a_dtype=f32,
                                             b_dtype=f32,
                                             out_dtype=f32)["core"],
           tile=tile, tiles=by_tile, leaf=matmul_leaf, shape=[N, N, N])
    del leaf, leaf_b
    # combine: the seven padded products of one Strassen level
    mp = [ops._pad_to(x, (B, B)) for x in prods]
    H = mp[0].shape[0]
    ms, plain_ms, _ = time_kernel(
        f"combine kernel, seven {tuple(mp[0].shape)}",
        lambda: k_combine.strassen_combine(*mp, bm=B, bn=B),
        lambda: k_combine._strassen_combine_plain(*mp))
    single("combine", ms, plain_ms, None, 10 * H * H, 11 * H * H * 4,
           library_note="no single PyTorch call computes the four quadrants",
           shape=[H, H])
    prods16_5 = [x.half() for x in prods]
    del mp, prods
    # transpose: ops.transpose(a), the kernel on the padded A
    ms, plain_ms, lib_ms = time_kernel(
        f"transpose kernel {tuple(ap.shape)}",
        lambda: k_transpose.transpose_padded(ap, bm=B, bn=B),
        lambda: k_transpose._transpose_padded_plain(ap),
        ("a.T.contiguous() on the same padded A",
         lambda: ap.T.contiguous()))
    single("transpose", ms, plain_ms, lib_ms, 0, 2 * N * N * 4,
           shape=[N, N])
    del ap, bp
    # End to end: the recursion on kernel leaves, on torch.matmul leaves,
    # and the fused path.
    e2e = {}
    for label, fn in (
            ("ata(a) on kernel leaves", lambda: ata(a, **hooks)),
            ("ata(a, mode='reference') on torch.matmul leaves",
             lambda: ata(a, mode="reference")),
            ("ata(a), fused", lambda: ata(a)),
            ("strassen_matmul(a, b) on the kernel leaf",
             lambda: strassen_matmul(a, b, base_matmul=hooks["base_matmul"])),
            ("strassen_matmul(a, b, mode='reference') on torch.matmul leaves",
             lambda: strassen_matmul(a, b, mode="reference"))):
        e2e[label], runs = _time_ms(fn)
        print(f"{label}: {e2e[label]:.3f} ms (runs {runs})")
    # the fp16 recursion, timed in phase 4f: its leaves on the tensor cores
    e2e["ata(fp16 a) on kernel leaves (phase 4f)"] = ata16_ms
    kernels[-4]["e2e_ms"] = e2e
    # flash_attention at the serving prefill: a 2048-token prompt over the
    # 2048-slot cache, causal, bf16; the least flops are 4 D for each
    # unmasked (q, k) pair, at the bf16 tensor-core peak
    fq = randn(1, QWEN_HEADS, MAX_SEQ, QWEN_HEAD_DIM, dtype=bf16)
    fk, fv = (randn(1, QWEN_KV_HEADS, MAX_SEQ, QWEN_HEAD_DIM, dtype=bf16)
              for _ in range(2))
    opts = dict(causal=True, window=0, softcap=0.0,
                scale=QWEN_HEAD_DIM ** -0.5)
    ms, plain_ms, lib_ms = time_kernel(
        f"flash_attention kernel q {tuple(fq.shape)}, k/v "
        f"{tuple(fk.shape)}, bf16, causal",
        lambda: k_flash.flash_attention(fq, fk, fv),
        lambda: k_flash._flash_attention_plain(fq, fk, fv, **opts),
        ("F.scaled_dot_product_attention(q, k, v, is_causal=True, "
         "enable_gqa=True)",
         lambda: F.scaled_dot_product_attention(fq, fk, fv, is_causal=True,
                                                enable_gqa=True)))
    dev_ms = _device_ms(lambda: k_flash.flash_attention(fq, fk, fv))
    lib_dev_ms = _device_ms(lambda: F.scaled_dot_product_attention(
        fq, fk, fv, is_causal=True, enable_gqa=True))
    print(f"flash_attention device time a call (20 calls in a CUDA graph, "
          f"replayed): {dev_ms:.4f} ms; SDPA's {lib_dev_ms:.4f} ms")
    # the same prefill's first Sq rows over the cache: how the kernel scales
    # (causal from the top left, so they need only the first Sq kv rows)
    scaling = {}
    for sq in (512, 1024):
        sub = fq[:, :, :sq].contiguous()
        k_ms, _ = _time_ms(lambda: k_flash.flash_attention(sub, fk, fv))
        l_ms, _ = _time_ms(lambda: F.scaled_dot_product_attention(
            sub, fk, fv, is_causal=True, enable_gqa=True))
        sub_dev = _device_ms(lambda: k_flash.flash_attention(sub, fk, fv))
        sub_pairs = sq * (sq + 1) // 2
        sub_bound, _ = roofline(
            f"flash_attention Sq {sq}", QWEN_HEADS * sub_pairs * 4
            * QWEN_HEAD_DIM, (2 * sub.numel() + 2 * fk[:, :, :sq].numel())
            * sub.element_size(), peak=PEAK_BF16_FLOPS)
        sub_lib_dev = _device_ms(lambda: F.scaled_dot_product_attention(
            sub, fk, fv, is_causal=True, enable_gqa=True))
        print(f"flash_attention q (1, 16, {sq}, 128) over k/v (1, 2, 2048, "
              f"128): kernel {k_ms:.4f} ms (device {sub_dev:.4f}), SDPA "
              f"{l_ms:.4f} ms (device {sub_lib_dev:.4f}), bound "
              f"{sub_bound:.4f} ms")
        scaling[sq] = {"ms": k_ms, "device_ms": sub_dev, "library_ms": l_ms,
                       "library_device_ms": sub_lib_dev, "bound_ms": sub_bound}
        del sub
    got = k_flash.flash_attention(fq, fk, fv)
    want = k_flash._flash_attention_plain(fq, fk, fv, **opts)
    err = float((got.float() - want.float()).abs().max())
    errs = (_rel(got, want.double()), _row_rel(got, want))
    print(f"flash_attention at this shape: kernel vs plain max|d| {err:.3e}, "
          f"of max|out| {errs[0]:.3e}, by row {errs[1]:.3e} (<= "
          f"{FLASH_BARS['bfloat16'][0]:.0e}, {FLASH_BARS['bfloat16'][1]:.3e})")
    assert all(e_ <= b_ for e_, b_ in zip(errs, FLASH_BARS["bfloat16"]))
    pairs = MAX_SEQ * (MAX_SEQ + 1) // 2
    bound_ms, bound_by = roofline(
        "flash_attention", QWEN_HEADS * pairs * 4 * QWEN_HEAD_DIM,
        (2 * fq.numel() + 2 * fk.numel()) * fq.element_size(),
        peak=PEAK_BF16_FLOPS)
    kernels.append(kernel_entry(
        "flash_attention", *KERNELS["flash_attention"],
        serve_launches["flash_attention"], max(err, flash_err), ms, plain_ms,
        bound_ms, bound_by, lib_ms, shape=[list(fq.shape), list(fk.shape)],
        dtype="bfloat16", device_ms=dev_ms, library_device_ms=lib_dev_ms,
        by_sq=scaling, serving={
            "arch": cfg.name, "params": n_params, "prompt_lengths": lens,
            "ttft_s": ttft, "prefill_tokens_per_s": prefill_rate,
            "decode_tokens_per_s": st["decode_tokens"] / st["decode_s"],
            "peak_bytes": peak_bytes, "prefill_vs_fp32_plain": prefill_errs,
            "prefill_vs_bf16_plain": plain_errs,
            "prefill_vs_bf16_flash_no_cache": no_pad_errs,
            "planted_faults_vs_bf16_plain": fault_errs,
            "decode_vs_no_cache": e_dec, "fp32_flash_vs_plain": f32_errs,
            "fp32_decode_vs_no_cache": e_dec32,
            "profile": {"prefill_2032": prof_prefill,
                        "decode_tick": prof_decode}}))
    # 16-bit operands at the main path's shapes: syrk and matmul on the
    # tensor cores in fp16 (phase 3l's branches, the fp16 recursion's leaves)
    # and bf16, combine and flash attention in fp16; each bound at the
    # 16-bit tensor-core peak (989 TFLOP/s) or its bytes at two a element,
    # whichever is larger; the yardsticks in the operands' type
    fp16 = torch.float16
    by_name = {k_["name"]: k_ for k_ in kernels if k_["name"] in KERNELS}

    def row16(label, kernel, plain_fn, library, flops, io_bytes, launches,
              bar, dtype=fp16, peak=PEAK_BF16_FLOPS, ref_fn=None, **extra):
        """A 16-bit kernel's time against its bound, plain version and
        library call, and its result (in ``dtype``) against the plain
        version's: ``ref_fn``'s, where given (syrk and matmul: the plain
        version's fp32 result, as phase 3 holds them, so the bar bounds
        the kernel's one rounding; a bf16 element's one-ulp flip is up to
        2^-7 of it), else ``plain_fn``'s."""
        ms, plain_ms, lib_ms = time_kernel(label, kernel, plain_fn, library)
        bound_ms, bound_by = roofline(label, flops, io_bytes, peak=peak)
        got, ref = kernel(), (ref_fn or plain_fn)()
        got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
        assert all(g_.dtype == dtype for g_ in got), label
        err = max(float((g_.float() - r_.float()).abs().max())
                  for g_, r_ in zip(got, ref))
        rel = max(_rel(g_, r_.double()) for g_, r_ in zip(got, ref))
        print(f"  {label}: kernel vs plain max|d| {err:.3e}, of max|out| "
              f"{rel:.3e} (<= {bar:.3e})")
        assert rel <= bar, (label, rel)
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "launches": launches, "max_abs_err": err, **extra}

    rows16 = {}
    for dt in (fp16, bf16):
        short = {fp16: "fp16", bf16: "bf16"}[dt]
        x16, y16 = (ops._pad_to(x.to(dt), (B, B)) for x in (a, b))
        lx16, ly16 = (ops._pad_to(x[:hs, :hs].to(dt), (B, B)) for x in (a, b))
        bar = PRODUCT_BARS[str(dt).removeprefix("torch.")]
        # the main path's launches: fp16's are the fp16 recursion's leaves
        # (phase 4f); bf16 runs on no main path, only in phases 3f and 3g
        path = {k_: path16[k_] if dt == fp16 else 0 for k_ in ("syrk",
                                                              "matmul")}
        extra = {k_: {"phase_3_tensor_launches": tc_launches[(k_, dt)],
                      **({"phase_3l_launches": f16_launches[k_]}
                         if dt == fp16 else {})}
                 for k_ in ("syrk", "matmul")}

        def syrk_shape(n_, t):
            return k_syrk.syrk_launch_shape(n_, bn=B, a_dtype=dt,
                                            out_dtype=dt, tile=t)

        def matmul_shape(n_, t):
            return k_matmul.matmul_launch_shape(n_, n_, bm=B, bn=B,
                                                a_dtype=dt, b_dtype=dt,
                                                out_dtype=dt, tile=t)

        dt_rows = {}
        for name, label, flops, io_bytes, shape_of, launch, plain_in, \
                lib in (
                ("syrk", f"{short} {tuple(x16.shape)}", n * n * (n + 1),
                 (x16.numel() + tri_count(T) * B * B) * 2,
                 lambda t: syrk_shape(N, t),
                 lambda t: k_syrk.syrk_packed(x16, bk=B, bn=B, tile=t),
                 lambda od: k_syrk._syrk_packed_plain(x16, B, od),
                 (f"torch.tril(x.T @ x), {short}",
                  lambda: torch.tril(x16.T @ x16))),
                ("syrk leaf", f"{short} leaf {tuple(lx16.shape)}",
                 hs * hs * (hs + 1),
                 (lx16.numel() + tri_count(NL // B) * B * B) * 2,
                 lambda t: syrk_shape(NL, t),
                 lambda t: k_syrk.syrk_packed(lx16, bk=B, bn=B, tile=t),
                 lambda od: k_syrk._syrk_packed_plain(lx16, B, od),
                 (f"torch.tril(leaf.T @ leaf), {short}",
                  lambda: torch.tril(lx16.T @ lx16))),
                ("matmul", f"{short} {tuple(x16.shape)} @ {tuple(y16.shape)}",
                 2 * n * n * n, 3 * N * N * 2,
                 lambda t: matmul_shape(N, t),
                 lambda t: k_matmul.matmul_padded(x16, y16, bm=B, bk=B, bn=B,
                                                  tile=t),
                 lambda od: k_matmul._matmul_padded_plain(x16, y16, od),
                 (f"x @ y, {short}", lambda: x16 @ y16)),
                ("matmul leaf", f"{short} leaf {tuple(lx16.shape)} @ "
                 f"{tuple(ly16.shape)}", 2 * hs ** 3, 3 * NL * NL * 2,
                 lambda t: matmul_shape(NL, t),
                 lambda t: k_matmul.matmul_padded(lx16, ly16, bm=B, bk=B,
                                                  bn=B, tile=t),
                 lambda od: k_matmul._matmul_padded_plain(lx16, ly16, od),
                 (f"leaf @ leaf_b, {short}", lambda: lx16 @ ly16))):
            kernel = name.split()[0]
            shape = shape_of(None)
            row = row16(f"{kernel} kernel, {label}", lambda: launch(None),
                        lambda: plain_in(dt), lib, flops, io_bytes,
                        path[kernel], bar, dtype=dt,
                        ref_fn=lambda: plain_in(f32), core=shape["core"],
                        tile=shape["tile"],
                        **(extra[kernel] if name == kernel else {}))
            assert shape["core"] == "tensor", (name, shape)
            row["tiles"] = tile_times(f"{kernel} {label}", launch,
                                      shape_of)[1]
            dt_rows[name] = row
        for kernel in ("syrk", "matmul"):
            dt_rows[kernel]["leaf"] = dt_rows.pop(f"{kernel} leaf")
        rows16[dt] = dt_rows
        del x16, y16, lx16, ly16
    mp16 = [ops._pad_to(x, (B, B)) for x in prods16_5]
    combine16 = row16(
        f"combine kernel, seven fp16 {tuple(mp16[0].shape)}",
        lambda: k_combine.strassen_combine(*mp16, bm=B, bn=B),
        lambda: k_combine._strassen_combine_plain(*mp16), None,
        10 * H * H, 11 * H * H * 2, path16["combine"], 0.0,
        peak=PEAK_FP32_FLOPS, phase_3l_launches=f16_launches["combine"],
        library_note="no single PyTorch call computes the four quadrants")
    del mp16, prods16_5
    fq16, fk16, fv16 = (x.half() for x in (fq, fk, fv))
    flash16 = row16(
        f"flash_attention kernel, fp16 q {tuple(fq16.shape)}, k/v "
        f"{tuple(fk16.shape)}, causal",
        lambda: k_flash.flash_attention(fq16, fk16, fv16),
        lambda: k_flash._flash_attention_plain(fq16, fk16, fv16, **opts),
        ("F.scaled_dot_product_attention(q16, k16, v16, is_causal=True, "
         "enable_gqa=True)",
         lambda: F.scaled_dot_product_attention(fq16, fk16, fv16,
                                                is_causal=True,
                                                enable_gqa=True)),
        QWEN_HEADS * pairs * 4 * QWEN_HEAD_DIM,
        (2 * fq16.numel() + 2 * fk16.numel()) * 2, 0,
        FLASH_BARS["float16"][0], phase_3l_launches=f16_launches[
            "flash_attention"], phase_3l_max_abs_err=flash_err16,
        device_ms=_device_ms(lambda: k_flash.flash_attention(fq16, fk16,
                                                             fv16)),
        library_device_ms=_device_ms(
            lambda: F.scaled_dot_product_attention(
                fq16, fk16, fv16, is_causal=True, enable_gqa=True)))
    for name, row in (("syrk", rows16[fp16]["syrk"]),
                      ("matmul", rows16[fp16]["matmul"]),
                      ("combine", combine16), ("flash_attention", flash16)):
        by_name[name]["fp16"] = row
    for name in ("syrk", "matmul"):
        by_name[name]["bf16"] = rows16[bf16][name]
    del fq, fk, fv, got, want, fq16, fk16, fv16

    # The precision axes' libraries at their main-path shapes (phase 4i):
    # each bound counts the stored operand bytes at their own element size;
    # the yardstick is the kind's own, torch.tril(a.T @ a) in fp32.
    lib_ms, lib_runs = _time_ms(lambda: torch.tril(a.T @ a))
    print(f"torch.tril(a.T @ a) fp32: {lib_ms:.3f} ms (runs {lib_runs})")

    def branch(label, spec, left, fp32_ms, seed=None):
        """A branch's time (depth as the main path runs it) and over its
        kind's fp32 one, its plain version's once, its launch shape and its
        bound."""
        ms, runs = _time_ms(lambda: sf.leaf_program(spec, left, left, f32,
                                                    seed=seed))
        plain_ms, _ = _time_ms(lambda: plain(spec, left, left, f32, seed),
                               reps=1, warmup=0)
        shape = sf.products_launch_shape(spec, left.dtype, left.dtype)
        io = left.numel() * left.element_size() \
            + spec.n_out * spec.bi * spec.bj * 4 \
            + (0 if seed is None else seed.numel() * seed.element_size())
        prog = compile_program(spec.kind, spec.levels, spec.variant,
                               gram=spec.gram)
        least = 2 * prog.mult_count(spec.n_k * spec.bc, spec.q_i * spec.bi)
        classical = (rows if spec.kind == "rank_k" else n) * n * (n + 1)
        bound_ms, bound_by = bound(f"{label}", least, classical, io, spec)
        print(f"{label}: {ms:.3f} ms (runs {runs}); plain version, once: "
              f"{plain_ms:.3f} ms; {shape['library']}, tile {shape['tile']}, "
              f"ring depth {shape['ring_depth']}, {shape['blocks']} blocks, "
              f"{shape['blocks_per_sm']} an SM, {shape['smem_bytes']} B of "
              f"shared memory a block")
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms,
                "ms_over_fp32_kind": ms / fp32_ms,
                "launch_shape": shape}

    ata_ms, rk_ms = kernels[0]["ms"], kernels[4]["ms"]
    lowp = {str(od).removeprefix("torch."): branch(
        f"ata kind on {str(od).removeprefix('torch.')} tiles",
        *prec_specs[od], ata_ms) for od in prec_specs}
    rk_lib, _ = _time_ms(lambda: library_rank_k(stack8))
    lowp["rank_k, float8_e4m3fn chunk"] = {
        **branch("rank_k kind on an e4m3fn chunk", rk8_spec, rk8_x, rk_ms,
                 seed=stack8), "library_ms": rk_lib}
    row = lowp["float8_e4m3fn"]
    kernels.append(kernel_entry(
        "leaf_program", PRODUCTS_SOURCE,
        REPLACES.format("ata"), prec_launches["leaf_products_lowp.cu/ata"],
        lowp_err, row["ms"], row["plain_ms"], row["bound_ms"],
        row["bound_by"], row["library_ms"], kind="ata", gram="strassen",
        library="leaf_products_lowp", operand_dtype="float8_e4m3fn",
        rank_k_launches=prec_launches["leaf_products_lowp.cu/rank_k"],
        branches=lowp, shape=[n, n]))
    acc = {"bfloat16": branch("ata kind, bf16 accumulator", bspec, bap,
                              ata_ms),
           "float64": branch("ata kind (fp64 input), fp64 accumulator", fspec,
                             fap, ata_ms)}
    row = acc["bfloat16"]
    kernels.append(kernel_entry(
        "leaf_program", PRODUCTS_SOURCE,
        REPLACES.format("ata"), prec_launches["leaf_products_acc.cu/ata"],
        acc_err, row["ms"], row["plain_ms"], row["bound_ms"],
        row["bound_by"], row["library_ms"], kind="ata", gram="strassen",
        library="leaf_products_acc", acc_dtype="bfloat16", branches=acc,
        quantized_vs_float64=quant_errs, shape=[n, n]))
    del bap, fap, prec_specs, rk8_x, stack8

    # the streamed Gram's launches and times (phase 4j) beside the kinds
    # it ran
    for layout, info in streamed.items():
        row = next(k_ for k_ in kernels if k_.get("kind") == info["kind"]
                   and k_.get("library") == "leaf_products"
                   and k_.get("gram", "strassen") == "strassen")
        row["stream"] = {"layout": layout, **info}

    # -- 6. summary -------------------------------------------------------------
    print(f"chip_smoke.py took {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"distributed": distributed, "autotune": autotune}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
