"""What the port's single-purpose kernels share around a launch.

The syrk, matmul, combine, transpose and flash-attention kernels are
each one library ``csrc/<name>.cu`` with one plain-C entry
``<name>_launch(..., stream)`` that returns ``cudaGetLastError()``.
Their wrappers check their arguments here, refuse inputs that require
grad (these kernels have no backward), launch on the current stream,
raise on an error and count the launch.  The syrk and matmul kernels
share two tile products, one core each: the tensor cores
(``csrc/tile_product_tc.cuh``) for operands of one 16-bit type, the fp32
CUDA cores (``csrc/tile_product.cuh``) for the rest.  Which core a pair
runs, the grid arithmetic and the choice of the block tile are here, in
pure Python.  Nothing here builds or loads a library at import time.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

#: Launches of each kernel, bumped where it is launched and nowhere else
#: (the leaf-program kinds count in ``strassen_fused.KERNEL_LAUNCHES``).
KERNEL_LAUNCHES = {"syrk": 0, "matmul": 0, "combine": 0, "transpose": 0,
                   "flash_attention": 0}

# dtype codes of the C interfaces of the syrk, matmul, combine and
# flash-attention kernels: the element types they take
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: Element types of ``csrc/leaf_products*.cu`` (its ``Dtype``): operand
#: tiles (the first five), the seed stack and the output (fp32, bf16, fp16,
#: fp64).  An fp64 operand is stored as fp32 before the launch.
LEAF_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                    torch.float8_e4m3fn: 3, torch.float8_e5m2: 4,
                    torch.float64: 5}

#: Accumulators of ``csrc/leaf_products*.cu`` (its ``AccCode``), by name.
ACC_CODES = {"float32": 0, "bfloat16": 1, "float64": 2}

PTR, INT, LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

#: Block tiles of the syrk and matmul kernels' two cores: the edge of the
#: output sub-tile one thread block computes (the CUDA cores: 256 threads,
#: 8 x 8 outputs a thread at 128, 4 x 4 at 64; the tensor cores: one
#: consumer warpgroup for each 64 rows of the tile, and a producer warp).
PRODUCT_TILES = (128, 64)

#: The cores of the syrk and matmul kernels: ``csrc/tile_product_tc.cuh``
#: (wgmma) and ``csrc/tile_product.cuh`` (fp32 FMA).
PRODUCT_CORES = ("tensor", "cuda")

#: A block's cost of one k step at each tile, by core.  The CUDA cores:
#: issue slots of a thread, 64 FFMAs at 128; at 64, 16 FFMAs behind 8
#: shared-memory words, which an SM delivers at 32 a clock against 128 FMA
#: lanes, so 32.  The tensor cores: the operand bytes the step moves from
#: L2 into shared memory, 2 x TILE 16-bit elements (the L2 reads, not the
#: wgmma rate, bound a 128 x 128 tile), 512 at 128 and 256 at 64, in
#: units of 256.
STEP_COST = {"cuda": {128: 64, 64: 32}, "tensor": {128: 2, 64: 1}}

_16BIT = (torch.bfloat16, torch.float16)


def product_core(a_dtype, b_dtype) -> str:
    """The core that runs a syrk or matmul launch on operands of these
    types (syrk: A's type twice), as ``core`` in ``csrc/matmul.cu`` and
    ``csrc/syrk.cu`` picks it: ``"tensor"`` when both are bf16 or both
    fp16, ``"cuda"`` for any other pair of fp32, bf16 and fp16.  Fixed by
    the types: a launch the tensor cores refuse raises, it never runs on
    the CUDA cores."""
    for dt in (a_dtype, b_dtype):
        if dt not in DTYPE_CODES:
            raise TypeError(f"the syrk and matmul kernels take float32, "
                            f"bfloat16 or float16, got {dt}")
    return "tensor" if a_dtype == b_dtype and a_dtype in _16BIT else "cuda"


def refuse_grad(kernel: str, *xs: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise RuntimeError(
            f"the {kernel} kernel is forward-only: it has no backward (nor "
            "has the JAX package's Pallas kernel); pass tensors that do not "
            "require grad, or call it under torch.no_grad()")


def check_blocks(kernel: str, **blocks) -> None:
    bad = {k: v for k, v in blocks.items()
           if not isinstance(v, int) or v < 8 or v % 8}
    if bad:
        raise ValueError(f"the {kernel} kernel takes block edges that are "
                         f"positive multiples of 8, got {bad}")


def check_dtype(kernel: str, name: str, dtype: torch.dtype) -> None:
    if dtype not in DTYPE_CODES:
        raise TypeError(f"the {kernel} kernel takes float32, bfloat16 or "
                        f"float16, got {dtype} for {name}")


def device_of(kernel: str, *xs: torch.Tensor) -> torch.device:
    """The one device all of ``xs`` lie on: the CPU (the plain version)
    or a card (the kernel)."""
    device = xs[0].device
    if any(x.device != device for x in xs):
        raise ValueError(f"the {kernel} kernel's operands lie on "
                         f"{sorted({str(x.device) for x in xs})}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the {kernel} kernel runs on cuda or cpu, not "
                         f"{device}")
    return device


def check_pointer(kernel: str, name: str, x: torch.Tensor) -> None:
    """The kernel reads ``x`` by its pointer: it must be contiguous and
    16-byte aligned."""
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"the {kernel} kernel needs a contiguous, 16-byte "
                         f"aligned {name}")


def sub_tile(index: int, bm: int, bn: int, tile: int):
    """Sub-tile ``index`` of a (bm, bn) output tile at ``tile``, as the
    kernels decode it (``tile_product::sub_tile``; the CUDA-core kernels
    take ``blockIdx.y``): its origin (i0, j0) and valid extent (i_lim,
    j_lim), row-major over ``ceil(bn / tile)`` columns of sub-tiles."""
    n_sub_j = -(-bn // tile)
    i0, j0 = (index // n_sub_j) * tile, (index % n_sub_j) * tile
    return i0, j0, min(tile, bm - i0), min(tile, bn - j0)


#: Sub-tile rows of a group in the tensor-core kernels' launch order
#: (``tile_product_tc::RASTER``).
RASTER = 8


def grouped_sub_tile(index: int, n_ti: int, n_tj: int, bm: int, bn: int,
                     tile: int):
    """Block ``index`` (in launch order) of a tensor-core matmul launch
    over (n_ti, n_tj) output tiles of (bm, bn), as ``grouped_sub_tile`` in
    ``csrc/matmul.cu`` decodes it: its output tile (ti, tj) and sub-tile
    (i0, j0, i_lim, j_lim).  The grid of sub-tiles is walked ``RASTER``
    rows at a time, column by column, so the blocks that run at once
    share rows of A and columns of B."""
    n_sub_i, n_sub_j = -(-bm // tile), -(-bn // tile)
    rows, cols = n_ti * n_sub_i, n_tj * n_sub_j
    first = index // (RASTER * cols) * RASTER
    g_rows = min(RASTER, rows - first)
    within = index - first * cols
    gi, gj = first + within % g_rows, within // g_rows
    i0, j0 = gi % n_sub_i * tile, gj % n_sub_j * tile
    return (gi // n_sub_i, gj // n_sub_j, i0, j0, min(tile, bm - i0),
            min(tile, bn - j0))


def product_grid(n_tiles: int, bm: int, bn: int, blocks_per_sm: dict,
                 sms: int, tile: int | None = None, *, core: str) -> dict:
    """How a launch of ``core``'s tile product (one of
    ``PRODUCT_CORES``) over ``n_tiles`` (bm, bn) output tiles fills
    ``sms`` SMs, at ``tile`` or, by default, at the tile the wrappers
    choose; ``blocks_per_sm`` maps each tile to the blocks an SM holds at
    once (0 or less: it cannot launch).

    The choice: the least ``ceil(blocks / sms) * STEP_COST[core][tile]``,
    the busiest SM's blocks at a block's k-step cost (the SM's FMA or
    shared-memory issue rate, or its share of the L2 reads, shared among
    its resident blocks); ties go to the larger tile.  Pure arithmetic:
    the CPU tests run it."""
    if core not in PRODUCT_CORES:
        raise ValueError(f"core is one of {PRODUCT_CORES}, got {core!r}")

    def shape(t):
        per_sm = blocks_per_sm[t]
        sub = -(-bm // t) * -(-bn // t)
        blocks = n_tiles * sub
        return {"tile": t, "core": core, "sub_tiles": sub, "tiles": n_tiles,
                "blocks": blocks, "blocks_per_sm": per_sm, "sms": sms,
                "waves": blocks / (sms * per_sm) if per_sm > 0 else math.inf,
                "cost": math.ceil(blocks / sms) * STEP_COST[core][t]}

    if tile is not None:
        check_tile("tile product", tile)
        return shape(tile)
    fits = [shape(t) for t in PRODUCT_TILES if blocks_per_sm[t] > 0]
    if not fits:
        raise RuntimeError(f"no tile of {PRODUCT_TILES} can launch: "
                           f"blocks an SM {blocks_per_sm}")
    return min(fits, key=lambda s: s["cost"])


def check_tile(kernel: str, tile) -> None:
    if tile is not None and tile not in PRODUCT_TILES:
        raise ValueError(f"the {kernel} kernel takes tile None or one of "
                         f"{PRODUCT_TILES}, got {tile}")


@functools.cache
def entry(name: str, fn: str, argtypes: tuple, restype=INT):
    """The C function ``fn`` of library ``name``, typed."""
    f = getattr(_build.library(name), fn)
    f.argtypes, f.restype = list(argtypes), restype
    return f


def _entry(name: str, argtypes: tuple):
    return (entry(name, f"{name}_launch", (*argtypes, PTR)),
            entry(name, f"{name}_error_string", (INT,), ctypes.c_char_p))


def launch(name: str, argtypes: tuple, *args, device: torch.device) -> None:
    """Call ``<name>_launch(*args, stream)`` on the current stream of
    ``device`` (no synchronisation); raise if the launch failed, else
    count it."""
    fn, err_string = _entry(name, argtypes)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({err_string(err).decode()})")
    KERNEL_LAUNCHES[name] += 1
