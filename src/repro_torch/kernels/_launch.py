"""What the port's single-purpose kernels share around a launch.

The syrk, matmul, combine, transpose and flash-attention kernels are
each one library ``csrc/<name>.cu`` with one plain-C entry
``<name>_launch(..., stream)`` that returns ``cudaGetLastError()``.
Their wrappers check their arguments here, refuse inputs that require
grad (these kernels have no backward), launch on the current stream,
raise on an error and count the launch.  Nothing here builds or loads a
library at import time.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

#: Launches of each kernel, bumped where it is launched and nowhere else
#: (the leaf-program kinds count in ``strassen_fused.KERNEL_LAUNCHES``).
KERNEL_LAUNCHES = {"syrk": 0, "matmul": 0, "combine": 0, "transpose": 0,
                   "flash_attention": 0}

# dtype codes of the C interfaces
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

PTR, INT, LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


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
        raise TypeError(f"the {kernel} kernel takes float32 or bfloat16, "
                        f"got {dtype} for {name}")


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


@functools.cache
def _entry(name: str, argtypes: tuple):
    lib = _build.library(name)
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [*argtypes, PTR]
    fn.restype = INT
    err_string = getattr(lib, f"{name}_error_string")
    err_string.argtypes = [INT]
    err_string.restype = ctypes.c_char_p
    return fn, err_string


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
