"""Build the port's CUDA kernels at first use and load them with ctypes.

Each library is one ``csrc/<name>.cu`` with a plain C interface, compiled
by ``nvcc`` for ``sm_90a`` into ``<repo>/build/<name>-<hash>.so``.  The
hash covers every source under ``csrc/``, so an edited kernel is rebuilt
and a stale library is never loaded.  Nothing here runs at import time:
the CPU tests import the kernels package on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Optional

__all__ = ["build", "library"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _target(name: str) -> pathlib.Path:
    return BUILD_DIR / f"{name}-{_source_hash()}.so"


def build(name: str) -> Optional[str]:
    """Compile ``csrc/<name>.cu`` unless it is built already.  Returns
    the ptxas report of this compile, or None when the library was
    cached."""
    source = CSRC / f"{name}.cu"
    if not source.exists():
        raise KeyError(f"unknown kernel library {name!r}: no {source.name}")
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, target)           # atomic: a reader never sees half
    return proc.stdout


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    build(name)
    return ctypes.CDLL(str(_target(name)))
