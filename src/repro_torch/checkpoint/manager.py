"""Checkpointing: atomic, async, keep-K, device-agnostic.

The port of ``repro/checkpoint/manager.py``, in its format: a checkpoint
written by either package loads in the other.  Layout:
<dir>/step_<n>/state.npz + meta.json, committed by atomic rename of a
".tmp" directory — a crash mid-write never corrupts the latest
checkpoint.  Leaves are stored as host numpy keyed by their path in the
tree ('/'-joined dict keys, ``#i`` for the i-th item of a list or
tuple), bf16 as its uint16 bits under a ``__bf16__`` tag (npz has no
bf16).  The tree is nested dicts, lists and tuples whose leaves are
tensors on any device, numpy arrays or Python scalars; ``None`` holds no
leaf.  Leaves come back as CPU tensors, sequences as lists; the caller
places them (the JAX package's ``shardings`` argument has no counterpart
until the port has meshes).

``save`` snapshots every leaf to host memory that nothing else aliases
before it returns (a tensor the caller then updates in place, as a
streamed Gram state is, cannot reach the file half-updated).  The async
writer runs on one background thread; ``wait()`` joins it (used before
reading a checkpoint back and at shutdown).  Failed async saves are
re-raised on the next call so errors are never silently dropped.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import warnings
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

__all__ = ["CheckpointManager", "save_pytree", "load_pytree"]

_BF16_PREFIX = "__bf16__"


def _flatten(tree: Any, path: Tuple[str, ...] = ()) -> Iterator:
    """(path, leaf) in the order ``jax.tree_util`` walks a tree of dicts
    (keys sorted), lists and tuples; a path part is a dict key or ``#i``."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten(tree[key], path + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _flatten(item, path + (f"#{i}",))
    else:
        yield path, tree


def _host_array(leaf) -> Tuple[np.ndarray, bool]:
    """A host copy of ``leaf`` as numpy, sharing no memory with it, and
    whether it is bf16: npz has no bf16, so such a leaf comes as its
    uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().to("cpu", copy=True)
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.uint16).numpy(), True
        return leaf.numpy(), False
    arr = np.array(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), True
    return arr, False


def _entries(tree: Any) -> Dict[str, np.ndarray]:
    """The npz entries of a tree: path-encoded keys, bf16 tagged."""
    out: Dict[str, np.ndarray] = {}
    for path, leaf in _flatten(tree):
        arr, bf16 = _host_array(leaf)
        out[(_BF16_PREFIX if bf16 else "") + "/".join(path)] = arr
    return out


def save_pytree(tree: Any, file: str) -> None:
    """Flatten (dicts/lists of tensors or arrays) -> npz with path-encoded
    keys."""
    np.savez(file, **_entries(tree))


def _insert(tree: dict, parts, value):
    head = parts[0]
    if len(parts) == 1:
        tree[head] = value
        return
    tree.setdefault(head, {})
    _insert(tree[head], parts[1:], value)


def _listify(node):
    """Convert {'#0':..., '#1':...} dicts back into lists."""
    if not isinstance(node, dict):
        return node
    if node and all(re.fullmatch(r"#\d+", k) for k in node):
        return [_listify(node[f"#{i}"]) for i in range(len(node))]
    return {k: _listify(v) for k, v in node.items()}


def load_pytree(file: str) -> Any:
    """npz -> nested dict/list tree of CPU tensors."""
    tree: dict = {}
    with np.load(file) as data:
        for key in data.files:
            arr = torch.from_numpy(np.array(data[key]))
            if key.startswith(_BF16_PREFIX):
                key = key[len(_BF16_PREFIX):]
                arr = arr.view(torch.bfloat16)
            _insert(tree, key.split("/"), arr)
    return _listify(tree)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- write ------------------------------------------------------------
    def save(self, step: int, state: Any, extra: Optional[dict] = None):
        self.wait()                       # one in-flight save at a time
        if self._error:
            err, self._error = self._error, None
            raise err
        entries = _entries(state)           # snapshot NOW (async-safe)

        def work():
            try:
                self._write(step, entries, extra or {})
            except BaseException as e:       # surfaced on next save/wait
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            if self._error:
                err, self._error = self._error, None
                raise err

    def _write(self, step: int, entries: Dict[str, np.ndarray], extra):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "state.npz"), **entries)
        meta = {"step": step, "time": time.time(), **extra}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)             # atomic commit
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- read -------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name, "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None):
        """Returns (state, meta): the tree as CPU tensors.

        Asking for the *latest* checkpoint (``step=None``) walks back
        over unreadable ones (torn meta.json / bit-rotted npz — the
        atomic-rename commit makes these rare, but a disk can still rot
        a committed directory) with a warning per skip, so a recovering
        process restarts from the newest *intact* state instead of
        dying on the newest directory.  An explicitly requested step
        still raises: the caller asked for that state, silently handing
        back another would be wrong.
        """
        self.wait()
        if step is not None:
            return self._read(step)
        for s in reversed(self.all_steps()):
            try:
                return self._read(s)
            except (OSError, ValueError, KeyError,
                    json.JSONDecodeError) as e:
                warnings.warn(
                    f"checkpoint step_{s:08d} in {self.dir} is unreadable "
                    f"({type(e).__name__}: {e}); falling back to the "
                    f"previous checkpoint", stacklevel=2)
        return None, None

    def _read(self, step: int):
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        state = load_pytree(os.path.join(d, "state.npz"))
        return state, meta
