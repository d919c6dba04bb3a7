"""Meshes of ranks for the distributed Gram schemes.

The port of ``repro/launch/mesh.py``'s ``make_gram_mesh``: a
``torch.distributed`` ``DeviceMesh`` over the default process group's
ranks, with the JAX package's axis names.  Functions only: importing
this module starts no process group.  The caller starts the group
(``torch.distributed.init_process_group``, with its address, world size
and rank: nothing on a host announces a cluster) before building a mesh;
every rank of the group calls :func:`make_gram_mesh`, also a rank the
mesh leaves out, since the mesh's sub-groups are made collectively.

``make_production_mesh`` (the JAX package's 256-chip training mesh)
comes with the training slice (ROADMAP.md Queue 1 #11).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["GRAM_AXES", "make_gram_mesh"]

GRAM_AXES = ("rep", "data", "model")


def make_gram_mesh(n_devices: Optional[int] = None, *, rep: int = 1,
                   ring: Optional[int] = None,
                   ranks: Optional[Sequence[int]] = None,
                   device_type: Optional[str] = None):
    """(rep, data, model) ``DeviceMesh`` for
    ``core.distributed.distributed_gram`` (the names
    ``default_gram_axes`` maps): ``rep`` is the 2.5D replication factor
    (bfs25d), ``ring`` the half-ring / column axis size (default: every
    rank of a replication group), rows take the rest.

    ``ranks`` (default: every rank of the default group, in order) picks
    a subset, and ``n_devices`` keeps its first ``n_devices``, so odd
    factors (rep=3, ring=3, ...) fit a world of 8; a rank outside the
    mesh gets ``mesh.get_coordinate() is None``.  The ranks are laid out
    in their given order, row-major over (rep, data, model).

    ``device_type`` is ``"cuda"`` (the default: the collectives are
    NCCL's, on the card) unless the caller asks for ``"cpu"`` (gloo).
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_gram_mesh needs a process group: call "
            "torch.distributed.init_process_group first")
    device_type = "cuda" if device_type is None else device_type
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: a gram mesh lives on the card; pass "
            "device_type='cpu' for a gloo mesh on the CPU")
    devs = list(range(dist.get_world_size()) if ranks is None else ranks)
    if n_devices is not None:
        devs = devs[:n_devices]
    total = len(devs)
    if rep < 1 or total % rep:
        raise ValueError(f"{total} ranks not divisible by rep={rep}")
    inner = total // rep
    T = inner if ring is None else ring
    if T < 1 or inner % T:
        raise ValueError(f"{inner} ranks per group not divisible by "
                         f"ring={T}")
    rows = inner // T
    grid = torch.tensor(devs[:rep * rows * T], dtype=torch.int).reshape(
        rep, rows, T)
    return DeviceMesh(device_type, grid, mesh_dim_names=GRAM_AXES)
