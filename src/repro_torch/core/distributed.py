"""Distributed ATA: the paper's ATA-P mapped onto ``torch.distributed``.

The port of ``repro/core/distributed.py``.  Paper (§4): a dynamic MPI
process tree — each complete parallel level of ATA-P fans out to 6
processes (4x ATA + 2x HASA), communicators perform 3 simultaneous
reductions (the two addends of C11, C22, C21), then point-to-point sends
patch C together on the subtree root.

Here the process tree becomes a mesh of ranks (``launch.mesh``'s
``DeviceMesh``, axes ``("rep", "data", "model")``) and the reductions
become collectives over the mesh's axis groups: NCCL on the card, gloo
on the CPU.  Each rank runs its own program on its local shard (where
the JAX package traces one SPMD program under ``shard_map``):

* :func:`gram_allreduce` — paper-faithful.  A is sharded by *rows* over
  ``row_axis``; each rank runs the sequential ATA recursion on its shard
  and one ``all_reduce`` realizes the paper's reduction tree.
* :func:`gram_reducescatter` — the same compute, but the reduction
  (``reduce_scatter_tensor``) leaves C sharded by block-rows.
* :func:`gram_ring` — A sharded by rows *and* columns.  Diagonal blocks
  use ATA (half work), off-diagonal blocks Strassen (the paper's HASA
  role), scheduled as a **half-ring**: C is symmetric, so floor(T/2) hops
  suffice.  Each hop is one ``batch_isend_irecv`` (the send and the
  receive in one batch), started before the previous block's product so
  that the two overlap.
* :func:`gram_bfs25d` — the communication-avoiding 2.5D variant (Ballard
  et al., arXiv:1202.3173): a replication axis ``rep_axis`` of size c
  holds c copies of A, and the half-ring's block tasks are dealt out
  BFS-style over the replication groups — group r takes the ring steps
  ``s = r + 1 + t c``.  Each group skews its copy once (one hop of r + 1
  inside its ring) and then hops by c, so the hops on the critical path
  drop from floor(T/2) to ceil(floor(T/2)/c).  Two ``all_reduce``s, over
  ``rep_axis`` and then ``row_axis``, merge the groups' disjoint block
  stacks into ``gram_ring``'s layout: slots on the rep axis are disjoint
  and hold exact zeros, so the two reductions give the JAX package's one
  ``psum`` over (rep, row).

A block that a rank would discard (the even ring's antipodal duplicate,
a step past floor(T/2), the diagonal outside group 0) is a select on
the rank's own coordinate: its slot holds exact zeros and the product is
not computed, so a non-finite discarded block cannot reach the stack or
a reduction (never a multiply by a mask: 0 * Inf = NaN).

:func:`distributed_gram` is the entry point over a ``DTensor`` (or a
full tensor, the same on every rank, that it cuts into this rank's
shard); ``scheme="auto"`` ranks the feasible schemes with the port's
cost model (``core.cost_model.rank_gram_schemes``).  A CUDA tensor goes
through NCCL on the card and never through the host: a CUDA tensor on a
gloo group, or a CPU tensor on a CUDA mesh, is refused
(:func:`check_backend`).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from .ata import ata_full
from .strassen import strassen_matmul
from .symmetry import symmetrize_from_lower

__all__ = [
    "gram_allreduce", "gram_reducescatter", "gram_ring", "gram_bfs25d",
    "distributed_gram", "ring_layout_coords", "assemble_ring_gram",
    "ring_stack_len", "feasible_schemes", "default_gram_axes",
    "scheme_fallback_chain", "shrink_mesh", "check_backend",
    "SCHEME_LADDER",
]

# Degradation order for the serving layer's scheme fallback: most
# communication-avoiding (and most moving parts) first, the
# paper-faithful single-reduction scheme last — each step rightward
# trades bandwidth optimality for fewer ways to fail (fewer collectives,
# fewer axes involved).
SCHEME_LADDER = ("bfs25d", "ring", "reducescatter", "allreduce")


# ---------------------------------------------------------------------------
# The mesh as this rank sees it
# ---------------------------------------------------------------------------

def _axis_names(mesh) -> tuple:
    """A ``DeviceMesh``'s dim names, or a mesh-like object's
    ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(mesh.axis_names if names is None else names)


def _axis_sizes(mesh) -> dict:
    """Axis name -> size, of a ``DeviceMesh`` (whose ``shape`` is a tuple
    in dim order) or of a mesh-like object whose ``shape`` maps names to
    sizes."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return dict(mesh.shape)
    return dict(zip(names, mesh.shape))


def check_backend(device_type: str, backend: str) -> None:
    """Refuse a tensor that the group's backend would stage through the
    host: a CUDA tensor needs NCCL, a CPU tensor gloo.  A plain check of
    (tensor device type, group backend), so that it holds without a
    card."""
    b = str(backend).lower()
    want = {"cuda": "nccl", "cpu": "gloo"}.get(device_type)
    if want is None:
        raise ValueError(f"the distributed schemes run on cuda or cpu "
                         f"tensors, not {device_type}")
    if want not in b:
        raise ValueError(
            f"a {device_type} tensor on a {backend} group: the schemes "
            f"run a {device_type} tensor through {want} and never stage "
            f"it through the host")


def _coords(mesh) -> dict:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"this rank is not in the mesh "
                         f"{mesh.mesh.tolist()}")
    return dict(zip(_axis_names(mesh), coord))


def _peer(mesh, coords: dict, axis: str, index: int) -> int:
    """The global rank at ``coords`` with ``axis`` moved to ``index``."""
    at = tuple(index if name == axis else coords[name]
               for name in _axis_names(mesh))
    return int(mesh.mesh[at])


def _group(mesh, axis: str, x: torch.Tensor):
    """``axis``'s process group through this rank, checked against the
    tensor it will carry; its group ranks follow the mesh's coordinates
    (what ``reduce_scatter_tensor`` and the shards' placement assume)."""
    group = mesh.get_group(axis)
    check_backend(x.device.type, dist.get_backend(group))
    coords = _coords(mesh)
    along = [_peer(mesh, coords, axis, i)
             for i in range(_axis_sizes(mesh)[axis])]
    if dist.get_process_group_ranks(group) != along:
        raise ValueError(f"the ranks along {axis!r} must increase with the "
                         f"coordinate, got {along}")
    return group


def _hop(x: torch.Tensor, mesh, coords: dict, axis: str,
         shift: int) -> Callable[[], torch.Tensor]:
    """Start one rotation of ``x`` by ``shift`` along ``axis`` (this rank
    sends to the coordinate ``shift`` ahead and receives from the one
    ``shift`` behind, both in one ``batch_isend_irecv``); returns the wait
    that gives the received tensor."""
    size = _axis_sizes(mesh)[axis]
    shift %= size
    if shift == 0:
        return lambda: x
    pos = coords[axis]
    src = x.contiguous()
    buf = torch.empty_like(src)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, _peer(mesh, coords, axis,
                                          (pos + shift) % size)),
        dist.P2POp(dist.irecv, buf, _peer(mesh, coords, axis,
                                          (pos - shift) % size))])

    def wait() -> torch.Tensor:
        for req in reqs:
            req.wait()
        return buf
    wait.sent = src                 # read by the send until it completes
    return wait


def _local_gram(a_local, *, levels, leaf, variant, mode, out_dtype):
    return ata_full(a_local, levels=levels, leaf=leaf, variant=variant,
                    mode=mode, out_dtype=out_dtype, device=a_local.device)


def _block_task(a_local, cur, *, levels, leaf, variant, mode, out_dtype):
    """One off-diagonal block, ``a_local^t cur`` (the paper's HASA role):
    the transpose folded into how the kernel reads ``a_local``."""
    return strassen_matmul(a_local, cur, trans_a=True, levels=levels,
                           leaf=leaf, variant=variant, mode=mode,
                           out_dtype=out_dtype, device=a_local.device)


# ---------------------------------------------------------------------------
# Per-rank bodies (take this rank's *local* shard and the mesh)
# ---------------------------------------------------------------------------

def gram_allreduce(a_local: torch.Tensor, mesh, row_axis: str = "data", *,
                   levels=2, leaf: int = 256, variant: str = "strassen",
                   mode: str = "auto", out_dtype=None) -> torch.Tensor:
    """Paper-faithful: local ATA + one all-reduce over the row axis.

    The local compute goes through the fused leaf program on the card
    (``mode="auto"``; see ``core.ata``).  ``out_dtype`` defaults to the
    *input* dtype here (unlike plain ``ata``): accumulation is fp32 in
    the kernel, but the reduction moves C over the wire, and shipping
    bf16 cells as fp32 would double the paper's bandwidth term.
    Returns the full symmetric C, the same on every rank of the row
    axis."""
    group = _group(mesh, row_axis, a_local)
    c = _local_gram(a_local, levels=levels, leaf=leaf, variant=variant,
                    mode=mode, out_dtype=out_dtype or a_local.dtype)
    dist.all_reduce(c, group=group)
    return c


def gram_reducescatter(a_local: torch.Tensor, mesh, row_axis: str = "data",
                       *, levels=2, leaf: int = 256,
                       variant: str = "strassen", mode: str = "auto",
                       out_dtype=None) -> torch.Tensor:
    """Beyond-paper: local ATA + reduce-scatter; this rank's block-row
    shard (n/R, n) of C, R the row axis's size: the bandwidth term / R
    and no replicated C."""
    group = _group(mesh, row_axis, a_local)
    rows = _axis_sizes(mesh)[row_axis]
    n = a_local.shape[1]
    if n % rows:
        raise ValueError(f"n={n} not divisible by the {row_axis!r} axis "
                         f"({rows})")
    c = _local_gram(a_local, levels=levels, leaf=leaf, variant=variant,
                    mode=mode, out_dtype=out_dtype or a_local.dtype)
    out = c.new_empty((n // rows, n))
    dist.reduce_scatter_tensor(out, c, group=group)
    return out


def gram_ring(a_local: torch.Tensor, mesh, col_axis: str = "model",
              row_axis: Optional[str] = None, *, levels=2, leaf: int = 256,
              variant: str = "strassen", mode: str = "auto",
              out_dtype=None) -> torch.Tensor:
    """Half-ring symmetric gram.

    ``a_local`` is this rank's (rows/R, cols/T) shard of A.  Step 0
    computes the diagonal block with ATA (the paper's symmetric
    recursion, half work); step s rotates the column blocks by one hop
    around ``col_axis`` and computes one off-diagonal block with
    Strassen (the paper's HASA role).  Symmetry halves the ring:
    floor(T/2) hops.

    Returns a stack of local blocks, (floor(T/2)+1, n_loc, n_loc): entry
    s on ring coordinate c is C[c, (c - s) % T] (lower-circulant layout;
    ``ring_layout_coords``), reduced over ``row_axis`` if given.  On an
    even ring the antipodal pair {c, c - T/2} is kept on c < T/2; the
    other rank's slot holds exact zeros.
    """
    check_backend(a_local.device.type, dist.get_backend())
    coords = _coords(mesh)
    T = _axis_sizes(mesh)[col_axis]
    c = coords[col_axis]
    half = T // 2
    out_dtype = out_dtype or a_local.dtype      # wire dtype (gram_allreduce)
    kw = dict(levels=levels, leaf=leaf, variant=variant, mode=mode,
              out_dtype=out_dtype)
    pending = _hop(a_local, mesh, coords, col_axis, 1) if half else None
    blocks = [_local_gram(a_local, **kw)]
    for s in range(1, half + 1):
        cur = pending()
        if s < half:
            # the next hop runs under this step's block product
            pending = _hop(cur, mesh, coords, col_axis, 1)
        if s == half and T % 2 == 0 and c >= half:
            # the antipodal duplicate: exact zeros, never computed
            blocks.append(torch.zeros_like(blocks[0]))
        else:
            blocks.append(_block_task(a_local, cur, **kw))
    stack = torch.stack(blocks) if half else blocks[0].unsqueeze(0)
    if row_axis is not None:
        dist.all_reduce(stack, group=_group(mesh, row_axis, stack))
    return stack


def ring_stack_len(T: int) -> int:
    """Stack entries of the half-ring layout: floor(T/2) + 1."""
    return T // 2 + 1


def gram_bfs25d(a_local: torch.Tensor, mesh, col_axis: str = "model",
                rep_axis: str = "rep", row_axis: Optional[str] = None, *,
                levels=2, leaf: int = 256, variant: str = "strassen",
                mode: str = "auto", out_dtype=None) -> torch.Tensor:
    """Communication-avoiding 2.5D half-ring gram (module docstring).

    ``a_local`` is this rank's (rows/R, cols/T) shard of A, *replicated*
    over ``rep_axis`` (size c).  The diagonal (step 0, ATA) is kept on
    group 0; off-diagonal step s in 1..floor(T/2) (Strassen) belongs to
    group (s - 1) mod c, which reaches its first step with one skewing
    hop of r + 1 along its ring and then advances c hops at a time: each
    group makes ceil(floor(T/2)/c) sequential hops at most, and none
    past its last step.  Each group fills disjoint slots of the stack
    (the others hold exact zeros); one ``all_reduce`` over ``rep_axis``
    merges them, one over ``row_axis`` sums the row shards.  Same layout
    as :func:`gram_ring`, the same on every replication group.
    """
    check_backend(a_local.device.type, dist.get_backend())
    coords = _coords(mesh)
    sizes = _axis_sizes(mesh)
    T, reps = sizes[col_axis], sizes[rep_axis]
    half = T // 2
    r, d = coords[rep_axis], coords[col_axis]
    out_dtype = out_dtype or a_local.dtype
    kw = dict(levels=levels, leaf=leaf, variant=variant, mode=mode,
              out_dtype=out_dtype)
    steps = list(range(r + 1, half + 1, reps))      # this group's ring steps
    pending = _hop(a_local, mesh, coords, col_axis, r + 1) if steps else None
    # slots this group does not own: exact zeros, never computed
    blocks = [_local_gram(a_local, **kw) if r == 0 else None] + \
        [None] * half
    for i, s in enumerate(steps):
        cur = pending()
        if i + 1 < len(steps):
            pending = _hop(cur, mesh, coords, col_axis, reps)
        if not (s == half and T % 2 == 0 and d >= half):    # the antipodal
            blocks[s] = _block_task(a_local, cur, **kw)     # duplicate
    n_loc = a_local.shape[1]
    blocks = [a_local.new_zeros((n_loc, n_loc), dtype=out_dtype)
              if b is None else b for b in blocks]
    stack = torch.stack(blocks) if half else blocks[0].unsqueeze(0)
    dist.all_reduce(stack, group=_group(mesh, rep_axis, stack))
    if row_axis is not None:
        dist.all_reduce(stack, group=_group(mesh, row_axis, stack))
    return stack


def ring_layout_coords(T: int) -> list[tuple[int, int, int, int]]:
    """(device, step, global_block_row, global_block_col) ownership map of
    the half-ring layout, as (c, s, i, j) with (i, j) in the lower
    triangle."""
    coords = []
    half = T // 2
    for dev in range(T):
        for s in range(half + 1):
            if s == half and T % 2 == 0 and dev >= half:
                continue  # masked duplicate
            j = (dev - s) % T
            i, jj = (dev, j) if dev >= j else (j, dev)  # mirror wraps upper
            coords.append((dev, s, i, jj))
    return coords


def assemble_ring_gram(stacks: torch.Tensor, T: int, n: int) -> torch.Tensor:
    """The dense symmetric C from half-ring output.

    ``stacks``: (half+1, n_loc, n) where [:, :, c*n_loc:(c+1)*n_loc] is
    ring coordinate c's block stack (entry s = C[c, (c-s)%T]).
    """
    n_loc = n // T
    c = stacks.new_zeros((n, n))
    half = T // 2
    for dev in range(T):
        for s in range(half + 1):
            if s == half and T % 2 == 0 and dev >= half:
                continue
            blk = stacks[s, :, dev * n_loc:(dev + 1) * n_loc]  # C[dev, j]
            j = (dev - s) % T
            if dev >= j:
                c[dev * n_loc:(dev + 1) * n_loc,
                  j * n_loc:(j + 1) * n_loc] = blk
            else:  # wrapped: this is C[dev, j] with j > dev — mirror it
                c[j * n_loc:(j + 1) * n_loc,
                  dev * n_loc:(dev + 1) * n_loc] = blk.T
    return symmetrize_from_lower(torch.tril(c))


# ---------------------------------------------------------------------------
# Schemes on a mesh: feasibility, ranking, degradation
# ---------------------------------------------------------------------------

def default_gram_axes(mesh) -> dict:
    """Map a mesh onto ``distributed_gram``'s (row, col, rep) axis kwargs
    by the repo's naming convention — "data" rows, "model" ring, "rep"
    replication — falling back to positional order for foreign names."""
    names = list(_axis_names(mesh))
    row = "data" if "data" in names else next(
        (a for a in names if a != "rep"), names[0])
    # never reuse the row axis as the ring axis (a ("model",)-only mesh
    # has row == "model")
    col = "model" if ("model" in names and row != "model") else next(
        (a for a in names if a not in (row, "rep")), None)
    rep = "rep" if "rep" in names else None
    return {"row_axis": row, "col_axis": col, "rep_axis": rep}


def feasible_schemes(m: int, n: int, mesh, *, row_axis: str = "data",
                     col_axis: Optional[str] = None,
                     rep_axis: Optional[str] = None) -> list[str]:
    """Schemes runnable for an (m, n) A on ``mesh`` with the given axes
    (even shards + axis availability)."""
    sizes = _axis_sizes(mesh)
    out = []
    if row_axis in sizes and m % sizes[row_axis] == 0:
        out += ["allreduce"]
        if n % sizes[row_axis] == 0:
            out += ["reducescatter"]
        if col_axis in sizes and n % sizes[col_axis] == 0:
            out += ["ring"]
            if rep_axis in sizes:
                out += ["bfs25d"]
    return out


def _rank_schemes(m: int, n: int, mesh, cands, *, row_axis, col_axis,
                  rep_axis, dtype_bytes: int, out_bytes: int) -> str:
    from . import cost_model
    sizes = _axis_sizes(mesh)
    return cost_model.rank_gram_schemes(
        m, n, rows=sizes.get(row_axis, 1),
        ring=sizes.get(col_axis) if col_axis else None,
        rep=sizes.get(rep_axis) if rep_axis else None,
        dtype_bytes=dtype_bytes, out_bytes=out_bytes,
        schemes=cands)[0].scheme


def scheme_fallback_chain(m: int, n: int, mesh, *, scheme: str = "auto",
                          row_axis: str = "data",
                          col_axis: Optional[str] = None,
                          rep_axis: Optional[str] = None,
                          dtype_bytes: int = 4,
                          out_bytes: Optional[int] = None) -> list[str]:
    """Ordered list of schemes the serving layer should try for an
    (m, n) gram on ``mesh``: the preferred scheme first (the cost-model
    winner under ``scheme="auto"``, else ``scheme`` itself when
    feasible), then every other feasible scheme in ``SCHEME_LADDER``
    order — strictly degrading toward the paper-faithful allreduce.
    Empty when nothing is feasible (callers fall back to local)."""
    feas = feasible_schemes(m, n, mesh, row_axis=row_axis,
                            col_axis=col_axis, rep_axis=rep_axis)
    if not feas:
        return []
    if scheme == "auto":
        head = _rank_schemes(
            m, n, mesh, feas, row_axis=row_axis, col_axis=col_axis,
            rep_axis=rep_axis, dtype_bytes=dtype_bytes,
            out_bytes=out_bytes if out_bytes is not None else dtype_bytes)
    else:
        head = scheme if scheme in feas else None
    chain = [] if head is None else [head]
    chain += [s for s in SCHEME_LADDER if s in feas and s not in chain]
    return chain


def _shrink_axis(sizes: dict, axis: Optional[str]) -> Optional[str]:
    if axis is None:
        if sizes.get("rep", 1) > 1:
            axis = "rep"
        else:
            axis = max(sizes, key=lambda a: sizes[a])
    if sizes.get(axis, 1) <= 1:
        shrinkable = [a for a, s in sizes.items() if s > 1]
        if not shrinkable:
            return None
        axis = max(shrinkable, key=lambda a: sizes[a])
    return axis


def shrink_mesh(mesh, axis: Optional[str] = None):
    """The surviving sub-mesh after losing one slice of ``axis`` (a dead
    replica group): same axis names, ``axis`` one shorter — slice 0 of
    ``axis`` is dropped, mirroring "the failed group's ranks are gone".

    ``axis=None`` picks for least damage: the replication axis when it
    has size > 1 (bfs25d degrades to smaller c — or to plain ring at
    c=1 — with no resharding of the row/col layout), else the largest
    axis.  Returns None when the mesh is a single rank (nothing left to
    shrink — the serving layer goes fully local).  Every rank of the
    default group calls it (the new mesh's groups are made
    collectively).
    """
    from torch.distributed.device_mesh import DeviceMesh
    sizes = _axis_sizes(mesh)
    axis = _shrink_axis(sizes, axis)
    if axis is None:
        return None
    names = _axis_names(mesh)
    ranks = mesh.mesh.narrow(names.index(axis), 1, sizes[axis] - 1)
    return DeviceMesh(mesh.device_type, ranks, mesh_dim_names=names)


# ---------------------------------------------------------------------------
# The entry point: a DTensor (or a full tensor) on a DeviceMesh
# ---------------------------------------------------------------------------

def _placements(mesh, dims: dict) -> list:
    """Shard(tensor dim) on the mesh axes named in ``dims``, Replicate
    on the others."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(dims[name]) if name in dims else Replicate()
            for name in _axis_names(mesh)]


def _local_shard(a, mesh, dims: dict) -> torch.Tensor:
    """This rank's shard of ``a`` sharded as ``dims`` (mesh axis -> tensor
    dim): a ``DTensor``'s local tensor (redistributed first if it lies
    otherwise), or the slice of a full tensor that every rank holds whole.
    Even shards only."""
    from torch.distributed.tensor import DTensor
    sizes = _axis_sizes(mesh)
    shape = tuple(a.shape)
    for name, dim in dims.items():
        if name not in sizes:
            raise ValueError(f"mesh axes {tuple(sizes)} have no {name!r}")
        if shape[dim] % sizes[name]:
            raise ValueError(f"shape {shape}: dim {dim} not divisible by "
                             f"the {name!r} axis ({sizes[name]})")
    if isinstance(a, DTensor):
        want = _placements(mesh, dims)
        if tuple(a.placements) != tuple(want):
            a = a.redistribute(mesh, want)
        return a.to_local()
    a = torch.as_tensor(a)
    coords = _coords(mesh)
    for name, dim in dims.items():
        a = a.chunk(sizes[name], dim)[coords[name]]
    return a


def _wrap(local: torch.Tensor, mesh, dims: dict):
    """``local`` as the ``DTensor`` whose shards lie as ``dims`` says."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, _placements(mesh, dims),
                              run_check=False)


def distributed_gram(a, mesh, *, scheme: str = "allreduce",
                     row_axis: str = "data",
                     col_axis: Optional[str] = None,
                     rep_axis: Optional[str] = None,
                     levels=2, leaf: int = 256, variant: str = "strassen",
                     mode: str = "auto", out_dtype=None,
                     assemble: bool = True):
    """C = A^t A for A sharded over ``mesh`` (a ``DeviceMesh``).

    ``a`` is a ``DTensor`` on ``mesh``, or a full tensor that every rank
    of the mesh holds whole (each keeps its own shard of it).  Every
    rank of the mesh calls this; it returns a ``DTensor`` on ``mesh``.

    scheme:
      "allreduce"      — paper-faithful (rows sharded, all-reduce): C
                         ``Replicate()``.
      "reducescatter"  — C sharded by rows over ``row_axis``
                         (``Shard(0)``).
      "ring"           — rows x cols sharded, half-ring schedule.  With
                         ``assemble`` (testing/solvers) the dense C,
                         ``Replicate()``; without, the circulant block
                         stack (floor(T/2)+1, n/T, n) sharded over
                         ``col_axis`` (``Shard(2)``) — n(n+1)/2-ish
                         storage, no post-processing.
      "bfs25d"         — 2.5D: ring + a replication axis ``rep_axis``
                         that deals the Strassen block tasks out
                         BFS-style across replication groups.  Same
                         output layout as "ring".
      "auto"           — rank the feasible schemes with
                         ``cost_model.rank_gram_schemes`` (bytes moved +
                         message rounds + per-rank flops) and run the
                         cheapest.

    The resolved scheme's work is recorded under the profiler span
    ``gram_dist:<scheme>`` (``torch.profiler.record_function``).
    """
    if scheme == "auto":
        m, n = a.shape
        cands = feasible_schemes(m, n, mesh, row_axis=row_axis,
                                 col_axis=col_axis, rep_axis=rep_axis)
        if not cands:
            raise ValueError(
                f"no feasible scheme for shape {tuple(a.shape)} on mesh "
                f"axes {_axis_sizes(mesh)}")
        size = a.dtype.itemsize
        out_size = size if out_dtype is None else out_dtype.itemsize
        # ring hops ship A (input dtype); reductions ship C (wire dtype —
        # the schemes default out_dtype to the input dtype)
        scheme = _rank_schemes(m, n, mesh, cands, row_axis=row_axis,
                               col_axis=col_axis, rep_axis=rep_axis,
                               dtype_bytes=size, out_bytes=out_size)
    kw = dict(levels=levels, leaf=leaf, variant=variant, mode=mode,
              out_dtype=out_dtype)
    with torch.profiler.record_function(f"gram_dist:{scheme}"):
        if scheme in ("allreduce", "reducescatter"):
            a_local = _local_shard(a, mesh, {row_axis: 0})
            if scheme == "allreduce":
                return _wrap(gram_allreduce(a_local, mesh, row_axis, **kw),
                             mesh, {})
            return _wrap(gram_reducescatter(a_local, mesh, row_axis, **kw),
                         mesh, {row_axis: 0})
        if scheme in ("ring", "bfs25d"):
            if col_axis is None:
                raise ValueError(f"{scheme} scheme needs col_axis")
            if scheme == "bfs25d" and rep_axis is None:
                raise ValueError("bfs25d scheme needs rep_axis")
            a_local = _local_shard(a, mesh, {row_axis: 0, col_axis: 1})
            if scheme == "ring":
                stack = gram_ring(a_local, mesh, col_axis, row_axis, **kw)
            else:
                stack = gram_bfs25d(a_local, mesh, col_axis, rep_axis,
                                    row_axis, **kw)
            stacks = _wrap(stack, mesh, {col_axis: 2})
            if not assemble:
                return stacks       # production: circulant layout, sharded
            T = _axis_sizes(mesh)[col_axis]
            return _wrap(assemble_ring_gram(stacks.full_tensor(), T,
                                            a.shape[1]), mesh, {})
    raise ValueError(f"unknown scheme {scheme!r}")
