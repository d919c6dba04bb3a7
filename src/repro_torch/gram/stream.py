"""Online (streaming) Gram accumulation: C += A_chunk^t A_chunk.

The port of the local parts of ``repro/gram/stream.py``.  The paper
frames A^tA as "an intermediate operation during the solution of a wide
set of problems"; in most of those problems A arrives in row chunks
(minibatches, shards, token streams).  Two layouts of the running Gram:

* :class:`GramStream` keeps it in **packed lower-triangular form** —
  n(n+1)/2 words, the paper's storage saving (``core/symmetry.py``) — and
  folds each chunk in through the ATA recursion: on the card the fused
  leaf-program kernel (``ops.ata_fused_packed``, the ata kind) and one
  gather of its tile stack into the element-packed delta (the index
  kept beside the state's buffer); on the CPU, by default, the reference
  recursion (``pack_tril(ata(...))``), since ``mode="auto"`` resolves by
  the state's device (``core.strassen.resolve_mode``).
* :class:`GramStackStream` keeps it as the kernel's packed tile stack and
  folds each chunk in with ONE accumulating launch
  (``ops.rank_k_update``, the rank_k kind): the stack seeds the kernel's
  accumulator, so no delta exists.

A state lives on the device it was made on (``init`` / ``stack_init``
take ``device=``: the card unless the caller asks for the CPU); a chunk
is moved there.  Where no input requires grad, an update adds into the
state in place — the counterpart of the JAX package's buffer donation —
so the state passed in and the one returned share their buffer; where an
input requires grad both layouts work out of place and are
differentiable: the packed update through the ata kind's backward (the
gather's backward scatters into the stack, so no dense n^2 buffer
appears), the stack update through the rank_k kind's.  ``rows`` is a 0-d
int32 tensor beside the state, as in the JAX package, so that the two
packages' checkpoints of a stream match.

Exactness over ragged chunks: ``C = sum_i A_i^t A_i`` for any row
partition of A, so any chunking reproduces the one-shot Gram up to fp32
accumulation-order rounding.

:class:`CheckpointedGramStream` is the crash-recovery layer: the state
committed to a :class:`~repro_torch.checkpoint.CheckpointManager`
directory every ``every`` chunks, in the JAX package's format, so either
package resumes the other's stream.  The sharded and distributed streams
of the JAX package (``sharded_init``, ``update_sharded``,
``distributed_*``) wait for the port's distributed layer.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..core.ata import ata, ata_levels_for
from ..core.strassen import AUTO_MAX_LEVELS, resolve_mode
from ..core.symmetry import (_as_tensor, _tril_gather_index, pack_tril,
                             symmetrize_from_lower, unpack_tril,
                             unpack_tril_blocks)
from ..kernels import ops
from ..obs import metrics as _metrics
from ..obs import trace as _trace

__all__ = ["GramStream", "init", "update", "finalize",
           "GramStackStream", "stack_init", "stack_update", "stack_finalize",
           "CheckpointedGramStream"]


def _in_place(*xs: torch.Tensor) -> bool:
    """Whether an update may write over its state: no input is tracked by
    autograd."""
    return not (torch.is_grad_enabled() and any(x.requires_grad for x in xs))


# Each packed state's gather index (its block edge and the index), kept
# while the state's buffer lives: an in-place update keeps the buffer, so
# a stream builds its index once, and dropping the stream frees it.
_GATHER_INDEX = WeakIdKeyDictionary()


def _gather_index(packed: torch.Tensor, bn: int, n: int) -> torch.Tensor:
    hit = _GATHER_INDEX.get(packed)
    if hit is None or hit[0] != bn:
        hit = _GATHER_INDEX[packed] = (
            bn, _tril_gather_index(bn, n, packed.device))
    return hit[1]


def _levels(levels, m: int, n: int, leaf: int) -> int:
    return (min(ata_levels_for(m, n, leaf), AUTO_MAX_LEVELS)
            if levels == "auto" else levels)


class GramStream(NamedTuple):
    """Running Gram state.

    packed: (n(n+1)/2,) packed lower triangle of the accumulated C.
    rows:   0-d int32, total rows streamed so far (for normalized
            second-moment readings: C / rows).
    """
    packed: torch.Tensor
    rows: torch.Tensor

    @property
    def n(self) -> int:
        # n(n+1)/2 = L  =>  n = (sqrt(8L+1) - 1) / 2
        return (math.isqrt(8 * self.packed.shape[0] + 1) - 1) // 2


def init(n: int, *, dtype=torch.float32, device=None) -> GramStream:
    """Fresh accumulator for an n-column stream on ``device`` (None: the
    card), fp32 by default: the accumulation dtype must not lose bits
    across many chunks."""
    dev = ops.resolve_device(device)
    return GramStream(
        packed=torch.zeros(n * (n + 1) // 2, dtype=dtype, device=dev),
        rows=torch.zeros((), dtype=torch.int32, device=dev))


def update(state: GramStream, chunk, *, levels: Union[int, str] = 2,
           leaf: int = 256, variant: str = "strassen", mode: str = "auto",
           block: Optional[int] = None) -> GramStream:
    """Fold one row chunk in: state.packed += pack_tril(tril(chunk^t chunk)).

    ``chunk`` is (m_chunk, n) with any m_chunk >= 1 (ragged tails fine), a
    tensor on any device or an array.  Kernel knobs mirror ``core.ata``;
    ``block=None`` is ``ops.DEFAULT_BLOCK``.

    Unless an input requires grad, the sum is written over
    ``state.packed``: the returned state shares that buffer, and
    ``state`` itself now holds the new sum, so use only the returned one
    (as the JAX package's donation requires).  The fused branch then
    keeps its gather index (4 bytes an element of the state) beside
    that buffer for the next chunk, and frees it with the buffer.
    """
    chunk = _as_tensor(chunk)
    if chunk.ndim != 2 or state.n != chunk.shape[1]:
        raise ValueError(
            f"chunk shape {tuple(chunk.shape)} does not match stream "
            f"n={state.n}")
    dev = state.packed.device
    chunk = chunk.to(dev)
    m, n = chunk.shape
    in_place = _in_place(state.packed, chunk)
    if resolve_mode(mode, device=dev) == "fused":
        # End to end packed: the kernel's tri-block stack feeds the
        # element-packed state through one gather (as
        # tril_vector_from_blocks), whose backward is a scatter back into
        # the stack, consumed by the ata kind's packed backward: no dense
        # (n, n) buffer either way.
        stack = ops.ata_fused_packed(chunk, levels=_levels(levels, m, n, leaf),
                                     variant=variant, bk=block, bn=block,
                                     out_dtype=state.packed.dtype, device=dev)
        bn = stack.shape[1]
        idx = (_gather_index(state.packed, bn, n) if in_place
               else _tril_gather_index(bn, n, dev))
        delta = stack.reshape(-1).index_select(0, idx)
    else:
        delta = pack_tril(ata(chunk, levels=levels, leaf=leaf,
                              variant=variant, mode=mode,
                              out_dtype=state.packed.dtype, block=block,
                              device=dev))
    if in_place:
        packed = state.packed.add_(delta)
    else:
        packed = state.packed + delta
    return GramStream(packed=packed, rows=state.rows + m)


def finalize(state: GramStream, *, symmetrize: bool = True,
             out_dtype=None, guard: bool = False) -> torch.Tensor:
    """Dense (n, n) Gram from the packed state (mirrored when
    ``symmetrize``, else lower-triangular like ``ata``).

    ``guard=True`` runs the streaming output guards first
    (``gram.verify.check_packed_state``: NaN/Inf scan + diagonal
    nonnegativity on the packed state — the chunks are gone, so no
    Freivalds probe) and raises :class:`~.verify.VerificationError`
    instead of handing corrupted state downstream.
    """
    if guard:
        from .verify import check_packed_state
        check_packed_state(state.packed, state.n)
    c = unpack_tril(state.packed, state.n, symmetrize=symmetrize)
    return c if out_dtype is None else c.to(out_dtype)


# ---------------------------------------------------------------------------
# Rank-k streaming: the state IS the kernel's packed tile stack, and each
# chunk folds in through the accumulating (rank_k) kind of the leaf-program
# kernel, seeded from the stack: one launch a chunk, no delta.
# ---------------------------------------------------------------------------

class GramStackStream(NamedTuple):
    """Running Gram state in the executor's packed tile-stack layout.

    stack: (T(T+1)/2 * block, block) lower-triangular tile stack of the
           accumulated C (``kernels.syrk`` / ``fused_ata_packed``
           ordering; diagonal tiles full).
    rows:  0-d int32, total rows streamed so far.
    """
    stack: torch.Tensor
    rows: torch.Tensor

    @property
    def block(self) -> int:
        return self.stack.shape[1]

    @property
    def n_padded(self) -> int:
        n_tri = self.stack.shape[0] // self.block
        t = (math.isqrt(8 * n_tri + 1) - 1) // 2
        return t * self.block


def stack_init(n: int, *, block: Optional[int] = None, dtype=torch.float32,
               device=None) -> GramStackStream:
    """Fresh rank-k accumulator for an n-column stream on ``device`` (None:
    the card).

    ``block`` is the stack's tile edge, ``ops.DEFAULT_BLOCK`` (256) when
    None until the autotune cache lands (ROADMAP Queue 1 #8); the stack
    spans ``ceil(n / block)`` tiles — padded columns are exact zeros.
    """
    block = ops.DEFAULT_BLOCK if block is None else block
    dev = ops.resolve_device(device)
    t = -(-n // block)
    return GramStackStream(
        stack=torch.zeros((t * (t + 1) // 2 * block, block), dtype=dtype,
                          device=dev),
        rows=torch.zeros((), dtype=torch.int32, device=dev))


def stack_update(state: GramStackStream, chunk, *,
                 levels: Union[int, str] = 2, leaf: int = 256,
                 variant: str = "strassen",
                 block: Optional[int] = None) -> GramStackStream:
    """Fold one row chunk in: ``state.stack += packed(tril(chunk^t chunk))``
    — one accumulating launch, written over the state in place unless an
    input requires grad.

    ``chunk`` is (m_chunk, n) with n <= the stack's padded span.
    ``block`` is the *contraction* tile (rows of the chunk; the output
    tile edge is fixed by the stack).  ``levels`` clamps to depths the
    stack layout divides, like the symm executor.

    As in :func:`update`, an in-place update leaves ``state`` holding the
    new sum in the buffer the returned state shares: use only the
    returned one.
    """
    chunk = _as_tensor(chunk)
    if chunk.ndim != 2 or chunk.shape[1] > state.n_padded:
        raise ValueError(
            f"chunk shape {tuple(chunk.shape)} does not fit stream "
            f"n_padded={state.n_padded}")
    m, n = chunk.shape
    stack = ops.rank_k_update(state.stack, chunk,
                              levels=_levels(levels, m, n, leaf),
                              variant=variant, bk=block,
                              donate=_in_place(state.stack, chunk),
                              device=state.stack.device)
    return GramStackStream(stack=stack, rows=state.rows + m)


def stack_finalize(state: GramStackStream, n: Optional[int] = None, *,
                   symmetrize: bool = True, out_dtype=None,
                   guard: bool = False) -> torch.Tensor:
    """Dense (n, n) Gram from the stacked state (mirrored when
    ``symmetrize``, else lower-triangular like ``ata``).

    ``guard=True`` scans the tile stack for NaN/Inf before unpacking and
    raises :class:`~.verify.VerificationError` on corruption (the
    diagonal check happens on the unpacked dense form below — tile-stack
    indexing of the diagonal is block-size dependent)."""
    from .verify import VerificationError
    if guard and not bool(torch.isfinite(state.stack).all()):
        raise VerificationError(
            "streamed Gram tile stack contains non-finite entries")
    c = torch.tril(unpack_tril_blocks(state.stack, state.n_padded,
                                      state.block, symmetrize=False))
    if guard:
        d = torch.diagonal(c).double()
        scale = float(d.abs().max()) if d.numel() else 0.0
        if not bool((d >= -1e-4 * max(scale, 1.0)).all()):
            raise VerificationError(
                "streamed Gram state has a negative diagonal entry")
    if symmetrize:
        c = symmetrize_from_lower(c)
    if n is not None:
        c = c[:n, :n]
    return c if out_dtype is None else c.to(out_dtype)


# ---------------------------------------------------------------------------
# Crash-recoverable streaming: write-ahead checkpoints of the accumulator.
# ---------------------------------------------------------------------------

class CheckpointedGramStream:
    """A streaming Gram whose state survives the process.

    Wraps :class:`GramStream` (``layout="packed"``) or
    :class:`GramStackStream` (``layout="stack"``) and commits the
    accumulator to a :class:`~repro_torch.checkpoint.CheckpointManager`
    directory every ``every`` chunks — atomic rename commits, so a kill
    at ANY point leaves either the previous or the new checkpoint
    intact, never a torn one.  The commit step number is the count of
    chunks *fully folded in* (write-ahead in the sense that the state on
    disk is always a prefix of the stream: resume never replays a chunk
    into state that already contains it, and never skips one — the
    resumer re-feeds chunks from ``next_chunk`` on).

    Because chunked accumulation is exact over any row partition (module
    docstring) and the resumed state is the *bit-identical* buffer the
    crashed process committed, a resumed run's finalize is bit-exact
    against the uninterrupted run as long as chunks are re-fed at the
    same boundaries (fp addition is order-sensitive; the checkpoint
    preserves the order).  The state lives on ``device`` (None: the
    card); a restored one is placed there.  The checkpoint is the JAX
    package's (``{"packed" | "stack", "rows"}`` and the meta keys
    ``chunks``, ``n``, ``layout``), so either package resumes the other's.

    ::

        s = CheckpointedGramStream(n, workdir, every=4)
        for i, chunk in enumerate(chunks):
            if i < s.next_chunk:      # already folded in pre-crash
                continue
            s.update(chunk)
        c = s.finalize(guard=True)
    """

    def __init__(self, n: int, workdir: str, *, every: int = 1,
                 layout: str = "packed", block: Optional[int] = None,
                 dtype=torch.float32, keep: int = 2,
                 async_save: bool = False, device=None, **update_kw):
        if layout not in ("packed", "stack"):
            raise ValueError(f"layout must be 'packed' or 'stack', "
                             f"got {layout!r}")
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        from ..checkpoint import CheckpointManager
        self.n = n
        self.layout = layout
        self.every = every
        self.update_kw = update_kw
        # sync by default: a streaming WAL wants the commit durable when
        # .commit() returns
        self.manager = CheckpointManager(workdir, keep=keep,
                                         async_save=async_save)
        self.chunks = 0            # chunks fully folded into .state
        self._dirty = 0            # chunks since the last commit
        self.resumed = False
        if layout == "packed":
            self.state = init(n, dtype=dtype, device=device)
        else:
            self.state = stack_init(n, block=block, dtype=dtype,
                                    device=device)
        dev = self.state.rows.device
        with _trace.span("stream_restore", layout=layout):
            restored, meta = self.manager.restore()
        if restored is not None:
            if int(meta.get("n", n)) != n or meta.get("layout") != layout:
                raise ValueError(
                    f"checkpoint in {workdir} holds a "
                    f"{meta.get('layout')} stream of n={meta.get('n')}, "
                    f"not the requested {layout} n={n}")
            rows = restored["rows"].to(dev)
            if layout == "packed":
                self.state = GramStream(packed=restored["packed"].to(dev),
                                        rows=rows)
            else:
                self.state = GramStackStream(
                    stack=restored["stack"].to(dev), rows=rows)
            self.chunks = int(meta["chunks"])
            self.resumed = True

    @property
    def next_chunk(self) -> int:
        """Index of the first chunk NOT yet folded in (resume cursor)."""
        return self.chunks

    def update(self, chunk) -> None:
        """Fold one chunk in; commits every ``every`` chunks."""
        if self.layout == "packed":
            self.state = update(self.state, chunk, **self.update_kw)
        else:
            self.state = stack_update(self.state, chunk, **self.update_kw)
        self.chunks += 1
        self._dirty += 1
        if self._dirty >= self.every:
            self.commit()

    def commit(self) -> None:
        """Force a checkpoint of the current state (no-op when clean)."""
        if self._dirty == 0 and self.manager.latest_step() == self.chunks:
            return
        if self.layout == "packed":
            tree = {"packed": self.state.packed, "rows": self.state.rows}
        else:
            tree = {"stack": self.state.stack, "rows": self.state.rows}
        with _trace.span("stream_commit", chunks=self.chunks,
                         dirty=self._dirty, layout=self.layout):
            self.manager.save(self.chunks, tree,
                              extra={"chunks": self.chunks, "n": self.n,
                                     "layout": self.layout})
        _metrics.counter("gram_stream_commits_total",
                         "checkpoint commits of streamed Gram state").inc(
            layout=self.layout)
        self._dirty = 0

    def finalize(self, *, symmetrize: bool = True, out_dtype=None,
                 guard: bool = False) -> torch.Tensor:
        """Commit any uncheckpointed chunks, then the dense Gram (with
        the output guards when ``guard`` — see ``finalize``)."""
        self.commit()
        self.manager.wait()
        if self.layout == "packed":
            return finalize(self.state, symmetrize=symmetrize,
                            out_dtype=out_dtype, guard=guard)
        return stack_finalize(self.state, self.n, symmetrize=symmetrize,
                              out_dtype=out_dtype, guard=guard)
