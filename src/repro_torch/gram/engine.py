"""GramEngine: slot-based multi-tenant batched A^tA serving.

The port of ``repro/gram/engine.py``: the serving analogue of
``runtime/serving.py``'s continuous-batching KV engine, for the paper's
operation instead of token decode.

* **Bucketing.**  Request shapes are rounded up to power-of-two buckets
  (``gram.autotune.bucket_shape``) — exact for Gram, because zero rows of
  A add nothing to A^tA and zero columns only add zero rows/columns to C
  that are sliced away on completion.
* **Slot batching.**  Each tick drains up to ``slots`` same-bucket
  requests, stacks them (padding the batch with zero matrices when fewer
  are waiting) and runs ONE batched gram over the stack: on the card, one
  launch of ``csrc/leaf_products.cuh`` over every slot
  (``kernels.strassen_fused.BoundGram``, the port of ``jax.vmap`` over
  the fused kernel); on the CPU, the reference recursion slot by slot
  (``core.strassen.resolve_mode``), or with ``mode="fused"`` the
  kernel's plain version.
* **Bounded binding.**  torch compiles nothing: the port's "executable"
  for a ``(bucket, config)`` is the batched program bound to the
  bucket's padded shape (its spec, its op tables on the device and its
  launch geometry), built once and cached.  Because the batch is always
  padded to exactly ``slots`` entries, a mixed trace binds at most once
  per distinct bucket key (``compile_count``).
* **Autotuned per-bucket config.**  On first touch of a bucket the
  engine consults the ``gram.autotune`` JSON cache; a hit overrides
  mode / levels / block for that bucket's program.
* **Mesh-aware distributed routing.**  With ``mesh=`` (a
  ``torch.distributed`` ``DeviceMesh``), buckets whose padded size
  reaches ``dist_threshold`` elements are served through
  ``core.distributed.distributed_gram`` (``dist_scheme``, default
  "auto": the communication cost model picks the scheme per shape);
  small buckets keep the slot-batched local path.

Failure model (DESIGN.md §13), as in the JAX package: output guards
(``gram.verify``: a NaN/Inf scan, the diagonal's sign and, when
``verify`` asks for probes, a Freivalds identity check), bounded retries
with capped exponential backoff from the clean host copy of the
operands, a per-bucket circuit breaker that walks the degradation ladder
(rung 1 quarantines the autotune winner, rung 2 forces the reference
recursion, rung 3 adds ``levels=0``), the distributed scheme fallback
chain and mesh shrink (``runtime.faults`` drills, ``apply_mesh``), and
deadlines.  ``step()`` never propagates an executable exception.

Overload model (DESIGN.md §15): ``submit`` returns a thread-safe
:class:`GramFuture` and decides admission on the spot (bounded global /
per-bucket / per-tenant queues; shed through the future with
:class:`Overloaded`, or ``admission="block"``), a CoDel-style shedder
priced by ``core.cost_model.gram_serve_work``, EDF within a bucket and
weighted fair queuing across tenants; ``start()`` runs the scheduler on
a background thread, ``shutdown()`` fails what is still queued with
:class:`EngineShutdown`.

Flight recorder (DESIGN.md §14): the request lifecycle as spans and
instants through ``obs.trace``, the serving counts in ``obs.metrics``,
and an ``obs.drift.DriftDetector`` fed one wall-clock sample per
successful rung-0 batch.

Where the port differs from the JAX engine, deliberately:

* **No traffic drift channel.**  The JAX engine also observes the HLO
  census of each compiled executable (channel ``"traffic"``); torch has
  no HLO, and the port records no traffic observation until
  ``roofline/`` is ported (ROADMAP.md Queue 1 #11).  The wall channel is
  whole.
* **Staging in CPU tensors.**  Operands are staged in CPU tensors (one
  staging buffer for every bucket, grown to the largest batch and pinned
  when the engine runs on the card) and copied to the device for each
  attempt; retries restart from the clean copy.  The fault hooks poison
  through a numpy copy on the host (bf16 through fp32, exact both ways,
  the poison value rounded to bf16).
* **Synchronized timing.**  A launch returns before the device is done,
  so each attempt synchronizes the engine's stream inside the ladder's
  ``try``: the exec histogram, the drift wall channel and the shedder's
  estimate measure the device's work, and an asynchronous fault is
  charged to its own batch.
* **A multi-rank mesh is SPMD and synchronous.**  Every rank of a
  ``torch.distributed`` mesh is a process of its own, so every rank must
  submit the same trace and serve it through ``step`` /
  ``run_to_completion``; ``start()`` refuses such a mesh (background
  batching depends on timing and would deadlock the collectives).  A
  one-rank mesh serves in both modes.
* **Results** are host numpy arrays, as the JAX engine's are (a bf16
  result as fp32, which holds it exactly).

The engine runs on the card unless ``device="cpu"``.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import CancelledError
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.ata import ata, ata_full, ata_levels_for
from ..core.cost_model import gram_serve_work
from ..core.distributed import (_axis_sizes, default_gram_axes,
                                distributed_gram, feasible_schemes,
                                scheme_fallback_chain, shrink_mesh)
from ..core.strassen import AUTO_MAX_LEVELS, resolve_mode
from ..core.symmetry import _as_tensor, symmetrize_from_lower
from ..kernels import ops as _ops
from ..kernels import strassen_fused as _sf
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..obs.drift import DriftDetector
from ..runtime import faults as _faults
from . import autotune as _autotune
from . import verify as _verify

__all__ = ["GramEngine", "GramRequest", "GramFuture", "BucketHealth",
           "TenantState", "GramServeError", "Overloaded", "EngineShutdown",
           "batched_gram"]


class GramServeError(RuntimeError):
    """A request reached a terminal failure: retry ladder exhausted,
    deadline blown, or the engine shut down under it."""


class Overloaded(GramServeError):
    """Admission control refused (or the CoDel-style controller shed)
    this request — the engine is overloaded.  Raised *through the
    future*, never out of ``submit`` itself, so callers handle sheds and
    serve failures the same way: ``future.result()``."""


class EngineShutdown(GramServeError):
    """The engine was shut down while this request was still queued."""


def _torch_dtype(dt) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype or its name."""
    return dt if isinstance(dt, torch.dtype) \
        else getattr(torch, _sf._dtype_name(dt))


def _resolve_levels(levels, m: int, n: int, leaf: int) -> int:
    """``levels="auto"``'s depth for an (m, n) operand, as ``ata`` takes
    it; an int as it is."""
    if levels == "auto":
        return min(ata_levels_for(m, n, leaf), AUTO_MAX_LEVELS)
    return int(levels)


def _gram_blocks(gram_of: str, m: int, n: int, dtype, device, block):
    """``(b_out, b_k)`` of the fused gram of an (m, n) operand: ``block``,
    or where it is None the autotune cache's, as ``ata`` takes them."""
    if gram_of == "cols":
        bs = _ops._resolve_blocks("ata", m, n, dtype, device, bk=block,
                                  bn=block)
        return bs["bn"], bs["bk"]
    bs = _ops._resolve_blocks("aat", m, n, dtype, device, bm=block,
                              bk=block)
    return bs["bm"], bs["bk"]


def _bind_local(m: int, n: int, *, batch: int, gram_of: str, levels,
                leaf: int, variant: str, mode: str, block, out_dtype,
                dtype, pipeline_depth, operand_dtype, device):
    """The batched gram bound to ``batch`` slots of an (m, n) operand:
    a callable from a ``(batch, m, n)`` stack on ``device`` to its
    ``(batch, g, g)`` lower triangles.  Fused: one launch over the stack
    (:class:`~repro_torch.kernels.strassen_fused.BoundGram`, blocks from
    the autotune cache where ``block`` is None, as ``ata`` takes them);
    reference: the recursion slot by slot."""
    levels = _resolve_levels(levels, m, n, leaf)
    if resolve_mode(mode, device=device) == "fused":
        b_out, b_k = _gram_blocks(gram_of, m, n, dtype, device, block)
        return _sf.BoundGram(
            m, n, batch=batch, gram_of=gram_of, levels=levels,
            variant=variant, b_out=b_out, b_k=b_k, out_dtype=out_dtype,
            dtype=dtype, pipeline_depth=pipeline_depth,
            operand_dtype=operand_dtype, device=device)

    def slot_by_slot(stack: torch.Tensor) -> torch.Tensor:
        return torch.stack([ata(x, gram_of=gram_of, levels=levels, leaf=leaf,
                                variant=variant, mode="reference",
                                out_dtype=out_dtype,
                                operand_dtype=operand_dtype, device=device)
                            for x in stack])
    return slot_by_slot


# batched_gram's bound programs, the least recently used dropped first past
# BOUND_GRAMS_MAX (Shampoo binds about 12: a side of each preconditioned
# path), as the JAX package's jit cache keeps its executables; the binds and
# the hits so far
BOUND_GRAMS_MAX = 32
BOUND_GRAM_COUNTS = {"binds": 0, "hits": 0}
_BOUND_GRAMS: "OrderedDict[tuple, _sf.BoundGram]" = OrderedDict()
_BOUND_GRAMS_LOCK = threading.Lock()


def _bound_gram(K: int, m: int, n: int, *, levels, leaf: int, variant: str,
                block, out_dtype, dtype, device) -> "_sf.BoundGram":
    """:func:`batched_gram`'s fused program for a (K, m, n) stack, bound
    once a key (K, m, n, dtype, out_dtype, levels resolved, variant, the
    block asked for, device) and then taken from the LRU.  As a traced
    ``jax.jit`` keeps what it read, the autotune cache's blocks for a
    ``block`` of None are read where the program is bound."""
    levels = _resolve_levels(levels, m, n, leaf)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (K, m, n, dtype, out_dtype, levels, variant, block, device)
    with _BOUND_GRAMS_LOCK:
        bound = _BOUND_GRAMS.get(key)
        if bound is not None:
            _BOUND_GRAMS.move_to_end(key)
            BOUND_GRAM_COUNTS["hits"] += 1
            return bound
    b_out, b_k = _gram_blocks("cols", m, n, dtype, device, block)
    bound = _sf.BoundGram(m, n, batch=K, gram_of="cols", levels=levels,
                          variant=variant, b_out=b_out, b_k=b_k,
                          out_dtype=out_dtype, dtype=dtype, device=device)
    with _BOUND_GRAMS_LOCK:
        _BOUND_GRAMS[key] = bound
        BOUND_GRAM_COUNTS["binds"] += 1
        while len(_BOUND_GRAMS) > BOUND_GRAMS_MAX:
            _BOUND_GRAMS.popitem(last=False)
    return bound


def batched_gram(blocks, *, levels: Union[int, str] = 1, leaf: int = 256,
                 variant: str = "strassen", mode: str = "auto",
                 block: Optional[int] = None, out_dtype=None,
                 device=None) -> torch.Tensor:
    """Full symmetric Gram of a (K, m, n) stack -> (K, n, n).

    The batched building block of the service layer; also the consumer
    hook for Shampoo's per-block statistics.  On the fused path (the
    card, or ``mode="fused"``) a stack that does not require grad runs
    one batched launch of the leaf-program kernel over every slot (the
    port of the JAX package's ``jax.vmap`` over ``ata_full``); a stack
    that requires grad (with grad mode on) runs one differentiable
    ``ata_full`` a slot, whose backward is the symm kind.  The reference
    path runs ``ata_full`` slot by slot.  ``device`` as in ``ata``.  The
    fused program is bound once a stack shape and configuration and kept
    (:func:`_bound_gram`, counted in ``BOUND_GRAM_COUNTS``).
    """
    blocks = _ops._place(blocks, device)
    if blocks.ndim != 3:
        raise ValueError(f"batched_gram expects (K, m, n), got "
                         f"{tuple(blocks.shape)}")
    K, m, n = blocks.shape
    out_dtype = _sf._promoted(blocks.dtype) if out_dtype is None \
        else _torch_dtype(out_dtype)
    if K == 0:
        return blocks.new_zeros((0, n, n), dtype=out_dtype)
    if not (blocks.requires_grad and torch.is_grad_enabled()) and \
            resolve_mode(mode, device=blocks.device) == "fused":
        return _bound_gram(K, m, n, levels=levels, leaf=leaf,
                           variant=variant, block=block, out_dtype=out_dtype,
                           dtype=blocks.dtype, device=blocks.device)(
                               blocks, symmetrize=True)
    return torch.stack([ata_full(b, levels=levels, leaf=leaf, variant=variant,
                                 mode=mode, out_dtype=out_dtype, block=block,
                                 device=blocks.device) for b in blocks])


class _HostView:
    """A tensor as ``runtime.faults`` reads an array: its shape and size at
    once, its values (a host copy; fp32 for a type numpy lacks, exact)
    only where a fault fires and overwrites a tile."""

    def __init__(self, t: torch.Tensor):
        self.t, self.ndim, self.size = t, t.ndim, t.numel()
        self.shape = tuple(t.shape)

    def __array__(self, dtype=None, copy=None):
        x = self.t.detach().cpu()
        if x.dtype not in (torch.float32, torch.float64, torch.float16):
            x = x.float()
        return x.numpy() if dtype is None else x.numpy().astype(dtype)


def _poison(kind: str, site: str, t: torch.Tensor) -> torch.Tensor:
    """``runtime.faults.poison`` on a tensor: the hook decides (and draws
    its random numbers) exactly as on the JAX package's array of the same
    shape; where it fires, the poisoned host copy comes back in ``t``'s
    type on ``t``'s device.  A new tensor: ``t`` is never written."""
    out, fired = _faults.active().poison(kind, site, _HostView(t))
    if not fired:
        return t
    return torch.from_numpy(out).to(device=t.device, dtype=t.dtype)


def _host_result(c: torch.Tensor) -> np.ndarray:
    """A served result as the JAX engine hands it out: a host numpy array
    (bf16 as fp32, which holds it exactly)."""
    c = c.detach().cpu()
    return (c.float() if c.dtype == torch.bfloat16 else c).numpy()


class GramFuture:
    """Thread-safe handle to one submitted Gram request.

    Terminal exactly once: result delivery, ladder failure, shed and
    cancellation all pass through one atomic claim (``_deliver``), so a
    request is delivered-or-cancelled exactly once — never both, never
    dropped.  ``result()`` re-raises the terminal exception
    (``Overloaded`` for sheds, ``EngineShutdown`` on teardown,
    ``GramServeError`` for ladder/deadline failures,
    ``concurrent.futures.CancelledError`` after a successful
    ``cancel()``).  Done-callbacks run on the delivering thread and must
    not block.
    """

    __slots__ = ("_engine", "_request", "_cond", "_done", "_result",
                 "_exception", "_callbacks")

    def __init__(self, engine: "GramEngine", request: "GramRequest"):
        self._engine = engine
        self._request = request
        self._cond = threading.Condition(threading.Lock())
        self._done = False
        self._result: Optional[np.ndarray] = None
        self._exception: Optional[BaseException] = None
        self._callbacks: List[Callable[["GramFuture"], None]] = []

    @property
    def uid(self) -> int:
        return self._request.uid

    @property
    def request(self) -> "GramRequest":
        return self._request

    def done(self) -> bool:
        with self._cond:
            return self._done

    def cancelled(self) -> bool:
        with self._cond:
            return self._done and isinstance(self._exception,
                                             CancelledError)

    def cancel(self) -> bool:
        """Cancel if still queued.  Returns False when the request is
        already in a batch in flight or terminal — an in-flight request
        is *delivered*, not dropped."""
        return self._engine._cancel(self._request)

    def add_done_callback(self, fn: Callable[["GramFuture"], None]) -> None:
        with self._cond:
            if not self._done:
                self._callbacks.append(fn)
                return
        try:
            fn(self)
        except Exception:
            pass

    def _deliver(self, result=None, exception=None) -> bool:
        """Claim the terminal state; False if someone beat us to it."""
        with self._cond:
            if self._done:
                return False
            self._result, self._exception = result, exception
            self._done = True
            self._cond.notify_all()
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            try:
                cb(self)
            except Exception:
                pass
        return True

    def _wait(self, timeout: Optional[float]) -> None:
        with self._cond:
            if not self._cond.wait_for(lambda: self._done, timeout):
                raise TimeoutError(
                    f"gram request {self.uid} not done after {timeout}s")

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        self._wait(timeout)
        if self._exception is not None:
            raise self._exception
        return self._result

    def exception(self, timeout: Optional[float] = None) \
            -> Optional[BaseException]:
        self._wait(timeout)
        return self._exception


class _OperandRing:
    """Donated ring of host staging buffers for one bucket: request
    operands are copied into a recycled ``(M, N)`` CPU tensor at
    admission, so steady-state serving allocates nothing per request.  A
    buffer is allocated the first time its index is handed out (a ring
    of a large bucket holds gigabytes).  When the ring is exhausted (more
    than ``depth`` requests of one bucket in flight at once) staging
    falls back to a fresh allocation — counted in ``misses``, never an
    error.  All access is under the engine lock."""

    __slots__ = ("bufs", "free", "hits", "misses", "shape", "dtype")

    def __init__(self, depth: int, shape: Tuple[int, int], dtype):
        self.shape, self.dtype = shape, dtype
        self.bufs: List[Optional[torch.Tensor]] = [None] * depth
        self.free = list(range(depth))
        self.hits = 0
        self.misses = 0

    def acquire(self) -> Optional[int]:
        if self.free:
            self.hits += 1
            idx = self.free.pop()
            if self.bufs[idx] is None:
                self.bufs[idx] = torch.empty(self.shape, dtype=self.dtype)
            return idx
        self.misses += 1
        return None

    def release(self, idx: int) -> None:
        self.free.append(idx)


@dataclass
class TenantState:
    """Per-tenant serving accounting + weighted-fair-queuing state.
    ``vtime`` is the tenant's virtual finish time in cost-model work
    units per unit weight — the WFQ currency the scheduler compares
    across buckets."""
    name: str
    weight: float = 1.0
    vtime: float = 0.0
    queued: int = 0
    inflight: int = 0
    submitted: int = 0
    admitted: int = 0
    served: int = 0
    failed: int = 0
    shed: int = 0
    cancelled: int = 0
    deadline_missed: int = 0

    def snapshot(self) -> dict:
        return {"weight": self.weight, "vtime": self.vtime,
                "queued": self.queued, "inflight": self.inflight,
                "submitted": self.submitted, "admitted": self.admitted,
                "served": self.served, "failed": self.failed,
                "shed": self.shed, "cancelled": self.cancelled,
                "deadline_missed": self.deadline_missed}


def _edf_key(r: "GramRequest") -> tuple:
    """Within-bucket scheduling order: priority first, then earliest
    deadline, then FIFO — deadline-less same-priority traffic degrades
    to exactly the old FIFO order."""
    return (-r.priority,
            r.t_deadline if r.t_deadline is not None else math.inf,
            r.t_submit, r.uid)


@dataclass
class GramRequest:
    uid: int
    a: torch.Tensor                   # host copy; padded/stacked at batch time
    shape: Tuple[int, int]
    full: bool                        # symmetric result vs lower triangle
    gram_of: str                      # "cols" (A^tA) | "rows" (AA^t)
    t_submit: float
    deadline_s: Optional[float] = None  # fail fast past t_submit + deadline
    t_done: Optional[float] = None
    result: Optional[np.ndarray] = None
    done: bool = False
    status: str = "pending"           # -> "ok"|"failed"|"shed"|"cancelled"
    error: Optional[str] = None
    attempts: int = 0                 # executable attempts spent on it
    degraded: bool = False            # served below the bucket's first rung
    served_by: Optional[str] = None   # "local" | "local:rungK" | "dist:SCHEME"
    verified: Optional[bool] = None   # output guards ran and passed
    tenant: str = "default"
    priority: int = 0                 # higher runs first within a bucket
    t_deadline: Optional[float] = None  # absolute perf_counter deadline
    running: bool = False             # drained into a batch in flight
    future: Optional["GramFuture"] = None
    ring_slot: Optional[tuple] = None  # (bucket key, ring index) staged in
    operand_dtype: str = "native"     # resolved quantization ("native" off)

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_submit


@dataclass
class BucketHealth:
    """Per-bucket circuit-breaker state (one per executable family)."""
    rung: int = 0                     # current degradation-ladder rung
    consecutive_failures: int = 0
    failures: int = 0
    successes: int = 0
    quarantined: List[str] = field(default_factory=list)  # rung descriptions


# local ladder: 0 = autotuned config, 1 = autotune winner quarantined,
# 2 = the reference recursion, 3 = reference + classical recursion
_LOCAL_MAX_RUNG = 3


class GramEngine:
    """Multi-tenant batched Gram service (see module docstring)."""

    _ids = itertools.count()   # per-process engine label allocator

    def __init__(self, *, slots: int = 4, levels: Union[int, str] = 1,
                 leaf: int = 256, variant: str = "strassen",
                 mode: str = "auto", block: Optional[int] = None,
                 out_dtype=torch.float32, min_bucket: int = 32,
                 use_autotune_cache: bool = True,
                 device=None, mesh=None, dist_scheme: str = "auto",
                 dist_threshold: int = 1 << 21,
                 verify: Union[None, str, int] = "finite",
                 verify_rtol: Optional[float] = None,
                 verify_seed: int = 0,
                 max_retries: int = 3, backoff_s: float = 0.0,
                 max_backoff_s: Optional[float] = 5.0,
                 breaker_threshold: int = 2,
                 history_cap: int = 1024, drift_theta: float = 2.0,
                 drift: Optional[DriftDetector] = None,
                 max_queue: int = 1024,
                 max_queue_per_bucket: Optional[int] = None,
                 admission: str = "shed",
                 block_timeout_s: float = 1.0,
                 deadline_shedding: bool = True,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 tenant_quota: Optional[int] = None,
                 tenant_max_inflight: Optional[int] = None,
                 ring_depth: Optional[int] = None,
                 pipeline_depth: Optional[int] = None,
                 operand_dtype=None):
        self.slots = slots
        self.levels, self.leaf, self.variant = levels, leaf, variant
        self.mode, self.block = mode, block
        self.out_dtype = _torch_dtype(out_dtype)
        self.min_bucket = min_bucket
        self.use_autotune_cache = use_autotune_cache
        # the card unless device="cpu"; on the card the engine's own
        # stream carries every attempt's copies and launches, from any
        # thread, and each attempt synchronizes it
        self.device = _ops.resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        # §16 perf/precision knobs: pipeline_depth None defers to the
        # measured autotune winner (then the kernel's backend default);
        # operand_dtype quantizes every served operand tile (fp8/bf16,
        # fp32 accumulation) and becomes part of the bucket key so
        # quantized and native traffic never share an executable,
        # a guard tolerance, or a drift history.
        self.pipeline_depth = pipeline_depth
        self.operand_dtype = _sf._dtype_name(operand_dtype)
        # distributed routing: buckets of >= dist_threshold elements go to
        # distributed_gram on `mesh` (axis names per default_gram_axes)
        self.mesh = mesh
        self.dist_scheme = dist_scheme
        self.dist_threshold = dist_threshold
        self.dist_axes = default_gram_axes(mesh) if mesh is not None else {}
        self.dist_served = 0
        # failure model knobs: `verify` is None/"off" (no guards),
        # "finite" (NaN/Inf + diagonal scan — the default) or an int k
        # (finite scan + k Freivalds probes per served result)
        if verify in (None, "off", False, 0):
            self._guard_on, self._probes = False, 0
        elif verify == "finite":
            self._guard_on, self._probes = True, 0
        else:
            self._guard_on, self._probes = True, int(verify)
        self.verify_rtol = verify_rtol
        self._verify_rng = np.random.default_rng(verify_seed)
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        # retry backoff is capped even for deadline-less requests —
        # without this, exponential backoff on a deadline_s=None request
        # sleeps unboundedly across retries
        self.max_backoff_s = max_backoff_s
        self.breaker_threshold = max(1, breaker_threshold)
        # -- overload model (DESIGN.md §15) --------------------------------
        if admission not in ("shed", "block"):
            raise ValueError(f"admission must be 'shed' or 'block', got "
                             f"{admission!r}")
        self.admission = admission
        self.max_queue = max(1, max_queue)
        self.max_queue_per_bucket = max_queue_per_bucket
        self.block_timeout_s = block_timeout_s
        self.deadline_shedding = deadline_shedding
        self.tenant_weights = dict(tenant_weights or {})
        self.tenant_quota = tenant_quota
        self.tenant_max_inflight = tenant_max_inflight
        self.ring_depth = ring_depth if ring_depth is not None \
            else 4 * slots
        # one re-entrant lock guards every queue/tenant/counter mutation;
        # the three conditions share it: _work wakes the scheduler,
        # _space wakes blocked submitters, _idle wakes drain()
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._space = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._queued = 0
        self._inflight = 0
        self.queue_peak = 0
        self.shed = 0
        self.cancelled = 0
        self.deadline_missed = 0
        self._tenants: Dict[str, TenantState] = {}
        self._vclock = 0.0               # WFQ system virtual time
        self._rings: Dict[tuple, _OperandRing] = {}
        self._staging: Optional[torch.Tensor] = None   # _clean_stack's
        # CoDel-style shedder currency: exact cost-model leaf products
        # per bucket request, and an EWMA of measured seconds per unit
        self._work_cache: Dict[tuple, float] = {}
        self._sec_per_unit: Optional[float] = None
        self._batch_s: Dict[tuple, float] = {}
        self._uid = itertools.count()
        # bucket key -> FIFO of waiting requests (insertion-ordered so
        # tick scheduling is deterministic)
        self.waiting: "OrderedDict[tuple, List[GramRequest]]" = OrderedDict()
        # finished history is CAPPED: the flight-recorder discipline —
        # stats() reads the metrics histograms, not this buffer, so a
        # long-running service neither grows without bound nor re-sorts
        # its whole past on every scrape
        self.history_cap = max(1, history_cap)
        self.finished: "deque[GramRequest]" = deque(maxlen=self.history_cap)
        self._executables: Dict[tuple, object] = {}
        self._health: Dict[tuple, BucketHealth] = {}
        self._dist_chains: Dict[tuple, List[str]] = {}
        self._mesh_epoch = 0
        self.compile_count = 0
        self.served = 0
        self.failed = 0
        self.degraded_served = 0
        self.retries = 0
        self.guard_failures = 0
        self.mesh_changes = 0
        self.ticks = 0
        # observability: per-engine metric label into the process-wide
        # registry, plus the cost-model drift detector fed one sample per
        # successful rung-0 batch (wall; no traffic channel: module doc)
        self.engine_label = f"e{next(GramEngine._ids)}"
        self.drift = drift if drift is not None \
            else DriftDetector(theta=drift_theta)
        self._drift_pred_cache: Dict[tuple, Optional[float]] = {}
        self._m_requests = _metrics.counter(
            "gram_requests_total", "requests submitted")
        self._m_served = _metrics.counter(
            "gram_served_total", "requests served ok, by served_by")
        self._m_failed = _metrics.counter(
            "gram_failed_total", "requests finished failed")
        self._m_deadline = _metrics.counter(
            "gram_deadline_expired_total", "requests failed on deadline")
        self._m_retries = _metrics.counter(
            "gram_retries_total", "failed executable attempts retried")
        self._m_vetoes = _metrics.counter(
            "gram_guard_vetoes_total", "output-guard vetoes")
        self._m_rung = _metrics.counter(
            "gram_rung_transitions_total", "degradation-ladder escalations")
        self._m_compiles = _metrics.counter(
            "gram_compiles_total", "program bindings (the JAX package's "
            "compilations)")
        self._m_exec_cache = _metrics.counter(
            "gram_exec_cache_total", "executable-cache lookups by outcome")
        self._m_queue = _metrics.gauge(
            "gram_queue_depth", "requests waiting across buckets")
        self._m_latency = _metrics.histogram(
            "gram_request_latency_s", "submit -> done seconds")
        self._m_qwait = _metrics.histogram(
            "gram_queue_wait_s", "submit -> batch-drain seconds")
        self._m_fill = _metrics.histogram(
            "gram_batch_fill", "live requests / slots per drained batch",
            lo=1.0 / 64, hi=2.0)
        self._m_exec = _metrics.histogram(
            "gram_exec_s", "executable wall seconds per batch attempt")
        # overload instruments: admission decisions, sheds by reason,
        # cancellations and deadline misses, labeled per tenant
        self._m_admitted = _metrics.counter(
            "gram_admitted_total", "requests accepted by admission control")
        self._m_shed = _metrics.counter(
            "gram_shed_total", "requests shed by admission/CoDel, by reason")
        self._m_cancelled = _metrics.counter(
            "gram_cancelled_total", "requests cancelled while queued")
        self._m_deadline_miss = _metrics.counter(
            "gram_deadline_miss_total", "deadline misses, by outcome")

    # -- request intake ----------------------------------------------------
    def submit(self, a, *, full: bool = True, gram_of: str = "cols",
               deadline_s: Optional[float] = None, tenant: str = "default",
               priority: int = 0, admission: Optional[str] = None,
               block_timeout_s: Optional[float] = None,
               operand_dtype=None) -> GramFuture:
        """Enqueue one Gram request; returns its :class:`GramFuture`.

        ``full`` selects the mirrored symmetric C (default) vs the lower
        triangle only; ``gram_of="rows"`` serves ``a @ a.T`` (the
        Arrigoni-Massini row gram — the ``aat`` leaf program on the
        fused path) instead of the default ``a.T @ a``.  ``deadline_s``
        (relative to submission) lets the engine fail the request fast
        instead of retrying past its usefulness; ``tenant`` and
        ``priority`` feed the weighted-fair / EDF scheduler.
        ``operand_dtype`` overrides the engine-level quantization for
        this request (fp8/bf16 operand tiles, DESIGN.md §16); quantized
        requests bucket separately from native ones.

        Admission is decided HERE (DESIGN.md §15): the request is either
        accepted (operand staged into the bucket's donated ring buffer),
        shed — the future fails fast with :class:`Overloaded`; ``submit``
        itself never raises on load — or, with ``admission="block"``,
        the caller blocks until space frees or ``block_timeout_s``
        expires (then sheds).  A request whose deadline is already
        unmeetable given the queue ahead of it is shed immediately
        rather than queued to die."""
        a = _as_tensor(a)
        if a.ndim != 2:
            raise ValueError(f"gram request must be 2-D, got "
                             f"{tuple(a.shape)}")
        if gram_of not in ("cols", "rows"):
            raise ValueError(f"gram_of must be 'cols' or 'rows', got "
                             f"{gram_of!r}")
        mode = self.admission if admission is None else admission
        if mode not in ("shed", "block"):
            raise ValueError(f"admission must be 'shed' or 'block', got "
                             f"{mode!r}")
        now = time.perf_counter()
        od = operand_dtype if operand_dtype is not None \
            else self.operand_dtype
        od = "native" if od in (None, "native") else _sf._dtype_name(od)
        r = GramRequest(uid=next(self._uid), a=a, shape=tuple(a.shape),
                        full=full,
                        gram_of=gram_of, t_submit=now,
                        deadline_s=deadline_s, tenant=str(tenant),
                        priority=int(priority), operand_dtype=od)
        if deadline_s is not None:
            r.t_deadline = now + deadline_s
        fut = GramFuture(self, r)
        r.future = fut
        key = self._bucket_key(r.shape, a.dtype, gram_of, od)
        b = self._blabel(key)
        timeout = self.block_timeout_s if block_timeout_s is None \
            else block_timeout_s
        t_give_up = now + timeout
        with self._lock:
            ts = self._tenant(r.tenant)
            ts.submitted += 1
            self._m_requests.inc(engine=self.engine_label, bucket=b)
            _trace.instant("submit", trace_id=r.uid, bucket=b,
                           shape=f"{a.shape[0]}x{a.shape[1]}",
                           gram_of=gram_of, tenant=r.tenant)
            while True:
                if self._stop:
                    self._finish_failed(
                        r, "engine shutdown",
                        exc=EngineShutdown(
                            f"request {r.uid}: engine is shut down"))
                    return fut
                reason = self._admission_veto_locked(key, r, ts)
                if reason is None:
                    self._admit_locked(key, r, ts)
                    return fut
                if reason == "unmeetable":
                    # blocking cannot help a deadline the queue already
                    # makes unmeetable — shed even in block mode
                    self._finish_shed(r, reason)
                    return fut
                # before shedding, try to free space by failing queued
                # requests that are already doomed (CoDel discipline:
                # drop the dead, not the newest)
                if self._prune_queues_locked():
                    continue
                if mode == "block":
                    remaining = t_give_up - time.perf_counter()
                    if remaining > 0:
                        self._space.wait(remaining)
                        continue
                    reason = f"{reason}_timeout"
                self._finish_shed(r, reason)
                return fut

    # -- admission control (DESIGN.md §15) ---------------------------------
    def _tenant(self, name: str) -> TenantState:
        ts = self._tenants.get(name)
        if ts is None:
            ts = TenantState(name=name,
                             weight=max(self.tenant_weights.get(name, 1.0),
                                        1e-9),
                             vtime=self._vclock)
            self._tenants[name] = ts
        return ts

    def _admission_veto_locked(self, key, r: GramRequest,
                               ts: TenantState) -> Optional[str]:
        """None to accept, else the shed-reason slug.  The unmeetable
        check prices only the QUEUE ahead of the request (batches of
        ``slots`` at the bucket's estimated batch seconds) — never the
        request's own service time, so an empty queue always admits and
        the ladder's deadline-expiry semantics are unchanged."""
        qb = len(self.waiting.get(key, ()))
        if self.deadline_shedding and r.t_deadline is not None:
            est = self._est_batch_s(key)
            if est is not None:
                wait_est = (qb // self.slots) * est
                if time.perf_counter() + wait_est > r.t_deadline:
                    return "unmeetable"
        if self._queued >= self.max_queue:
            return "queue_full"
        if (self.max_queue_per_bucket is not None
                and qb >= self.max_queue_per_bucket):
            return "bucket_full"
        if self.tenant_quota is not None and ts.queued >= self.tenant_quota:
            return "tenant_quota"
        return None

    def _admit_locked(self, key, r: GramRequest, ts: TenantState) -> None:
        self._stage_operand_locked(key, r)
        if ts.queued == 0:
            # (re)activating tenant: no banked WFQ credit from idling
            ts.vtime = max(ts.vtime, self._vclock)
        self.waiting.setdefault(key, []).append(r)
        self._queued += 1
        ts.queued += 1
        ts.admitted += 1
        self.queue_peak = max(self.queue_peak, self._queued)
        b = self._blabel(key)
        self._m_admitted.inc(engine=self.engine_label, bucket=b,
                             tenant=r.tenant)
        self._m_queue.set(self._queued, engine=self.engine_label)
        _trace.instant("admit", trace_id=r.uid, bucket=b, tenant=r.tenant,
                       queued=self._queued)
        self._work.notify()

    def _stage_operand_locked(self, key, r: GramRequest) -> None:
        """Copy the operand into a donated ring buffer for its bucket;
        ``r.a`` becomes the true-shape view into the staged copy."""
        M, N, dtype, _gram_of = key[:4]
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = _OperandRing(
                self.ring_depth, (M, N), _torch_dtype(dtype))
        idx = ring.acquire()
        m, n = r.shape
        if idx is None:                 # ring exhausted: plain allocation
            buf = torch.empty((M, N), dtype=_torch_dtype(dtype))
        else:
            buf = ring.bufs[idx]
            r.ring_slot = (key, idx)
        buf[:m, :n].copy_(r.a)
        r.a = buf[:m, :n]

    def _release_operand_locked(self, r: GramRequest) -> None:
        if r.ring_slot is not None:
            key, idx = r.ring_slot
            r.ring_slot = None
            ring = self._rings.get(key)
            if ring is not None:
                ring.release(idx)

    def _dequeue_locked(self, r: GramRequest) -> None:
        """Accounting for one request leaving a waiting queue (into a
        batch, a shed, a cancel or shutdown) — the caller removes it
        from the queue list itself."""
        self._queued -= 1
        self._tenants[r.tenant].queued -= 1

    def _notify_idle_locked(self) -> None:
        if self._queued == 0 and self._inflight == 0:
            self._idle.notify_all()

    # -- work estimation (cost model -> seconds) ---------------------------
    _EST_ALPHA = 0.3

    def _work_units(self, key) -> float:
        """Cost-model work units (exact leaf-product count) for one
        request of this bucket — the machine-independent currency of the
        shedder and the WFQ scheduler."""
        u = self._work_cache.get(key)
        if u is None:
            M, N, _dtype, gram_of = key[:4]
            cfg = self._bucket_config(key, 0)
            levels = cfg["levels"]
            if levels == "auto":
                levels = min(ata_levels_for(M, N, cfg["leaf"]),
                             AUTO_MAX_LEVELS)
            try:
                u = float(gram_serve_work(M, N, gram_of=gram_of,
                                          leaf=cfg["leaf"],
                                          levels=int(levels)))
            except Exception:
                u = float(M) * N * (N + 1) / 2.0
            self._work_cache[key] = u
        return u

    def _note_batch_seconds(self, key, dt: float) -> None:
        """Feed one measured batch service time (including injected
        exec_delay stalls — overload drills must inflate the estimate)
        into the per-bucket EWMA and the global seconds-per-work-unit
        EWMA used for never-measured buckets."""
        with self._lock:
            units = self._work_units(key) * self.slots
            per = dt / max(units, 1.0)
            a = self._EST_ALPHA
            self._sec_per_unit = per if self._sec_per_unit is None \
                else (1 - a) * self._sec_per_unit + a * per
            old = self._batch_s.get(key)
            self._batch_s[key] = dt if old is None \
                else (1 - a) * old + a * dt

    def _est_batch_s(self, key) -> Optional[float]:
        """Estimated seconds to serve one batch of this bucket; None
        until the engine has measured anything at all."""
        est = self._batch_s.get(key)
        if est is not None:
            return est
        if self._sec_per_unit is None:
            return None
        return self._sec_per_unit * self._work_units(key) * self.slots

    def _prune_queues_locked(self) -> List[GramRequest]:
        """CoDel-style sweep: walk every bucket queue in EDF order and
        remove the requests that are already dead — overdue ones fail as
        deadline misses, not-yet-overdue ones whose queue position makes
        their deadline unmeetable are shed — so overload pressure evicts
        the doomed, not the newest arrivals.  Returns the requests it
        finished."""
        now = time.perf_counter()
        done: List[GramRequest] = []
        for key in list(self.waiting):
            q = self.waiting[key]
            q.sort(key=_edf_key)
            est = self._est_batch_s(key) if self.deadline_shedding else None
            keep: List[GramRequest] = []
            for r in q:
                if r.t_deadline is None:
                    keep.append(r)
                elif now > r.t_deadline:
                    self._dequeue_locked(r)
                    self._finish_failed(r, "deadline exceeded in queue")
                    done.append(r)
                elif (est is not None
                      and now + (len(keep) // self.slots) * est
                      > r.t_deadline):
                    self._dequeue_locked(r)
                    self._finish_shed(r, "unmeetable")
                    done.append(r)
                else:
                    keep.append(r)
            if keep:
                self.waiting[key] = keep
            else:
                del self.waiting[key]
        if done:
            self._m_queue.set(self._queued, engine=self.engine_label)
            self._space.notify_all()
            self._notify_idle_locked()
        return done

    def _cancel(self, r: GramRequest) -> bool:
        """Cancel a queued request (GramFuture.cancel backend): False
        once it is in flight or terminal."""
        with self._lock:
            if r.done or r.running:
                return False
            key = self._bucket_key(r.shape, r.a.dtype, r.gram_of,
                                   r.operand_dtype)
            q = self.waiting.get(key)
            if q is None or r not in q:
                return False            # racing terminal transition
            q.remove(r)
            if not q:
                del self.waiting[key]
            self._dequeue_locked(r)
            self._m_queue.set(self._queued, engine=self.engine_label)
            self._space.notify_all()
            self._finish_cancelled(r)
        return True

    def _bucket_key(self, shape, dtype, gram_of: str = "cols",
                    operand_dtype=None) -> tuple:
        """5-tuple bucket identity: (M, N, dtype, gram_of, operand) where
        the last element is the quantization the bucket serves under —
        ``"native"`` (no quantization — the historical behavior) or the
        operand dtype name.  Quantized and native traffic for the same
        shape are distinct buckets: distinct executables, guard
        tolerances, rings, and drift histories."""
        M, N = _autotune.bucket_shape(*shape, min_side=self.min_bucket)
        od = operand_dtype if operand_dtype is not None \
            else self.operand_dtype
        od = "native" if od in (None, "native") else _sf._dtype_name(od)
        return (M, N, _sf._dtype_name(dtype), gram_of, od)

    @staticmethod
    def _bucket_operand(key) -> Optional[str]:
        """Quantized operand dtype name of a bucket key, None for native
        (tolerates legacy 4-tuple keys fed by older tests/tools)."""
        od = key[4] if len(key) > 4 else "native"
        return None if od == "native" else od

    @classmethod
    def _blabel(cls, key) -> str:
        """Metric/trace label for one bucket key.  Native buckets keep
        the historical ``MxN/dtype/gram_of`` form bit-for-bit; quantized
        buckets append the operand dtype."""
        M, N, dtype, gram_of = key[:4]
        base = f"{M}x{N}/{dtype}/{gram_of}"
        od = cls._bucket_operand(key)
        return base if od is None else f"{base}/{od}"

    @classmethod
    def _drift_key(cls, key) -> str:
        """Drift-detector key: the bucket in autotune's vocabulary (the
        `kind` the winner was tuned for), so a finding maps 1:1 onto a
        cache entry ``invalidate_drifted`` can drop.  Native buckets keep
        the historical 3-segment form; quantized buckets append the
        operand dtype as a 4th segment."""
        M, N, dtype, gram_of = key[:4]
        base = f"{M}x{N}/{dtype}/{'aat' if gram_of == 'rows' else 'ata'}"
        od = cls._bucket_operand(key)
        return base if od is None else f"{base}/{od}"

    # -- degradation ladder ------------------------------------------------
    def _bucket_health(self, key) -> BucketHealth:
        return self._health.setdefault(key, BucketHealth())

    def _bucket_config(self, key, rung: int = 0) -> dict:
        """Engine config for one bucket at one ladder rung.

        Rung 0 behaves as always: the autotune winner fills in only the
        knobs the caller left open (mode/levels "auto", block None) —
        explicit engine arguments always win.  Mode/levels are adopted
        only from *measured* entries (wall-clock-backed: a model-only
        entry must not flip the backend-appropriate "auto" dispatch);
        block sizes only from fused winners (reference entries carry
        placeholder blocks).  Higher rungs degrade: 1 skips the autotune
        winner (quarantine), 2 forces the reference recursion, 3 adds
        ``levels=0`` (classical — no fast-variant arithmetic at all).

        The §16 perf knobs ride the same policy: ``pipeline_depth`` is
        adopted only from *measured* fused winners (it is a wall-clock
        claim — a model-only entry must not pick the pipelined kernel on
        a backend where it was never timed), and ``operand_dtype`` is
        never adopted from the cache at all — quantization changes the
        served numerics, so it flows exclusively from the caller (engine
        kwarg / per-request override) via the bucket key.
        """
        M, N, dtype, gram_of = key[:4]
        cfg = {"mode": self.mode, "levels": self.levels, "leaf": self.leaf,
               "variant": self.variant, "block": self.block,
               "pipeline_depth": self.pipeline_depth,
               "operand_dtype": self._bucket_operand(key)}
        if self.use_autotune_cache and rung == 0:
            try:
                hit = _autotune.lookup(
                    M, N, dtype=dtype,
                    kind="aat" if gram_of == "rows" else "ata",
                    min_side=self.min_bucket, backend=self.device.type)
            except Exception:
                hit = None
            if hit:
                if hit.get("source") == "measured":
                    if cfg["mode"] == "auto":
                        cfg["mode"] = hit["mode"]
                    if cfg["levels"] == "auto":
                        cfg["levels"] = hit["levels"]
                    if cfg["pipeline_depth"] is None \
                            and hit.get("mode") == "fused":
                        cfg["pipeline_depth"] = hit.get("pipeline_depth")
                if cfg["block"] is None and hit.get("mode") == "fused":
                    cfg["block"] = hit.get("bk")
        if rung >= 2:
            cfg["mode"] = "reference"
        if rung >= 3:
            cfg["levels"] = 0
        return cfg

    def _record_failure(self, key, health: BucketHealth, max_rung: int,
                        reason: str):
        """One failed attempt: bump counters; trip the breaker (escalate
        the rung, stickily) after ``breaker_threshold`` consecutive
        failures."""
        health.failures += 1
        health.consecutive_failures += 1
        self.retries += 1
        b = self._blabel(key)
        self._m_retries.inc(engine=self.engine_label, bucket=b)
        _trace.instant("retry", bucket=b, reason=reason)
        if (health.consecutive_failures >= self.breaker_threshold
                and health.rung < max_rung):
            health.rung += 1
            health.consecutive_failures = 0
            health.quarantined.append(
                f"rung{health.rung - 1}: {reason}")
            self._m_rung.inc(engine=self.engine_label, bucket=b,
                             rung=health.rung)
            _trace.instant("rung_transition", bucket=b, rung=health.rung,
                           reason=reason)

    def _record_success(self, key, health: BucketHealth):
        health.successes += 1
        health.consecutive_failures = 0

    def _backoff(self, attempt: int, batch: List[GramRequest]):
        if self.backoff_s <= 0:
            return
        wait = self.backoff_s * (2 ** (attempt - 1))
        # deadline-less requests must not sleep unboundedly: the
        # exponential is capped by max_backoff_s before any deadline math
        if self.max_backoff_s is not None:
            wait = min(wait, self.max_backoff_s)
        # never sleep past the tightest live deadline
        now = time.perf_counter()
        for r in batch:
            if r.t_deadline is not None:
                wait = min(wait, max(0.0, r.t_deadline - now))
        if wait > 0:
            time.sleep(wait)

    def _expire(self, entries):
        """Split [(slot, request)] into (live, newly-expired-and-failed)."""
        now = time.perf_counter()
        live, expired = [], []
        for slot, r in entries:
            if r.t_deadline is not None and now > r.t_deadline:
                self._finish_failed(r, "deadline exceeded")
                expired.append(r)
            else:
                live.append((slot, r))
        return live, expired

    # -- completion bookkeeping -------------------------------------------
    # Every terminal path claims the future FIRST (exactly-once), then
    # does its accounting under the engine lock.  A request taken into a
    # batch holds an in-flight slot; releasing it may wake drain().

    def _settle_locked(self, r: GramRequest) -> None:
        """Shared terminal accounting: in-flight slot, operand ring,
        host copy, finished history, idle wakeup."""
        if r.running:
            r.running = False
            self._inflight -= 1
            ts = self._tenants.get(r.tenant)
            if ts is not None:
                ts.inflight -= 1
        self._release_operand_locked(r)
        r.a = None                      # free the host copy
        self.finished.append(r)
        self._notify_idle_locked()

    def _note_deadline_miss_locked(self, r: GramRequest, b: str,
                                   outcome: str) -> None:
        self.deadline_missed += 1
        self._tenant(r.tenant).deadline_missed += 1
        self._m_deadline_miss.inc(engine=self.engine_label, bucket=b,
                                  tenant=r.tenant, outcome=outcome)
        _trace.instant_at("deadline_miss", r.t_deadline or r.t_done,
                          trace_id=r.uid, bucket=b, tenant=r.tenant,
                          outcome=outcome)

    def _finish_ok(self, r: GramRequest, c: np.ndarray, *, served_by: str,
                   degraded: bool, t_done: Optional[float] = None):
        if r.future is not None and not r.future._deliver(result=c):
            return
        with self._lock:
            b = self._blabel(self._bucket_key(r.shape, r.a.dtype,
                                              r.gram_of,
                                              r.operand_dtype))
            r.result = c
            r.status, r.done = "ok", True
            r.t_done = t_done if t_done is not None else time.perf_counter()
            r.degraded = degraded
            r.served_by = served_by
            r.verified = True if self._guard_on else None
            self.served += 1
            if degraded:
                self.degraded_served += 1
            self._tenant(r.tenant).served += 1
            if r.t_deadline is not None and r.t_done > r.t_deadline:
                self._note_deadline_miss_locked(r, b, "served_late")
            self._settle_locked(r)
            self._m_served.inc(engine=self.engine_label, bucket=b,
                               served_by=served_by)
            self._m_latency.observe(r.latency_s, engine=self.engine_label,
                                    bucket=b)
        _trace.instant("done", trace_id=r.uid, status="ok",
                       served_by=served_by)
        _trace.add_span("request", r.t_submit, r.t_done, trace_id=r.uid,
                        bucket=b, status="ok", served_by=served_by,
                        attempts=r.attempts)

    def _finish_failed(self, r: GramRequest, error: str, *,
                       exc: Optional[BaseException] = None):
        if r.future is not None and not r.future._deliver(
                exception=exc if exc is not None
                else GramServeError(f"request {r.uid} failed: {error}")):
            return
        with self._lock:
            b = self._blabel(self._bucket_key(r.shape, r.a.dtype,
                                              r.gram_of,
                                              r.operand_dtype))
            r.status, r.done = "failed", True
            r.error = error
            r.t_done = time.perf_counter()
            self.failed += 1
            self._tenant(r.tenant).failed += 1
            self._m_failed.inc(engine=self.engine_label, bucket=b)
            if error.startswith("deadline"):
                self._m_deadline.inc(engine=self.engine_label, bucket=b)
                self._note_deadline_miss_locked(r, b, "failed")
            self._settle_locked(r)
            self._m_latency.observe(r.latency_s, engine=self.engine_label,
                                    bucket=b)
        _trace.instant("done", trace_id=r.uid, status="failed", error=error)
        _trace.add_span("request", r.t_submit, r.t_done, trace_id=r.uid,
                        bucket=b, status="failed", error=error,
                        attempts=r.attempts)

    def _finish_shed(self, r: GramRequest, reason: str):
        if r.future is not None and not r.future._deliver(
                exception=Overloaded(
                    f"request {r.uid} shed ({reason}): engine "
                    f"{self.engine_label} is overloaded")):
            return
        with self._lock:
            b = self._blabel(self._bucket_key(r.shape, r.a.dtype,
                                              r.gram_of,
                                              r.operand_dtype))
            r.status, r.done = "shed", True
            r.error = f"shed: {reason}"
            r.t_done = time.perf_counter()
            self.shed += 1
            self._tenant(r.tenant).shed += 1
            self._m_shed.inc(engine=self.engine_label, bucket=b,
                             tenant=r.tenant, reason=reason)
            self._settle_locked(r)
        _trace.instant("shed", trace_id=r.uid, bucket=b, tenant=r.tenant,
                       reason=reason)
        _trace.add_span("request", r.t_submit, r.t_done, trace_id=r.uid,
                        bucket=b, status="shed", error=r.error,
                        attempts=r.attempts)

    def _finish_cancelled(self, r: GramRequest):
        if r.future is not None and not r.future._deliver(
                exception=CancelledError(f"request {r.uid} cancelled")):
            return
        with self._lock:
            b = self._blabel(self._bucket_key(r.shape, r.a.dtype,
                                              r.gram_of,
                                              r.operand_dtype))
            r.status, r.done = "cancelled", True
            r.error = "cancelled"
            r.t_done = time.perf_counter()
            self.cancelled += 1
            self._tenant(r.tenant).cancelled += 1
            self._m_cancelled.inc(engine=self.engine_label, bucket=b,
                                  tenant=r.tenant)
            self._settle_locked(r)
        _trace.instant("cancel", trace_id=r.uid, bucket=b, tenant=r.tenant)

    # -- output guards -----------------------------------------------------
    def _guard(self, key, entries, out: torch.Tensor) -> Optional[str]:
        """Run the output guards over a served batch (on its device);
        None when every result passes, else a reason string (the whole
        batch retries — corruption is a property of the executable run,
        not a request).

        The finite scan runs ONCE over the whole slot stack (padding
        slots are exact zeros, so they never veto); per-request work
        (the diagonal's sign, probes) touches each request's slice."""
        if not self._guard_on:
            return None
        M, N, dtype, gram_of = key[:4]
        if not bool(torch.isfinite(out).all()):
            self._veto(key, "non_finite")
            return "guard veto: non-finite entries in served batch"
        rtol = self.verify_rtol
        if rtol is None:
            # precision-scaled: a quantized bucket's residual is bounded
            # by the operand quantization step, not the storage dtype
            rtol = _verify.default_rtol(self._bucket_operand(key) or dtype)
        for slot, r in entries:
            n = r.shape[0] if gram_of == "rows" else r.shape[1]
            c = out[slot, :n, :n] if out.ndim == 3 else out[:n, :n]
            d = torch.diagonal(c).double()
            scale = float(d.abs().max()) if d.numel() else 0.0
            if not bool((d >= -rtol * max(scale, 1.0)).all()):
                self._veto(key, "negative_diagonal", uid=r.uid)
                return f"guard veto on request {r.uid}: negative diagonal"
            if self._probes:
                ok, worst = _verify.freivalds_gram(
                    r.a, c, probes=self._probes, rtol=rtol,
                    gram_of=gram_of, full=False, rng=self._verify_rng)
                if not ok:
                    self._veto(key, "freivalds", uid=r.uid)
                    return (f"guard veto on request {r.uid}: freivalds "
                            f"identity violated (rel err {worst:.3e})")
        return None

    def _veto(self, key, reason: str, uid: Optional[int] = None) -> None:
        """One guard veto: counter + an instant on the shared timeline."""
        self.guard_failures += 1
        self._m_vetoes.inc(engine=self.engine_label,
                           bucket=self._blabel(key))
        _trace.instant("guard_veto", trace_id=uid, reason=reason,
                       bucket=self._blabel(key))

    # -- mesh lifecycle ----------------------------------------------------
    def apply_mesh(self, mesh) -> None:
        """Adopt a new (typically shrunk) device mesh mid-run: recompute
        the distributed axis mapping, invalidate every distributed
        executable and fallback chain, and reset distributed buckets'
        ladder rungs (the old rung judged the old mesh's schemes)."""
        dist_keys = [k for k in self._health if self._is_distributed(k)]
        self.mesh = mesh
        self.dist_axes = default_gram_axes(mesh) if mesh is not None else {}
        self._mesh_epoch += 1
        self.mesh_changes += 1
        self._dist_chains.clear()
        self._executables = {ek: exe for ek, exe in self._executables.items()
                             if ek[0] != "dist"}
        for k in dist_keys:
            self._health[k].rung = 0
            self._health[k].consecutive_failures = 0

    def _poll_faults(self):
        """Chaos hook: an armed ``mesh_shrink`` fault drops one replica
        group from the serving mesh (``runtime.faults``)."""
        if self.mesh is None:
            return
        if _faults.fire("mesh_shrink", "gram.engine.mesh"):
            new = shrink_mesh(self.mesh)
            if new is not None:
                self.apply_mesh(new)

    # -- executable cache --------------------------------------------------
    @staticmethod
    def _cfg_fingerprint(cfg) -> tuple:
        return (cfg["mode"], str(cfg["levels"]), cfg["leaf"],
                cfg["variant"], cfg["block"],
                cfg.get("pipeline_depth"), cfg.get("operand_dtype"))

    def _local_executable(self, key, cfg):
        """The bucket's bound batched program (module doc: the port's
        "executable"), built once per (bucket, config) and cached."""
        M, N, dtype, gram_of = key[:4]
        ekey = ("local", key, self._cfg_fingerprint(cfg))
        if ekey in self._executables:
            self._m_exec_cache.inc(engine=self.engine_label, path="local",
                                   outcome="hit")
            return self._executables[ekey]
        self._m_exec_cache.inc(engine=self.engine_label, path="local",
                               outcome="miss")
        with _trace.span("compile", bucket=self._blabel(key), path="local",
                         mode=str(cfg["mode"]), levels=str(cfg["levels"])):
            exe = _bind_local(
                M, N, batch=self.slots, gram_of=gram_of,
                levels=cfg["levels"], leaf=cfg["leaf"],
                variant=cfg["variant"], mode=cfg["mode"],
                block=cfg["block"], out_dtype=self.out_dtype,
                dtype=_torch_dtype(dtype),
                pipeline_depth=cfg.get("pipeline_depth"),
                operand_dtype=cfg.get("operand_dtype"), device=self.device)
        self.compile_count += 1
        self._m_compiles.inc(engine=self.engine_label,
                             bucket=self._blabel(key), path="local")
        self._executables[ekey] = exe
        return exe

    def _dist_executable(self, key, scheme, cfg):
        M, N, dtype, gram_of = key[:4]
        ekey = ("dist", key, scheme, self._mesh_epoch)
        if ekey in self._executables:
            self._m_exec_cache.inc(engine=self.engine_label, path="dist",
                                   outcome="hit")
            return self._executables[ekey]
        self._m_exec_cache.inc(engine=self.engine_label, path="dist",
                               outcome="miss")

        # one request at a time on the whole mesh: the mesh IS the
        # batch dimension here, slot-stacking would fight the sharding
        # (autotuned mode/levels still apply; block resolves inside
        # the per-shard kernels via the ops-level autotune defaults)
        mesh, axes = self.mesh, dict(self.dist_axes)

        def one(x):
            return distributed_gram(
                x, mesh, scheme=scheme, levels=cfg["levels"],
                leaf=cfg["leaf"], variant=cfg["variant"], mode=cfg["mode"],
                out_dtype=self.out_dtype, **axes).full_tensor()
        with _trace.span("compile", bucket=self._blabel(key),
                         path=f"dist:{scheme}"):
            exe = one
        self.compile_count += 1
        self._m_compiles.inc(engine=self.engine_label,
                             bucket=self._blabel(key), path="dist")
        self._executables[ekey] = exe
        return exe

    # -- cost-model drift ---------------------------------------------------
    def _drift_prediction(self, key, cfg) -> Optional[float]:
        """Model-predicted HBM bytes for one (bucket, config) — the
        denominator of both drift channels.  Resolves the same defaults
        the executable resolves (the "auto" mode dispatch, natural
        recursion depth, default block) so the prediction prices the
        config actually run; None when the model cannot price it."""
        ck = (key, self._cfg_fingerprint(cfg))
        if ck in self._drift_pred_cache:
            return self._drift_pred_cache[ck]
        M, N, dtype, gram_of = key[:4]
        pred: Optional[float] = None
        try:
            levels = cfg["levels"]
            if levels == "auto":
                levels = min(ata_levels_for(M, N, cfg["leaf"]),
                             AUTO_MAX_LEVELS)
            blk = cfg["block"] or _autotune.DEFAULT_BLOCK
            cand = {"mode": resolve_mode(cfg["mode"], device=self.device),
                    "levels": int(levels),
                    "variant": cfg["variant"], "bm": blk, "bk": blk,
                    "bn": blk}
            pred = _autotune.model_score(
                M, N, cand, in_bytes=int(_torch_dtype(dtype).itemsize),
                out_bytes=int(self.out_dtype.itemsize),
                kind="aat" if gram_of == "rows" else "ata")
        except Exception:
            pred = None
        self._drift_pred_cache[ck] = pred
        return pred

    def invalidate_drifted(self, channel: str = "wall") -> List[str]:
        """Act on drift findings: drop each flagged bucket's autotune
        winner (``gram.autotune.invalidate``), its cached executables and
        prediction, and its drift history — the next touch re-tunes and
        re-measures from scratch.  Returns the flagged drift keys."""
        dropped = []
        for dk in self.drift.stale_keys(channel):
            parts = str(dk).split("/")
            size, dtype, kind = parts[:3]
            od = parts[3] if len(parts) > 3 else "native"
            M, N = (int(x) for x in size.split("x"))
            try:
                _autotune.invalidate(M, N, dtype=dtype, kind=kind,
                                     min_side=self.min_bucket,
                                     backend=self.device.type)
            except Exception:
                pass                    # no cache entry to drop is fine
            key = (M, N, dtype, "rows" if kind == "aat" else "cols", od)
            self._executables = {
                ek: exe for ek, exe in self._executables.items()
                if ek[1] != key}
            self._drift_pred_cache = {
                ck: v for ck, v in self._drift_pred_cache.items()
                if ck[0] != key}
            self.drift.reset(dk)
            dropped.append(str(dk))
            _trace.instant("drift_invalidate", key=str(dk), channel=channel)
        return dropped

    def _is_distributed(self, key) -> bool:
        """Buckets at/above the element threshold route to the mesh (when
        one is configured and the configured scheme fits the bucket — for
        "auto", any feasible scheme; otherwise dist_scheme itself must be
        feasible, or the bucket stays local rather than failing mid-step
        on a divisibility error; a rank that a shrink left outside the
        mesh serves locally)."""
        M, N, _, gram_of = key[:4]
        if gram_of == "rows":
            # the distributed schemes decompose A^t A; row-gram buckets
            # stay on the local aat executor
            return False
        if self._bucket_operand(key) is not None:
            # quantized operand tiles are a fused-local-kernel feature;
            # the distributed schemes serve native precision only
            return False
        if self.mesh is None or M * N < self.dist_threshold:
            return False
        coordinate = getattr(self.mesh, "get_coordinate", None)
        if coordinate is not None and coordinate() is None:
            # this rank left the mesh (a shrink dropped its slice): it
            # holds the whole A, so it serves the bucket locally
            return False
        feas = feasible_schemes(M, N, self.mesh, **self.dist_axes)
        if self.dist_scheme == "auto":
            return bool(feas)
        return self.dist_scheme in feas

    def _dist_chain(self, key) -> List[str]:
        """Fallback chain for one distributed bucket on the current mesh
        (``core.distributed.scheme_fallback_chain`` + terminal "local"),
        cached per mesh epoch."""
        ck = (key, self._mesh_epoch)
        if ck not in self._dist_chains:
            M, N, dtype, gram_of = key[:4]
            chain = scheme_fallback_chain(
                M, N, self.mesh, scheme=self.dist_scheme,
                dtype_bytes=_torch_dtype(dtype).itemsize,
                out_bytes=self.out_dtype.itemsize,
                **self.dist_axes)
            self._dist_chains[ck] = [f"dist:{s}" for s in chain] + ["local"]
        return self._dist_chains[ck]

    def prewarm(self, shapes, dtype=torch.float32) -> int:
        """Bind the programs of the buckets covering ``shapes`` ahead of
        traffic (steady-state serving pays no first-request binding).
        Returns the number of bindings triggered."""
        before = self.compile_count
        for shape in shapes:
            key = self._bucket_key(shape, dtype)
            cfg = self._bucket_config(key, rung=0)
            if self._is_distributed(key):
                scheme = self._dist_chain(key)[0]
                if scheme != "local":
                    self._dist_executable(key, scheme[len("dist:"):], cfg)
                    continue
            self._local_executable(key, cfg)
        return self.compile_count - before

    # -- scheduling (full-batch-first -> WFQ across buckets -> EDF) --------
    def _select_bucket_locked(self) -> tuple:
        """Pick the bucket to drain: any bucket with a full batch first
        (throughput, exactly as before), ties and partial batches broken
        by weighted-fair queuing — the bucket whose head request belongs
        to the tenant with the smallest virtual time — then by oldest
        head.  With a single tenant every vtime compares equal and this
        degenerates to the old oldest-head-first policy."""
        full = [k for k, q in self.waiting.items() if len(q) >= self.slots]
        pool = full or list(self.waiting)

        def rank(k):
            head = min(self.waiting[k], key=_edf_key)
            ts = self._tenants.get(head.tenant)
            return (ts.vtime if ts is not None else 0.0,
                    head.t_submit, head.uid)

        key = min(pool, key=rank)
        self._vclock = max(self._vclock, rank(key)[0])
        return key

    def _take_batch_locked(self, key) -> List[Tuple[int, GramRequest]]:
        """Pop up to ``slots`` requests from one bucket in EDF order,
        honoring the per-tenant in-flight cap (a capped tenant's surplus
        stays queued for the next tick; the bucket never stalls — if
        every waiting request is capped, the EDF head runs anyway)."""
        q = self.waiting[key]
        q.sort(key=_edf_key)
        cap = self.tenant_max_inflight
        take: List[GramRequest] = []
        leftover: List[GramRequest] = []
        taking: Dict[str, int] = {}
        for r in q:
            busy = (self._tenants[r.tenant].inflight
                    + taking.get(r.tenant, 0))
            if len(take) < self.slots and (cap is None or busy < cap):
                take.append(r)
                taking[r.tenant] = taking.get(r.tenant, 0) + 1
            else:
                leftover.append(r)
        if not take:                    # livelock guard: serve the head
            take, leftover = [q[0]], q[1:]
        if leftover:
            self.waiting[key] = leftover
        else:
            del self.waiting[key]
        units = self._work_units(key)
        for r in take:
            self._dequeue_locked(r)
            r.running = True
            ts = self._tenants[r.tenant]
            ts.inflight += 1
            self._inflight += 1
            # WFQ charge: one request's cost-model work over the
            # tenant's weight advances its virtual time
            ts.vtime += units / ts.weight
        self._m_queue.set(self._queued, engine=self.engine_label)
        self._space.notify_all()
        return list(enumerate(take))

    # -- one engine tick ---------------------------------------------------
    def step(self) -> List[GramRequest]:
        """Drain one batch: serve a full batch if any bucket has one
        (throughput), else weighted-fair across tenants / oldest head
        across buckets (fairness — sparse buckets cannot be starved by
        popular ones); EDF within a bucket (FIFO when no deadlines or
        priorities are in play).  Runs the bucket executable over up to
        ``slots`` stacked requests — through the degradation ladder
        (retry / escalate / fail, see module docstring) — and slices
        each result back to its true shape.  Returns the requests
        finished this tick (served, degraded, failed, or pruned by the
        shedder); never raises on an executable failure."""
        if not self.waiting:
            return []
        self._poll_faults()
        with self._lock:
            done = self._prune_queues_locked()
            if not self.waiting:
                return done
            self.ticks += 1
            key = self._select_bucket_locked()
            entries = self._take_batch_locked(key)
        batch = [r for _, r in entries]

        b = self._blabel(key)
        t_batch = time.perf_counter()
        for r in batch:
            self._m_qwait.observe(t_batch - r.t_submit,
                                  engine=self.engine_label, bucket=b)
        if _trace.tracing_enabled():
            for r in batch:
                _trace.add_span("queue_wait", r.t_submit, t_batch,
                                trace_id=r.uid, bucket=b)
        self._m_fill.observe(len(batch) / self.slots,
                             engine=self.engine_label)

        entries, expired = self._expire(entries)
        done.extend(expired)
        if entries:
            dist = self._is_distributed(key)
            with _trace.span("batch", bucket=b, n=len(entries),
                             path="dist" if dist else "local"):
                if dist:
                    for _, r in entries:
                        self._serve_one_distributed(key, r)
                        done.append(r)
                else:
                    done.extend(self._serve_local(key, entries))
        return done

    # -- the device ----------------------------------------------------------
    def _on_device(self):
        """The engine's stream (on the card) for one attempt's copies and
        launches; nothing on the CPU."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _sync(self) -> None:
        """Wait for the attempt's work on the card: its time ends here,
        and an asynchronous fault surfaces here, inside the ladder's try."""
        if self._stream is not None:
            self._stream.synchronize()

    def _clean_stack(self, key, entries) -> torch.Tensor:
        """A ``(slots, M, N)`` host stack (pinned on the card) holding this
        batch's operands, zero everywhere else: the clean copy every
        attempt starts from.  A view of one staging buffer that grows to
        the largest batch served and is shared by every bucket, so the
        engine holds at most one batch of its largest bucket."""
        M, N, dtype = key[:3]
        dt = _torch_dtype(dtype)
        nbytes = self.slots * M * N * dt.itemsize
        if self._staging is None or self._staging.numel() < nbytes:
            self._staging = None                # free the old one first
            self._staging = torch.empty(
                nbytes, dtype=torch.uint8,
                pin_memory=self.device.type == "cuda")
        else:
            self._sync()    # the last batch's copy may still read it
        clean = self._staging[:nbytes].view(dt).view(self.slots, M, N)
        by_slot = dict(entries)
        for slot in range(self.slots):
            r = by_slot.get(slot)
            if r is None:
                clean[slot].zero_()
                continue
            m, n = r.shape
            clean[slot, :m, :n].copy_(r.a)
            clean[slot, m:].zero_()
            clean[slot, :m, n:].zero_()
        return clean

    # -- local (slot-batched) serving -------------------------------------
    def _serve_local(self, key, entries) -> List[GramRequest]:
        """Serve [(slot, request)] through the slot-batched local
        program under the retry/escalation ladder."""
        M, N, dtype, gram_of = key[:4]
        health = self._bucket_health(key)
        clean = self._clean_stack(key, entries)

        b = self._blabel(key)
        attempt, last_err = 0, "unknown failure"
        while True:
            entries, expired = self._expire(entries)
            if not entries:
                return expired + [r for _, r in entries]
            rung = health.rung
            cfg = self._bucket_config(key, rung)
            site = f"gram.engine.exec.local.{M}x{N}.{dtype}.{gram_of}"
            # service-time sampling starts BEFORE the fault hook: an
            # injected exec_delay stall is real service time and must
            # inflate the shedder's estimate
            t_a0 = time.perf_counter()
            try:
                _faults.check_exec(site)
                stack = _poison("poison_operand", "gram.engine.operand",
                                clean)
                exe = self._local_executable(key, cfg)
                t_x0 = time.perf_counter()
                with self._on_device():
                    if _trace.tracing_enabled():
                        with torch.profiler.record_function(
                                f"gram_exec:{b}"):
                            out = exe(stack.to(self.device,
                                               non_blocking=True))
                    else:
                        out = exe(stack.to(self.device, non_blocking=True))
                    self._sync()
                    t_x1 = time.perf_counter()
                    self._m_exec.observe(t_x1 - t_x0,
                                         engine=self.engine_label, bucket=b,
                                         path="local")
                    out = _poison("poison_output", "gram.engine.output",
                                  out)
                    t_v0 = time.perf_counter()
                    veto = self._guard(key, entries, out)
                    t_v1 = time.perf_counter()
                if _trace.tracing_enabled():
                    for _, r in entries:
                        _trace.add_span("execute", t_x0, t_x1,
                                        trace_id=r.uid, bucket=b,
                                        path="local", rung=rung,
                                        attempt=attempt)
                        if self._guard_on:
                            _trace.add_span("verify", t_v0, t_v1,
                                            trace_id=r.uid, bucket=b,
                                            vetoed=veto is not None)
                if veto is None:
                    self._note_batch_seconds(key, t_x1 - t_a0)
                    if rung == 0:
                        # wall drift channel: measured executable seconds
                        # vs model bytes, per tuned bucket (rung 0 only —
                        # degraded rungs run a different config)
                        pred = self._drift_prediction(key, cfg)
                        if pred is not None:
                            self.drift.observe(
                                self._drift_key(key),
                                measured=t_x1 - t_x0, predicted=pred,
                                channel="wall",
                                config=str(self._cfg_fingerprint(cfg)))
                    break                       # success
                last_err = veto
            except Exception as e:  # noqa: BLE001 — ladder, not crash
                last_err = f"{type(e).__name__}: {e}"
            self._record_failure(key, health, _LOCAL_MAX_RUNG, last_err)
            attempt += 1
            for _, r in entries:
                r.attempts += 1
            if attempt > self.max_retries:
                for _, r in entries:
                    self._finish_failed(r, last_err)
                return expired + [r for _, r in entries]
            self._backoff(attempt, [r for _, r in entries])

        self._record_success(key, health)
        with self._on_device():
            results = []
            for slot, r in entries:
                # the result spans the gram'd dimension: cols for A^tA,
                # rows for the gram_of="rows" AA^t buckets
                n = r.shape[0] if gram_of == "rows" else r.shape[1]
                c = out[slot, :n, :n]
                results.append(_host_result(symmetrize_from_lower(c)
                                            if r.full else c))
        t_done = time.perf_counter()
        served_by = "local" if rung == 0 else f"local:rung{rung}"
        for (slot, r), c in zip(entries, results):
            r.attempts += 1
            self._finish_ok(r, c, served_by=served_by,
                            degraded=rung > 0, t_done=t_done)
        return expired + [r for _, r in entries]

    # -- distributed (mesh) serving ---------------------------------------
    def _serve_one_distributed(self, key, r: GramRequest) -> None:
        """Serve one request on the mesh, walking the scheme fallback
        chain (…-> local) on failure; the mesh may shrink between
        attempts (``_poll_faults`` runs per tick, ``apply_mesh`` any
        time), so the chain is re-read every attempt."""
        M, N, dtype, gram_of = key[:4]
        m, n = r.shape
        attempt, last_err = 0, "unknown failure"
        while True:
            if (r.t_deadline is not None and
                    time.perf_counter() > r.t_deadline):
                self._finish_failed(r, "deadline exceeded")
                return
            health = self._bucket_health(key)
            if not self._is_distributed(key):
                rung_name = "local"         # mesh shrank under the bucket
            else:
                chain = self._dist_chain(key)
                rung_name = chain[min(health.rung, len(chain) - 1)]
            if rung_name == "local":
                self._serve_local(key, [(0, r)])
                return
            site = f"gram.engine.exec.{rung_name}.{M}x{N}.{dtype}"
            scheme = rung_name[len("dist:"):]
            try:
                _faults.check_exec(site)
                clean = torch.zeros((M, N), dtype=_torch_dtype(dtype))
                clean[:m, :n].copy_(r.a)
                pad = _poison("poison_operand", "gram.engine.operand", clean)
                exe = self._dist_executable(key, scheme,
                                            self._bucket_config(key, 0))
                b = self._blabel(key)
                with self._on_device():
                    t_x0 = time.perf_counter()
                    c = exe(pad.to(self.device))
                    self._sync()
                    t_x1 = time.perf_counter()
                    self._m_exec.observe(t_x1 - t_x0,
                                         engine=self.engine_label, bucket=b,
                                         path="dist")
                    _trace.add_span("execute", t_x0, t_x1, trace_id=r.uid,
                                    bucket=b, path=rung_name,
                                    attempt=attempt)
                    c = _poison("poison_output", "gram.engine.output", c)
                    c = c[:n, :n]
                    with _trace.span("verify", trace_id=r.uid, bucket=b):
                        veto = self._guard(key, [(0, r)], c[None])
                    if veto is None:
                        c = _host_result(c if r.full else torch.tril(c))
                if veto is None:
                    r.attempts += 1
                    self._finish_ok(r, c, served_by=rung_name,
                                    degraded=health.rung > 0)
                    self.dist_served += 1
                    return
                last_err = veto
            except Exception as e:  # noqa: BLE001 — ladder, not crash
                last_err = f"{type(e).__name__}: {e}"
            self._record_failure(key, health,
                                 len(self._dist_chain(key)) - 1, last_err)
            attempt += 1
            r.attempts += 1
            if attempt > self.max_retries:
                self._finish_failed(r, last_err)
                return
            self._backoff(attempt, [r])

    # -- background scheduler ----------------------------------------------
    def _scheduler_alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> "GramEngine":
        """Start the background scheduler loop: after this, ``submit``
        alone drives serving and futures resolve asynchronously.
        Idempotent; ``shutdown()`` stops it.  Returns self.

        Refused on a mesh of more than one rank: every rank is a process
        of its own, and batches drained by timing would differ from rank
        to rank and deadlock the collectives; such a mesh serves the same
        trace on every rank through ``step`` / ``run_to_completion``."""
        if self.mesh is not None and \
                math.prod(_axis_sizes(self.mesh).values()) > 1:
            raise RuntimeError(
                "start() on a mesh of more than one rank: the ranks must run "
                "the same requests in the same order, so a multi-rank mesh "
                "serves synchronously (submit the same trace on every rank, "
                "then step() or run_to_completion())")
        with self._lock:
            if self._scheduler_alive():
                return self
            self._stop = False
            self._thread = threading.Thread(
                target=self._scheduler_loop,
                name=f"gram-engine-{self.engine_label}", daemon=True)
            self._thread.start()
        return self

    def _scheduler_loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            with self._work:
                while not self._stop and self._queued == 0:
                    # bounded wait: re-check stop even if a notify races
                    self._work.wait(0.05)
                if self._stop:
                    return
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 — step() is supposed
                # to absorb executable failures; anything escaping here
                # must not kill the serving thread
                _trace.instant("scheduler_error",
                               error=f"{type(e).__name__}: {e}")
                time.sleep(0.005)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every admitted request is terminal (queues empty,
        nothing in flight).  True on success, False on timeout."""
        with self._lock:
            return self._idle.wait_for(
                lambda: self._queued == 0 and self._inflight == 0, timeout)

    def shutdown(self, *, timeout: float = 10.0) -> int:
        """Stop the scheduler and fail every still-queued request
        exceptionally (``EngineShutdown``) — no future is left hanging.
        Returns the number of requests failed this way.  The engine can
        be ``start()``-ed again afterwards."""
        with self._lock:
            self._stop = True
            self._work.notify_all()
            self._space.notify_all()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout)
        with self._lock:
            pending = [r for q in self.waiting.values() for r in q]
            self.waiting.clear()
            for r in pending:
                self._dequeue_locked(r)
            self._m_queue.set(self._queued, engine=self.engine_label)
            for r in pending:
                self._finish_failed(
                    r, "engine shutdown",
                    exc=EngineShutdown(
                        f"request {r.uid}: engine {self.engine_label} "
                        f"shut down with the request still queued"))
            self._space.notify_all()
            self._notify_idle_locked()
            self._staging = None
        return len(pending)

    def serve(self, a, *, timeout: Optional[float] = None,
              **kw) -> np.ndarray:
        """Synchronous convenience path: ``submit(...).result()`` — all
        the ladder's retry/breaker/verify semantics apply unchanged.
        Steps the engine inline when no background scheduler is
        running."""
        fut = self.submit(a, **kw)
        if not self._scheduler_alive():
            ticks = 0
            while not fut.done() and ticks < 10_000:
                self.step()
                ticks += 1
        return fut.result(timeout)

    def run_to_completion(self, max_ticks: int = 10_000) \
            -> List[GramRequest]:
        if self._scheduler_alive():
            self.drain()
            return list(self.finished)
        for _ in range(max_ticks):
            if not self.waiting:
                break
            self.step()
        return list(self.finished)

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        """Serving snapshot.  Latency percentiles read this engine's
        slice of the O(1)-update log-bucketed histogram in the metrics
        registry — ``stats()`` neither re-sorts a latency list nor
        depends on ``finished`` (which is capped at ``history_cap`` and
        kept only for callers that want the request objects).  ``drift``
        carries the wall-channel cost-model findings (``obs.drift``)."""
        eng = {"engine": self.engine_label}
        bucket_keys = sorted({ek[1] for ek in self._executables})
        return {
            "served": self.served,
            "failed": self.failed,
            "degraded_served": self.degraded_served,
            "retries": self.retries,
            "guard_failures": self.guard_failures,
            "mesh_changes": self.mesh_changes,
            "dist_served": self.dist_served,
            "ticks": self.ticks,
            "compile_count": self.compile_count,
            "buckets": bucket_keys,
            "distributed_buckets": sorted(
                k for k in bucket_keys if self._is_distributed(k)),
            "quarantined": {str(k): list(h.quarantined)
                            for k, h in self._health.items()
                            if h.quarantined},
            "history_cap": self.history_cap,
            "engine": self.engine_label,
            "queue_depth": self._queued,
            "queue_peak": self.queue_peak,
            "inflight": self._inflight,
            "shed": self.shed,
            "cancelled": self.cancelled,
            "deadline_missed": self.deadline_missed,
            "scheduler_running": self._scheduler_alive(),
            "sec_per_work_unit": self._sec_per_unit,
            "ring": {
                "depth": self.ring_depth,
                "hits": sum(rg.hits for rg in self._rings.values()),
                "misses": sum(rg.misses for rg in self._rings.values()),
            },
            "admission": {
                "mode": self.admission,
                "max_queue": self.max_queue,
                "max_queue_per_bucket": self.max_queue_per_bucket,
                "tenant_quota": self.tenant_quota,
                "tenant_max_inflight": self.tenant_max_inflight,
                "deadline_shedding": self.deadline_shedding,
            },
            "tenants": {name: ts.snapshot()
                        for name, ts in sorted(self._tenants.items())},
            "p50_latency_s": self._m_latency.quantile(0.50, eng),
            "p99_latency_s": self._m_latency.quantile(0.99, eng),
            "drift": [f.as_dict() for f in self.drift.findings("wall")],
        }
