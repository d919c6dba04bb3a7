"""Request-scoped tracing: spans + instant events on one timeline.

The port's own copy of ``repro/obs/trace.py`` (pure Python; the port
imports nothing of the JAX package).

The flight-recorder layer of the observability stack (DESIGN.md §14): a
thread-safe span API whose events land in a bounded ring buffer and
export to Chrome trace-event JSON (loadable in Perfetto / chrome://tracing)
and JSONL.

Design constraints, in order:

1. **Near-zero cost when disabled.**  Every hook in the serving hot path
   goes through the module-level helpers (:func:`span`, :func:`instant`,
   :func:`add_span`), which are a single attribute check when the tracer
   is off — no allocation, no lock, no timestamp read.  The default
   tracer starts disabled; chaos drills and ``--trace-out`` runs enable
   it.
2. **Request-scoped.**  A span carries a ``trace_id`` (the serving layer
   threads the request uid); children inherit it from the enclosing span
   (per-thread stack), so one request's submit → queue-wait → execute →
   verify → done chain is reconstructible from the buffer even though
   the events were emitted from batch-level code.
3. **Bounded.**  The buffer is a ring (``capacity`` events, default
   65536): a long-running service records the *recent* past, the flight
   recorder discipline, rather than growing without bound.
4. **Retroactive spans.**  Batch serving knows a request's queue wait
   only once the batch starts; :func:`add_span` emits a span with
   explicit start/end timestamps after the fact — Chrome trace events
   carry their own ``ts``/``dur``, so the export is indistinguishable
   from a live span.

All timestamps are ``time.perf_counter()`` (monotonic); the export
rebases them to microseconds since the tracer's epoch.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = [
    "TraceEvent", "Span", "Tracer", "get_tracer", "set_tracer",
    "span", "instant", "add_span", "tracing_enabled",
    "disabled_hook_cost",
]


@dataclass
class TraceEvent:
    """One recorded event: a completed span (``ph="X"``) or an instant
    (``ph="i"``)."""
    name: str
    ph: str                      # "X" complete span | "i" instant
    t0: float                    # perf_counter seconds
    t1: float                    # == t0 for instants
    span_id: int
    parent_id: Optional[int]
    trace_id: Optional[int]      # request uid (or None for engine-level)
    tid: int                     # thread ident
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0


class Span:
    """A live span: context manager handed out by :meth:`Tracer.span`.

    ``annotate(**attrs)`` attaches attributes any time before exit;
    ``trace_id`` is inherited by child spans and instants opened on the
    same thread while this span is current.
    """

    __slots__ = ("_tracer", "name", "span_id", "parent_id", "trace_id",
                 "attrs", "t0")

    def __init__(self, tracer: "Tracer", name: str,
                 trace_id: Optional[int], attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.span_id = tracer._next_id()
        self.parent_id: Optional[int] = None
        self.trace_id = trace_id
        self.attrs = attrs
        self.t0 = 0.0

    def annotate(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        stack = self._tracer._stack()
        if stack:
            parent = stack[-1]
            self.parent_id = parent.span_id
            if self.trace_id is None:
                self.trace_id = parent.trace_id
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:                  # tolerate exotic unwinding
            stack.remove(self)
        if exc_type is not None:
            self.attrs.setdefault("error", f"{exc_type.__name__}: {exc}")
        self._tracer._record(TraceEvent(
            name=self.name, ph="X", t0=self.t0, t1=t1,
            span_id=self.span_id, parent_id=self.parent_id,
            trace_id=self.trace_id, tid=threading.get_ident(),
            attrs=self.attrs))
        return False


class _NullSpan:
    """The disabled-path span: every operation a no-op, one shared
    instance — ``span()`` on a disabled tracer allocates nothing."""

    __slots__ = ()
    name = ""
    span_id = -1
    parent_id = None
    trace_id = None
    attrs: Dict[str, Any] = {}

    def annotate(self, **attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Thread-safe span/instant recorder over a bounded ring buffer."""

    def __init__(self, *, enabled: bool = False, capacity: int = 65536):
        self.enabled = enabled
        self.capacity = capacity
        self._buf: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self.epoch = time.perf_counter()
        self.dropped = 0            # events evicted by the ring bound

    # -- internals --------------------------------------------------------
    def _next_id(self) -> int:
        with self._lock:
            return next(self._ids)

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _record(self, ev: TraceEvent) -> None:
        with self._lock:
            if len(self._buf) == self.capacity:
                self.dropped += 1
            self._buf.append(ev)

    # -- recording API ----------------------------------------------------
    def span(self, name: str, *, trace_id: Optional[int] = None,
             **attrs) -> Span:
        """Context manager for a timed span.  When the tracer is
        disabled, returns the shared no-op span."""
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name, trace_id, attrs)

    def instant(self, name: str, *, trace_id: Optional[int] = None,
                **attrs) -> None:
        """One point-in-time event (fault firing, guard veto, rung
        transition) on the same timeline as the spans."""
        if not self.enabled:
            return
        stack = self._stack()
        parent = stack[-1] if stack else None
        if trace_id is None and parent is not None:
            trace_id = parent.trace_id
        now = time.perf_counter()
        self._record(TraceEvent(
            name=name, ph="i", t0=now, t1=now, span_id=self._next_id(),
            parent_id=parent.span_id if parent else None,
            trace_id=trace_id, tid=threading.get_ident(), attrs=attrs))

    def instant_at(self, name: str, t: float, *,
                   trace_id: Optional[int] = None, **attrs) -> None:
        """An instant with an explicit ``perf_counter`` timestamp — for
        moments only recognized after the fact (a deadline miss is
        stamped at the deadline, not at detection).  Parentless, like
        ``add_span``: the emitting thread's stack is not the context the
        moment happened in."""
        if not self.enabled:
            return
        self._record(TraceEvent(
            name=name, ph="i", t0=t, t1=t, span_id=self._next_id(),
            parent_id=None, trace_id=trace_id,
            tid=threading.get_ident(), attrs=attrs))

    def add_span(self, name: str, t0: float, t1: float, *,
                 trace_id: Optional[int] = None, **attrs) -> None:
        """Record a span with explicit ``perf_counter`` endpoints — for
        intervals only known after the fact (queue wait, request
        lifetime)."""
        if not self.enabled:
            return
        self._record(TraceEvent(
            name=name, ph="X", t0=t0, t1=max(t1, t0),
            span_id=self._next_id(), parent_id=None, trace_id=trace_id,
            tid=threading.get_ident(), attrs=attrs))

    # -- introspection / export -------------------------------------------
    def events(self) -> List[TraceEvent]:
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dropped = 0

    def __len__(self) -> int:
        return len(self._buf)

    def _us(self, t: float) -> float:
        return (t - self.epoch) * 1e6

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON object (``{"traceEvents": [...]}``),
        loadable in Perfetto / chrome://tracing.

        Events are sorted by timestamp (the ring buffer holds them in
        *completion* order — a parent span completes after its children),
        so ``ts`` is monotonic per thread in the export.  ``pid`` is the
        constant serving process; ``tid`` the emitting thread; the
        request uid rides in ``args.trace_id``.
        """
        evs = sorted(self.events(), key=lambda e: e.t0)
        out = []
        for e in evs:
            args = {k: _jsonable(v) for k, v in e.attrs.items()}
            if e.trace_id is not None:
                args["trace_id"] = e.trace_id
            rec = {
                "name": e.name,
                "ph": e.ph,
                "ts": self._us(e.t0),
                "pid": 1,
                "tid": e.tid % (1 << 31),
                "args": args,
            }
            if e.ph == "X":
                rec["dur"] = max((e.t1 - e.t0) * 1e6, 0.001)
            else:
                rec["s"] = "t"           # thread-scoped instant
            out.append(rec)
        return {"traceEvents": out,
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def write_chrome_trace(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def to_jsonl(self) -> str:
        """One JSON object per event, chronological — the grep-friendly
        export."""
        lines = []
        for e in sorted(self.events(), key=lambda ev: ev.t0):
            lines.append(json.dumps({
                "name": e.name, "ph": e.ph,
                "ts_us": self._us(e.t0),
                "dur_us": (e.t1 - e.t0) * 1e6 if e.ph == "X" else 0.0,
                "span_id": e.span_id, "parent_id": e.parent_id,
                "trace_id": e.trace_id, "tid": e.tid % (1 << 31),
                "attrs": {k: _jsonable(v) for k, v in e.attrs.items()},
            }))
        return "\n".join(lines) + ("\n" if lines else "")

    def write_jsonl(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return str(v)


# ---------------------------------------------------------------------------
# The process-wide tracer + the hot-path helpers.
# ---------------------------------------------------------------------------

_TRACER = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _TRACER


def set_tracer(tracer: Optional[Tracer]) -> Tracer:
    """Install a tracer as the process-wide one (None resets to a fresh
    disabled tracer).  Returns the installed tracer."""
    global _TRACER
    _TRACER = tracer if tracer is not None else Tracer(enabled=False)
    return _TRACER


def tracing_enabled() -> bool:
    return _TRACER.enabled


def span(name: str, *, trace_id: Optional[int] = None, **attrs):
    """Module-level hot-path hook: one attribute check when disabled."""
    t = _TRACER
    if not t.enabled:
        return _NULL_SPAN
    return Span(t, name, trace_id, attrs)


def instant(name: str, *, trace_id: Optional[int] = None, **attrs) -> None:
    t = _TRACER
    if not t.enabled:
        return
    t.instant(name, trace_id=trace_id, **attrs)


def instant_at(name: str, at: float, *,
               trace_id: Optional[int] = None, **attrs) -> None:
    t = _TRACER
    if not t.enabled:
        return
    t.instant_at(name, at, trace_id=trace_id, **attrs)


def add_span(name: str, t0: float, t1: float, *,
             trace_id: Optional[int] = None, **attrs) -> None:
    t = _TRACER
    if not t.enabled:
        return
    t.add_span(name, t0, t1, trace_id=trace_id, **attrs)


def disabled_hook_cost(n: int = 20000) -> float:
    """Measured seconds per *disabled* ``span()`` hook (enter + exit) —
    the unit cost the <2% tracer-overhead acceptance bound is derived
    from (hooks-per-request x this, over the per-request wall)."""
    saved = _TRACER.enabled
    try:
        _TRACER.enabled = False
        t0 = time.perf_counter()
        for _ in range(n):
            with span("probe"):
                pass
        dt = time.perf_counter() - t0
    finally:
        _TRACER.enabled = saved
    return dt / n
