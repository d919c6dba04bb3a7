"""Process-wide metrics registry: counters, gauges, log-bucketed histograms.

The port's own copy of ``repro/obs/metrics.py`` (pure Python; the port
imports nothing of the JAX package).

The second observability layer (DESIGN.md §14): every serving-path count
the engine used to keep as an ad-hoc attribute — queue depth, batch fill
fraction, recompiles, cache hits, guard vetoes, retries, per-rung served
counts — lands in ONE registry, labeled by the dimensions the Gram
service actually varies over: ``(bucket, dtype, gram_of, scheme, rung)``.

Three instrument kinds:

- :class:`Counter` — monotone; ``inc(amount, **labels)``.
- :class:`Gauge`   — settable; ``set(v, **labels)`` / ``inc`` / ``dec``.
- :class:`Histogram` — **log-bucketed**: bucket ``k`` holds values in
  ``[lo * base^k, lo * base^(k+1))``.  An observation is one integer
  increment, so percentile reads are O(num_buckets) and *updates are
  O(1)* — the property ``GramEngine.stats()`` needs to stop re-sorting
  its full latency history on every call.  Quantiles interpolate
  geometrically inside the winning bucket (exact to within one bucket
  ratio, base 2^(1/4) ≈ 19% by default — telemetry resolution, not
  measurement resolution).

Labeled children are created on first touch; a label *schema* is pinned
by the first observation (inconsistent label names raise — silent label
drift makes snapshots unmergeable).  ``snapshot()`` returns a plain
nested dict; :func:`render_prometheus` emits the Prometheus text format
(counters get a ``_total`` suffix; histograms export ``_bucket`` /
``_sum`` / ``_count`` with cumulative ``le`` edges).

The module-level registry is process-wide by design — one scrape shows
every engine in the process; per-engine views label their series with an
``engine`` id.  Tests isolate themselves with :func:`reset` or a local
:class:`MetricsRegistry`.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "set_registry", "counter", "gauge", "histogram",
    "snapshot", "render_prometheus", "reset",
]

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(names: Tuple[str, ...], labels: dict) -> _LabelKey:
    if tuple(sorted(labels)) != names:
        raise ValueError(
            f"label names {tuple(sorted(labels))} do not match the "
            f"metric's schema {names}")
    return tuple((k, str(labels[k])) for k in names)


class _Metric:
    """Shared label-handling core."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._names: Optional[Tuple[str, ...]] = None   # pinned on 1st use
        self._series: Dict[_LabelKey, object] = {}

    def _key(self, labels: dict) -> _LabelKey:
        if self._names is None:
            self._names = tuple(sorted(labels))
        return _label_key(self._names, labels)

    def series(self) -> Dict[_LabelKey, object]:
        with self._lock:
            return dict(self._series)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            k = self._key(labels)
            self._series[k] = self._series.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            if self._names is None:
                return 0.0
            return self._series.get(_label_key(self._names, labels), 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._series.values())


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        with self._lock:
            k = self._key(labels)
            self._series[k] = self._series.get(k, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            if self._names is None:
                return 0.0
            return self._series.get(_label_key(self._names, labels), 0.0)


class _HistSeries:
    __slots__ = ("counts", "sum", "count", "min", "max")

    def __init__(self, nbuckets: int):
        self.counts = [0] * (nbuckets + 2)   # [underflow] + buckets + [over]
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf


class Histogram(_Metric):
    """Log-bucketed histogram: O(1) observe, O(buckets) quantile.

    ``lo`` is the lower edge of the first bucket, ``hi`` the upper edge
    of the last; values outside land in under/overflow buckets whose
    quantile estimate clamps to the edge.  Defaults cover 1µs..~1000s at
    2^(1/4) resolution — the serving latency range.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "", *, lo: float = 1e-6,
                 hi: float = 1e3, base: float = 2 ** 0.25):
        super().__init__(name, help)
        if not (lo > 0 and hi > lo and base > 1):
            raise ValueError("need 0 < lo < hi and base > 1")
        self.lo, self.base = lo, base
        self.nbuckets = int(math.ceil(math.log(hi / lo, base)))
        # upper edges, ascending
        self.edges = [lo * base ** (k + 1) for k in range(self.nbuckets)]

    def _bucket(self, v: float) -> int:
        """Index into the counts array (0 = underflow, nbuckets+1 = over)."""
        if v < self.lo:
            return 0
        idx = int(math.log(v / self.lo, self.base))
        return min(idx, self.nbuckets - 1) + 1 \
            if idx < self.nbuckets else self.nbuckets + 1

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        with self._lock:
            k = self._key(labels)
            s = self._series.get(k)
            if s is None:
                s = self._series[k] = _HistSeries(self.nbuckets)
            s.counts[self._bucket(v)] += 1
            s.sum += v
            s.count += 1
            s.min = min(s.min, v)
            s.max = max(s.max, v)

    def _merged(self, labels: Optional[dict]) -> Optional[_HistSeries]:
        """Merge every series whose labels are a superset of ``labels``
        (``None`` / ``{}`` merges all) — so a per-engine percentile is
        ``quantile(q, {"engine": "e0"})`` over (engine, bucket) series."""
        with self._lock:
            want = tuple((k, str(v)) for k, v in sorted((labels or {}).items()))
            picked = [s for key, s in self._series.items()
                      if all(kv in key for kv in want)]
            if not picked:
                return None
            if len(picked) == 1:
                return picked[0]
            out = _HistSeries(self.nbuckets)
            for s in picked:
                out.counts = [a + b for a, b in zip(out.counts, s.counts)]
                out.sum += s.sum
                out.count += s.count
                out.min = min(out.min, s.min)
                out.max = max(out.max, s.max)
            return out

    def quantile(self, q: float, labels: Optional[dict] = None
                 ) -> Optional[float]:
        """q-quantile estimate (geometric interpolation inside the
        winning bucket).  ``labels=None`` merges every labeled series —
        the engine-wide percentile."""
        s = self._merged(labels)
        if s is None or s.count == 0:
            return None
        rank = q * (s.count - 1)
        acc = 0
        for i, c in enumerate(s.counts):
            if c == 0:
                continue
            acc += c
            # bucket i covers sorted indices [acc - c, acc); take the
            # bucket holding index ceil(rank) (upper nearest-rank)
            if acc - 1 >= rank:
                if i == 0:
                    return s.min if math.isfinite(s.min) else self.lo
                if i == self.nbuckets + 1:
                    return s.max if math.isfinite(s.max) else self.edges[-1]
                hi = self.edges[i - 1]
                lo = hi / self.base
                est = math.sqrt(lo * hi)
                # clamp to the observed range: a one-sample histogram
                # must answer with that sample's bucket, not beyond it
                return min(max(est, s.min), s.max)
        return s.max

    def count(self, labels: Optional[dict] = None) -> int:
        s = self._merged(labels)
        return 0 if s is None else s.count

    def sum(self, labels: Optional[dict] = None) -> float:
        s = self._merged(labels)
        return 0.0 if s is None else s.sum


class MetricsRegistry:
    """Name -> instrument map; instruments are created on first request
    and must keep their kind (a ``counter`` name cannot be re-registered
    as a gauge)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "", **kw) -> Histogram:
        return self._get(Histogram, name, help, **kw)

    def metrics(self) -> Dict[str, _Metric]:
        with self._lock:
            return dict(self._metrics)

    # -- export -----------------------------------------------------------
    def snapshot(self) -> dict:
        """Plain nested dict of every series:
        ``{name: {kind, help, series: {label-string: value-or-hist}}}``."""
        out = {}
        for name, m in sorted(self.metrics().items()):
            series = {}
            for key, v in m.series().items():
                lbl = ",".join(f"{k}={val}" for k, val in key) or ""
                if isinstance(v, _HistSeries):
                    series[lbl] = {"count": v.count, "sum": v.sum,
                                   "min": v.min if v.count else None,
                                   "max": v.max if v.count else None}
                else:
                    series[lbl] = v
            out[name] = {"kind": m.kind, "help": m.help, "series": series}
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition of the whole registry."""
        lines: List[str] = []
        for name, m in sorted(self.metrics().items()):
            pname = name + ("_total" if m.kind == "counter"
                            and not name.endswith("_total") else "")
            if m.help:
                lines.append(f"# HELP {pname} {m.help}")
            lines.append(f"# TYPE {pname} {m.kind}")
            for key, v in sorted(m.series().items()):
                lbl = ",".join(f'{k}="{val}"' for k, val in key)
                if isinstance(v, _HistSeries):
                    acc = 0
                    for i, edge in enumerate(m.edges):
                        acc += v.counts[i + 1] + (v.counts[0] if i == 0
                                                 else 0)
                        le = f'le="{edge:g}"'
                        full = f"{lbl},{le}" if lbl else le
                        lines.append(f"{name}_bucket{{{full}}} {acc}")
                    le = 'le="+Inf"'
                    full = f"{lbl},{le}" if lbl else le
                    lines.append(f"{name}_bucket{{{full}}} {v.count}")
                    suffix = f"{{{lbl}}}" if lbl else ""
                    lines.append(f"{name}_sum{suffix} {v.sum:g}")
                    lines.append(f"{name}_count{suffix} {v.count}")
                else:
                    suffix = f"{{{lbl}}}" if lbl else ""
                    lines.append(f"{pname}{suffix} {v:g}")
        return "\n".join(lines) + ("\n" if lines else "")

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


# ---------------------------------------------------------------------------
# The process-wide registry + convenience accessors.
# ---------------------------------------------------------------------------

_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def set_registry(reg: Optional[MetricsRegistry]) -> MetricsRegistry:
    global _REGISTRY
    _REGISTRY = reg if reg is not None else MetricsRegistry()
    return _REGISTRY


def counter(name: str, help: str = "") -> Counter:
    return _REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "", **kw) -> Histogram:
    return _REGISTRY.histogram(name, help, **kw)


def snapshot() -> dict:
    return _REGISTRY.snapshot()


def render_prometheus() -> str:
    return _REGISTRY.render_prometheus()


def reset() -> None:
    _REGISTRY.clear()
