"""Observability for the port: the flight recorder of the Gram service.

The port of ``repro/obs``, three layers on one timeline:

- ``trace``   — request-scoped spans and instant events (``gram.verify``
                records its vetoes there, the checkpointed stream its
                restores and commits, the engine every request's
                lifecycle);
- ``metrics`` — counters, gauges and histograms (the engine's serving
                counts, the checkpointed stream's commits);
- ``drift``   — online cost-model drift detection: an EWMA of the
                measured/predicted ratio per bucket, findings when a
                bucket leaves the ``[1/theta, theta]`` band.
"""
from . import drift, metrics, trace  # noqa: F401
from .drift import DriftDetector, DriftFinding  # noqa: F401
from .metrics import (  # noqa: F401
    MetricsRegistry, counter, gauge, histogram, get_registry,
    render_prometheus, snapshot,
)
from .trace import (  # noqa: F401
    Tracer, get_tracer, set_tracer, span, instant, add_span,
    tracing_enabled,
)

__all__ = [
    "trace", "metrics", "drift",
    "Tracer", "get_tracer", "set_tracer", "span", "instant", "add_span",
    "tracing_enabled",
    "MetricsRegistry", "counter", "gauge", "histogram", "get_registry",
    "render_prometheus", "snapshot",
    "DriftDetector", "DriftFinding",
]
