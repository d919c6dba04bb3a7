"""Observability for the port: the flight recorder's tracer and the
metrics registry.

The port of ``repro/obs``: ``trace`` (spans and instant events;
``gram.verify`` records its vetoes there, the checkpointed stream its
restores and commits) and ``metrics`` (counters, gauges, histograms; the
checkpointed stream counts its commits there).  ``drift`` comes with the
serving layer that uses it.
"""
from . import metrics, trace  # noqa: F401
from .metrics import (  # noqa: F401
    MetricsRegistry, counter, gauge, histogram, get_registry,
    render_prometheus, snapshot,
)
from .trace import (  # noqa: F401
    Tracer, get_tracer, set_tracer, span, instant, add_span,
    tracing_enabled,
)

__all__ = ["trace", "metrics", "Tracer", "get_tracer", "set_tracer", "span",
           "instant", "add_span", "tracing_enabled", "MetricsRegistry",
           "counter", "gauge", "histogram", "get_registry",
           "render_prometheus", "snapshot"]
