"""Observability for the port: the flight recorder's tracer.

The port of ``repro/obs``.  Only ``trace`` so far (``gram.verify``
records its vetoes there); ``metrics`` and ``drift`` come with the
serving layers that use them.
"""
from . import trace  # noqa: F401
from .trace import (  # noqa: F401
    Tracer, get_tracer, set_tracer, span, instant, add_span,
    tracing_enabled,
)

__all__ = ["trace", "Tracer", "get_tracer", "set_tracer", "span", "instant",
           "add_span", "tracing_enabled"]
