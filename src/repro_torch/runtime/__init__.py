"""Runtime of the port: the serving engine.

Exports resolve lazily (PEP 562), as in the JAX package, so importing
the package loads no model code.  The trainer and fault injection come
with the training slice (ROADMAP.md Queue 1 #11).
"""
_EXPORTS = {"ServingEngine": "serving", "Request": "serving"}

__all__ = [*_EXPORTS]


def __getattr__(name):
    import importlib
    if name in _EXPORTS:
        mod = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
