"""Runtime of the port: the training loop, the serving engine, and fault
injection (``runtime.faults``, which autotune's cache loader consults).

Exports resolve lazily (PEP 562), as in the JAX package: ``trainer``
pulls in the model, optimizer and checkpoint stack, and importing it
here would tax light consumers like the Gram service's fault hooks and
make an import cycle ``runtime -> trainer -> optim.shampoo -> gram ->
runtime.faults``.
"""
_EXPORTS = {
    "Trainer": "trainer", "TrainState": "trainer",
    "make_train_step": "trainer", "make_optimizer": "trainer",
    "StragglerWatchdog": "trainer", "FailureInjector": "trainer",
    "SimulatedFailure": "trainer",
    "ServingEngine": "serving", "Request": "serving",
}

__all__ = [*_EXPORTS, "faults"]


def __getattr__(name):
    import importlib
    if name in _EXPORTS:
        mod = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        return getattr(mod, name)
    if name == "faults":
        return importlib.import_module(".faults", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
