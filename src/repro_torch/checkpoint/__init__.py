"""Checkpoints of the port: atomic, async, keep-K, in the JAX package's
format (``repro/checkpoint``)."""
from .manager import CheckpointManager, save_pytree, load_pytree  # noqa: F401

__all__ = ["CheckpointManager", "save_pytree", "load_pytree"]
