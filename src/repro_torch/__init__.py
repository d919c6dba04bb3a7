"""repro_torch: the PyTorch / H100 port of the Strassen-based A^tA library.

A package beside ``repro`` (the JAX reference), module for module.  It
imports torch and numpy, never jax and nothing of ``repro``.
"""
__version__ = "0.1.0"
