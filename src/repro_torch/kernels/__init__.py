"""Hand-written Hopper kernels of the port, with their plain versions.

- strassen_fused: the leaf-program executor (``csrc/leaf_program.cu``,
                  ata kind) behind ``ops.ata_fused[_packed]``
- ref:            plain torch oracles
"""
from . import ops, ref
from .ops import ata_fused, ata_fused_packed

__all__ = ["ops", "ref", "ata_fused", "ata_fused_packed"]
