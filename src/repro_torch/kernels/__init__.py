"""Hand-written Hopper kernels of the port, with their plain versions.

- strassen_fused: the leaf-program executor (``csrc/leaf_program.cu``,
                  ata and symm kinds) behind ``ops.ata_fused[_packed]``
                  and ``ops.symm_matmul``
- ref:            plain torch oracles
"""
from . import ops, ref
from .ops import ata_fused, ata_fused_packed, symm_matmul

__all__ = ["ops", "ref", "ata_fused", "ata_fused_packed", "symm_matmul"]
