"""Hand-written Hopper kernels of the port, with their plain versions.

- strassen_fused: the leaf-program executor (``csrc/leaf_program.cu``,
                  ata, symm, aat, rank_k and matmul kinds) behind
                  ``ops.ata_fused[_packed]``, ``ops.symm_matmul``,
                  ``ops.aat_fused[_packed]``, ``ops.rank_k_update`` and
                  ``ops.matmul_fused``
- ref:            plain torch oracles
"""
from . import ops, ref
from .ops import (ata_fused, ata_fused_packed, symm_matmul, aat_fused,
                  aat_fused_packed, rank_k_update, matmul_fused)

__all__ = ["ops", "ref", "ata_fused", "ata_fused_packed", "symm_matmul",
           "aat_fused", "aat_fused_packed", "rank_k_update", "matmul_fused"]
