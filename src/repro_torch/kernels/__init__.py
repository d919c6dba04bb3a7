"""Hand-written Hopper kernels of the port, with their plain versions.

- strassen_fused: the leaf-program executor (``csrc/leaf_products.cu``
                  for every kind and every gram) behind
                  ``ops.ata_fused[_packed]``, ``ops.symm_matmul``,
                  ``ops.aat_fused[_packed]``, ``ops.rank_k_update`` and
                  ``ops.matmul_fused``
- syrk:           packed lower-triangular A^t A tiles (``csrc/syrk.cu``)
                  behind ``ops.syrk[_packed]`` and ``kernel_base_syrk``
- matmul:         the tiled product (``csrc/matmul.cu``) behind
                  ``ops.matmul`` and ``kernel_base_matmul``
- combine:        Strassen's recombination in one pass
                  (``csrc/combine.cu``) behind ``ops.strassen_combine``
- transpose:      the tiled transpose (``csrc/transpose.cu``) behind
                  ``ops.transpose``
- flash_attention: online-softmax GQA attention
                  (``csrc/flash_attention.cu``) behind ``ops.flash_mha``
- ref:            plain torch oracles
"""
from . import ops, ref
from .ops import (matmul, syrk_packed, syrk, strassen_combine, transpose,
                  kernel_base_matmul, kernel_base_syrk, ata_fused,
                  ata_fused_packed, symm_matmul, aat_fused, aat_fused_packed,
                  rank_k_update, matmul_fused, flash_mha)

__all__ = ["ops", "ref", "matmul", "syrk_packed", "syrk", "strassen_combine",
           "transpose", "kernel_base_matmul", "kernel_base_syrk", "ata_fused",
           "ata_fused_packed", "symm_matmul", "aat_fused", "aat_fused_packed",
           "rank_k_update", "matmul_fused", "flash_mha"]
