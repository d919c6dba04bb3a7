"""Core library of the port: the paper's Strassen-based A^tA in torch."""
from .ata import ata, ata_full, ata_levels_for
from .strassen import strassen_matmul, strassen_levels_for
from .symmetry import (
    pack_tril, unpack_tril, pack_tril_blocks, unpack_tril_blocks,
    tril_vector_from_blocks,
    symmetrize_from_lower, tri_count, tri_index, tri_coords,
)
from .leaf_ir import (
    compile_program, interpret_program, register_algebra,
    registered_algebras, import_algebras, PROGRAM_KINDS,
)
from . import leaf_ir

__all__ = [
    "ata", "ata_full", "ata_levels_for",
    "strassen_matmul", "strassen_levels_for", "leaf_ir",
    "compile_program", "interpret_program", "register_algebra",
    "registered_algebras", "import_algebras", "PROGRAM_KINDS",
    "pack_tril", "unpack_tril", "pack_tril_blocks", "unpack_tril_blocks",
    "tril_vector_from_blocks",
    "symmetrize_from_lower", "tri_count", "tri_index", "tri_coords",
]
