"""Leaf-task schedules — thin wrappers over the port's leaf IR.

The port of ``repro/core/schedule.py``, copied over
``repro_torch.core.leaf_ir``.  The ``plan_*`` / ``evaluate_*`` names are
the ones the JAX package's tests and call sites use; ``evaluate_symm_plan``
is the symm program's dense float64 oracle.  New code should target
:mod:`repro_torch.core.leaf_ir` directly.

``Plan`` is an alias of :class:`LeafProgram`; operand terms are
4-tuples ``(row, col, sign, trans)``.
"""
from __future__ import annotations

import numpy as np

from .leaf_ir import (
    Contribution, LeafOp, LeafProgram, compile_program, interpret_program,
)

Plan = LeafProgram
Product = LeafOp

__all__ = [
    "Product", "Contribution", "Plan",
    "plan_ata", "plan_matmul", "plan_symm",
    "evaluate_ata_plan", "evaluate_matmul_plan", "evaluate_symm_plan",
]


def plan_ata(levels: int, variant: str = "strassen") -> Plan:
    """Flatten Algorithm 1 (ATA) into leaf ops over a 2^levels grid."""
    return compile_program("ata", levels, variant)


def plan_matmul(levels: int, variant: str = "strassen") -> Plan:
    """Flatten (level-capped) Strassen C = A @ B into leaf ops."""
    return compile_program("matmul", levels, variant)


def plan_symm(levels: int, variant: str = "strassen") -> Plan:
    """Flatten ``D = X @ Sym`` (Sym symmetric, stored lower-tri only)."""
    return compile_program("symm", levels, variant)


def evaluate_ata_plan(plan: Plan, a: np.ndarray) -> np.ndarray:
    """Dense numpy execution of an ATA program: lower triangle of a^T a.

    ``a`` must be pre-padded to a multiple of ``plan.blocks`` in both dims.
    """
    return interpret_program(plan, a)


def evaluate_symm_plan(plan: Plan, x: np.ndarray,
                       sym_lower: np.ndarray) -> np.ndarray:
    """Dense numpy execution of a symm program: ``x @ Sym`` where ``Sym``
    is the symmetric completion of ``sym_lower`` (its strict upper
    triangle is never read — the packed-storage contract)."""
    assert plan.kind == "symm", plan.kind
    return interpret_program(plan, x, sym_lower)


def evaluate_matmul_plan(plan: Plan, a: np.ndarray,
                         b: np.ndarray) -> np.ndarray:
    """Dense numpy execution of a matmul program: a @ b (pre-padded)."""
    return interpret_program(plan, a, b)
