"""Analytic cost model from the paper (§3.1, §4.1, §5, §6).

The port's copy of ``repro/core/cost_model.py``: pure math, so the port
keeps its own copy rather than import the JAX package.  It serves the
benchmark harness (Figures 5-8: exec time, speedup, efficiency,
Karp-Flatt; the complexity claim (2/7) n^{log2 7}), autotune's pipelined
roofline score and ``distributed_gram(scheme="auto")``'s ranking.

What differs from the JAX package: the hardware constants.  The TPU
v5e's are gone; in their place stand one NVIDIA H100 SXM's data-sheet
figures at its 700 W limit (``H100_*``), and the flop rate of the
schemes' local work is the rate of the kernel that really runs it (the
fused leaf program widens every operand type to fp32 on the CUDA cores).
``GramCommCost.time`` and ``rank_gram_schemes`` take the link bandwidth
as ``link_bw`` (the JAX package's ``ici_bw``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

LOG2_7 = math.log2(7.0)


# ---------------------------------------------------------------------------
# §3.1 — operation counts
# ---------------------------------------------------------------------------

def strassen_mults(n: float) -> float:
    """Multiplications of Strassen's algorithm, O(n^{log2 7})."""
    return n ** LOG2_7


def ata_mults_bound(n: float) -> float:
    """Paper's upper bound on ATA multiplications: (2/7) n^{log2 7}."""
    return (2.0 / 7.0) * n ** LOG2_7


def classical_ata_mults(n: float, m: float | None = None) -> float:
    """Conventional A^tA products: n(n+1)/2 inner products of length m
    (paper quotes n^2(n+1)/2 for square)."""
    m = n if m is None else m
    return m * n * (n + 1) / 2.0


def classical_matmul_mults(n: float) -> float:
    return n ** 3


def ata_mults_exact(m: int, n: int, leaf: int = 32, levels: int | None = None,
                    _memo=None) -> int:
    """Exact multiplication count of Algorithm 1 with a given leaf size,
    by direct evaluation of the recursion (classical leaf: m*n^2 products
    for the full leaf gram — we count the tril-only leaf: m*n*(n+1)/2)."""
    if _memo is None:
        _memo = {}
    key = (m, n, levels)
    if key in _memo:
        return _memo[key]
    if (levels is not None and levels <= 0) or m <= leaf or n <= leaf:
        res = m * n * (n + 1) // 2
    else:
        m1, m2 = (m + 1) // 2, m // 2
        n1, n2 = (n + 1) // 2, n // 2
        lv = None if levels is None else levels - 1
        res = (
            ata_mults_exact(m1, n1, leaf, lv, _memo)
            + ata_mults_exact(m2, n1, leaf, lv, _memo)
            + ata_mults_exact(m1, n2, leaf, lv, _memo)
            + ata_mults_exact(m2, n2, leaf, lv, _memo)
            + strassen_mults_exact(n2, m1, n1, leaf, lv, _memo)
            + strassen_mults_exact(n2, m2, n1, leaf, lv, _memo)
        )
    _memo[key] = res
    return res


# ---------------------------------------------------------------------------
# Leaf-IR closed forms (core/leaf_ir.py): leaf-op and operand-term counts
# of every compiled program kind, as functions of the algebra table's two
# scalars — products per level t and max operand fan-in q — and, for gram
# kinds, the gram algebra's recursion shape (n_sym recursive Grams +
# n_mm general products per level).  The property suite
# (tests/test_leaf_ir.py) pins compile_program against these for every
# registered algebra x gram algebra x kind x levels 0-3.
# ---------------------------------------------------------------------------

def _algebra_scalars(variant: str) -> tuple[int, int]:
    """(products per level, max operand quadrant fan-in) of a registered
    algebra table — derived from the table itself so user-registered
    algebras are covered, but pure table inspection (no compilation)."""
    from .leaf_ir import get_algebra
    table = get_algebra(variant)
    t = len(table)
    q = max(max(len(a), len(b)) for a, b, _d in table)
    return t, q


def _gram_scalars(gram: str) -> tuple[int, int, int, int]:
    """(n_sym, n_mm, sym term fan-in, mm term fan-in) of a registered
    gram algebra — pure table inspection, like :func:`_algebra_scalars`."""
    from .leaf_ir import get_gram_algebra
    galg = get_gram_algebra(gram)
    n_sym, n_mm = len(galg["sym"]), len(galg["mm"])
    f_sym = max(len(terms) for terms, _d in galg["sym"])
    f_mm = max(max(len(lt), len(rt)) for lt, rt, _d in galg["mm"])
    return n_sym, n_mm, f_sym, f_mm


def ir_leaf_count(kind: str, levels: int, variant: str = "strassen",
                  gram: str = "strassen") -> int:
    """Leaf ops of ``compile_program(kind, levels, variant, gram=gram)``.

    matmul/symm: t^levels (one table row choice per level).
    Gram kinds (ata/aat/rank_k): G(l) = n_sym G(l-1) + n_mm t^(l-1),
    G(0) = 1 — the gram algebra's recursive Gram calls plus its general
    products expanded with the table (strassen-gram: 4 + 2 t^(l-1);
    dps: 2 + 3 t^(l-1), strictly fewer at every level).
    """
    t, _q = _algebra_scalars(variant)
    if kind in ("matmul", "symm"):
        return t ** levels
    if kind in ("ata", "aat", "rank_k"):
        n_sym, n_mm, _fs, _fm = _gram_scalars(gram)
        g = 1
        for lv in range(1, levels + 1):
            g = n_sym * g + n_mm * t ** (lv - 1)
        return g
    raise ValueError(f"unknown IR kind {kind!r}")


def ir_max_terms(kind: str, levels: int, variant: str = "strassen",
                 gram: str = "strassen") -> int:
    """Max operand-term fan-in of a compiled program: q^levels for
    matmul/symm.  Gram kinds: a depth-d sym chain compounds its term
    fan-in f_sym d times; an mm product spawned at depth d starts at
    f_sym^d * f_mm terms and expands the remaining levels-1-d splits at
    q per level (SYRK leaves stay at f_sym^levels).  The classic
    strassen-gram entry (f_sym = f_mm = 1) reduces to q^(levels-1)."""
    _t, q = _algebra_scalars(variant)
    if kind in ("matmul", "symm"):
        return q ** levels
    if kind in ("ata", "aat", "rank_k"):
        n_sym, _n_mm, f_sym, f_mm = _gram_scalars(gram)
        best = f_sym ** levels
        for d in range(levels):
            best = max(best, f_sym ** d * f_mm * q ** (levels - 1 - d))
        return best
    raise ValueError(f"unknown IR kind {kind!r}")


def gram_serve_work(m: int, n: int, *, gram_of: str = "cols",
                    leaf: int = 32, levels: int | None = None) -> int:
    """Admission-control work units for one serving-bucket Gram request:
    the exact leaf-product count of the recursion the engine will run
    (column gram, or the row gram for ``gram_of="rows"``).
    ``gram.engine``'s CoDel-style shedder and WFQ scheduler price queued
    work in these machine-independent units and convert to seconds with
    a measured seconds-per-unit EWMA."""
    if gram_of == "rows":
        return aat_mults_exact(m, n, leaf=leaf, levels=levels)
    return ata_mults_exact(m, n, leaf=leaf, levels=levels)


def aat_mults_exact(m: int, n: int, leaf: int = 32,
                    levels: int | None = None) -> int:
    """Exact multiplication count of the row-gram recursion (Arrigoni-
    Massini 2021, C = A A^t): AAT(A) = ATA(A^t) exactly, so the count is
    the column-gram count with the dimensions swapped."""
    return ata_mults_exact(n, m, leaf, levels)


def symm_leaf_count(levels: int, variant: str = "strassen") -> int:
    """Leaf products of a flattened ``X @ Sym`` schedule
    (``core.schedule.plan_symm``): one table-row choice per level, so
    t^levels with t the registered table's product count (7 for the
    fast square variants, 8 classical, 11 for <3,2,2> bb322, ...) —
    derived from the table itself, so user-registered algebras count
    correctly instead of being silently priced as Strassen."""
    t, _q = _algebra_scalars(variant)
    return t ** levels


def symm_mults_exact(m: int, n: int, levels: int,
                     variant: str = "strassen") -> int:
    """Exact multiplication count of the flattened ``X @ Sym`` schedule on
    an (m, n) x (n, n) problem with ``m``, ``n`` already padded to the
    per-axis leaf-grid multiples of the algebra's <dm, dk, dn> split
    (the executor's padded shape): each of the ``symm_leaf_count``
    leaves is an (m/Bm, n/Bn) x (n/Bn, n/Bn) product.  Matches
    ``schedule.plan_symm(levels).mult_count(mb, nb)``
    (tests/test_properties.py)."""
    from .leaf_ir import algebra_dims
    dm, _dk, dn = algebra_dims(variant)
    bm, bn = dm ** levels, dn ** levels
    if m % bm or n % bn:
        raise ValueError(f"shape ({m}, {n}) not padded to the "
                         f"({bm}, {bn}) leaf grid at {levels} levels")
    return symm_leaf_count(levels, variant) * (m // bm) * (n // bn) ** 2


def ata_bwd_mults_exact(m: int, n: int, leaf: int = 32,
                        levels: int | None = None) -> int:
    """Multiplications of the fused Gram backward ``dA = A (S + S^t)``
    (a level-capped Strassen (m, n) x (n, n) product over the packed
    cotangent — ``kernels.strassen_fused.fused_symm_matmul``)."""
    return strassen_mults_exact(m, n, n, leaf, levels)


def classical_ata_bwd_mults(m: float, n: float) -> float:
    """Dense-dot baseline backward: ``A @ (S + S^t)`` at m n^2 products
    (the 2 m n^2-flop path the fused backward replaces)."""
    return m * n * n


def strassen_mults_exact(m: int, k: int, n: int, leaf: int = 32,
                         levels: int | None = None, _memo=None) -> int:
    """Exact multiplication count of (level-capped) Strassen on (m,k)x(k,n)."""
    if _memo is None:
        _memo = {}
    key = ("s", m, k, n, levels)
    if key in _memo:
        return _memo[key]
    if (levels is not None and levels <= 0) or min(m, k, n) <= leaf:
        res = m * k * n
    else:
        mp, kp, np_ = (m + 1) // 2, (k + 1) // 2, (n + 1) // 2
        lv = None if levels is None else levels - 1
        res = 7 * strassen_mults_exact(mp, kp, np_, leaf, lv, _memo)
    _memo[key] = res
    return res


# ---------------------------------------------------------------------------
# §4.1 — process-tree sizing
# ---------------------------------------------------------------------------

def npl(level: int) -> int:
    """Processes needed for `level` complete parallel levels (eq. 4)."""
    if level == 0:
        return 1
    if level == 1:
        return 6
    return 6 * 4 ** (level - 1) + 2 * sum(
        4 ** k * 7 ** (level - 1 - k) for k in range(level - 1)
    )


def lmax(p: int) -> int:
    """Max complete parallel levels with P processes (eq. 5)."""
    level = 0
    while npl(level + 1) <= p:
        level += 1
    return level


# ---------------------------------------------------------------------------
# §5 — communication model (latency + bandwidth along the critical path)
# ---------------------------------------------------------------------------

def latency_messages(p: int) -> int:
    """L(n, P): message count along the critical path."""
    lm = lmax(p)
    return max(4 * max(lm - 1, 0), 3 * lm)


def bandwidth_words(n: int) -> float:
    """BW(n, P) = (n/2)^2 words (paper: max message size independent of P)."""
    return (n / 2.0) ** 2


def comm_time(n: int, p: int, alpha: float, beta: float) -> float:
    """alpha * L + beta * BW (paper §5)."""
    return alpha * latency_messages(p) + beta * bandwidth_words(n)


# ---------------------------------------------------------------------------
# §6 — performance-metric model (speedup / efficiency / Karp-Flatt)
# ---------------------------------------------------------------------------

@dataclass
class ParallelModel:
    """Critical-path execution-time model for ATA-P.

    T(P) = serial_frac*T1 + (1-serial_frac)*T1/work_share(P) + comm(n, P)

    where work_share(P) is the effective concurrency: with lmax complete
    levels the slowest path is a HASA-P chain (branching 7, the heaviest
    child — paper §6.3.1 notes ATA-P children idle while HASA-P children
    finish), so effective speedup of the compute phase at complete levels is
    work/critical-path-work. Between complete levels, extra processes only
    shave the incomplete level partially (paper Fig 5 plateaus).
    """
    t1: float              # measured/modeled serial time (seconds)
    n: int                 # matrix dimension
    alpha: float = 2e-6    # per-message latency (s) — Galileo-class IB
    beta: float = 1.3e-9   # per-word time (s) ~ 6 GB/s fp64 effective
    serial_frac: float = 0.004  # paper Fig 8: e small, ~0.4%

    def critical_path_fraction(self, p: int) -> float:
        """Fraction of total work on the critical path, from the recursion:
        one ATA level splits work into 4 ATA shares (4/14 of the FLOPs... we
        use the measured 2:7 cost ratio — each HASA call costs ~(7/2)x an ATA
        call at the same level, paper §6.3.1) onto 6 processes."""
        lm = lmax(p)
        if lm == 0:
            return 1.0
        # Work split at an ATA level: total = 4*w_ata + 2*w_hasa,
        # w_hasa = 3.5 * w_ata  => critical child share = 3.5/11.
        ata_child, hasa_child = 1.0 / 11.0, 3.5 / 11.0
        frac = 1.0
        for _ in range(lm):
            frac *= hasa_child  # HASA child dominates the level
        # At HASA sub-levels the 7 children split evenly (1/7 each), already
        # accounted: hasa_child at the next level = its own subtree split.
        # Incomplete level: leftover processes shave the critical path by the
        # pairing factor k+1 (paper §4.1) on the last level only.
        extra = p - npl(lm)
        if extra > 0:
            k = extra // npl(lm)
            if k > 0:
                frac /= (k + 1)
        return frac

    def time(self, p: int) -> float:
        if p <= 1:
            return self.t1
        frac = self.critical_path_fraction(p)
        t_par = self.serial_frac * self.t1 + (1 - self.serial_frac) * self.t1 * frac
        return t_par + comm_time(self.n, p, self.alpha, self.beta)

    def speedup(self, p: int) -> float:
        return self.t1 / self.time(p)

    def efficiency(self, p: int) -> float:
        return self.speedup(p) / p

    def karp_flatt(self, p: int) -> float:
        s = self.speedup(p)
        return (1.0 / s - 1.0 / p) / (1.0 - 1.0 / p)


# ---------------------------------------------------------------------------
# §4 + §5 — critical-path SIMULATOR of the ATA-P process tree
# ---------------------------------------------------------------------------

@dataclass
class SimParams:
    """Per-multiplication throughput + comm constants (Galileo-class).

    ``mem_contention``: Galileo nodes are 2x18-core Broadwell; when a node
    is fully populated, shared memory bandwidth roughly halves the
    per-process multiply-accumulate rate vs a lone process (STREAM-class
    scaling). The serial baseline T(1) runs uncontended, so parallel runs
    carry factor (1 + c*(min(P, cores)-1)/(cores-1)).
    """
    sec_per_mult: float = 6.7e-10   # fitted to Broadwell-node ATA serial rate
    alpha: float = 2e-6            # per-message latency (s)
    beta: float = 1.3e-9           # per-word transfer (s) ~6 GB/s fp64
    overhead: float = 0.04         # per-level fork/join + imbalance fraction
    mem_contention: float = 0.57   # full-node slowdown factor - 1
    cores_per_node: int = 36
    # paper §6.3.1: incomplete parallel levels leave ATA-P processes idle
    # while HASA-P children finish ("highest time difference ... P=12, 18")
    incomplete_overhead: float = 0.20
    # Algorithm 1 line 5 "Initialize A_ij" + the cache-oblivious transposes
    # of A12/A22 (§3) + C patching run in the parent BEFORE/AFTER forking —
    # a serial per-level term (copies/elem * 8 B at node memory bandwidth,
    # sharing the same contention factor). 6 copies/elem fitted; the three
    # constants (contention, copies, incomplete idle) are fitted ONCE
    # against {S(6), S(250), E(250)} and validated on everything else.
    init_copies_per_elem: float = 6.0
    mem_bw: float = 12e9


def simulate_ata_p(n: int, p: int, sp: SimParams = SimParams(),
                   leaf: int = 32, m: int | None = None) -> float:
    """Critical-path execution time of ATA-P(n, P) per the paper's process
    tree (§4): complete levels fan ATA->4xATA+2xHASA (6 procs) and
    HASA->7xHASA, lefties pair onto the heaviest children (HASA first,
    larger subproblems next); per ATA level 3 concurrent reductions + 2
    sends of (n/2)^2 words; per HASA level 4 reductions + 3 sends.
    """
    m = n if m is None else m
    memo: dict = {}
    # ranks spread evenly over ceil(P/cores) nodes (SLURM default)
    nodes = -(-p // sp.cores_per_node)
    per_node = p / nodes
    contention = 1.0 + sp.mem_contention * (per_node - 1) \
        / max(sp.cores_per_node - 1, 1)
    spm = sp.sec_per_mult * contention

    def w_ata(mm, nn):
        return ata_mults_exact(mm, nn, leaf, None, memo) * spm

    def w_hasa(mm, kk, nn):
        return strassen_mults_exact(mm, kk, nn, leaf, None, memo) * spm

    def split_ata(g):
        """Paper §4.1: ATA-P children get [npl(x)]*4 + [7^x]*2 processes
        for the deepest complete level x = lmax(g)-1; lefties pair k-each
        onto every process (multiplying each subtree), remainder goes to
        HASA children first, then larger subproblems."""
        level = lmax(g)
        base = [npl(level - 1)] * 4 + [7 ** (level - 1)] * 2
        total = npl(level)
        lefties = g - total
        k = lefties // total
        alloc = [b * (1 + k) for b in base]
        rem = lefties - k * total
        for i in (4, 5, 0, 1, 2, 3):       # HASA first, then ATA children
            take = min(rem, base[i])
            alloc[i] += take
            rem -= take
            if rem <= 0:
                break
        return alloc

    def split_hasa(g):
        level = 0
        while 7 ** (level + 1) <= g:
            level += 1
        base = [7 ** (level - 1) if level else 1] * 7
        total = 7 ** level
        lefties = g - total
        k = lefties // total
        alloc = [b * (1 + k) for b in base]
        rem = lefties - k * total
        for i in range(7):
            take = min(rem, base[i])
            alloc[i] += take
            rem -= take
        return alloc

    def lpt_makespan(jobs, g):
        """Whole-job LPT schedule of child subproblems on g processes —
        the paper's processes own whole recursive calls, so with fewer
        processes than children the binding constraint is the makespan,
        not work/g."""
        loads = [0.0] * g
        for w in sorted(jobs, reverse=True):
            loads[loads.index(min(loads))] += w
        return max(loads)

    def t_ata(mm, nn, g):
        if g <= 1 or mm <= leaf or nn <= leaf:
            return w_ata(mm, nn)
        m1, m2 = (mm + 1) // 2, mm // 2
        n1, n2 = (nn + 1) // 2, nn // 2
        kids = [("a", m1, n1), ("a", m2, n1), ("a", m1, n2), ("a", m2, n2),
                ("h", n2, m1, n1), ("h", n2, m2, n1)]
        if g < 6:
            # not enough for a complete level: whole child calls are
            # packed onto the g processes (LPT makespan) + the paper's
            # incomplete-level idle-wait penalty (§6.3.1)
            return lpt_makespan([_w(kid) for kid in kids], g) \
                * (1 + sp.overhead) * (1 + sp.incomplete_overhead)
        alloc = split_ata(g)
        t_kids = []
        for kid, gk in zip(kids, alloc):
            if kid[0] == "a":
                t_kids.append(t_ata(kid[1], kid[2], gk))
            else:
                t_kids.append(t_hasa(kid[1], kid[2], kid[3], gk))
        comm = 2 * sp.alpha + sp.beta * (nn / 2) ** 2   # 3 reduc + 2 sends,
        init = mm * nn * sp.init_copies_per_elem * 8 / sp.mem_bw * contention
        return (max(t_kids) + comm + init) * (1 + sp.overhead)

    def t_hasa(mm, kk, nn, g):
        if g <= 1 or min(mm, kk, nn) <= leaf:
            return w_hasa(mm, kk, nn)
        m2, k2, n2 = (mm + 1) // 2, (kk + 1) // 2, (nn + 1) // 2
        if g < 7:
            return lpt_makespan([w_hasa(m2, k2, n2)] * 7, g) \
                * (1 + sp.overhead) * (1 + sp.incomplete_overhead)
        alloc = split_hasa(g)
        t_kids = [t_hasa(m2, k2, n2, gk) for gk in alloc]
        comm = 3 * sp.alpha + sp.beta * (nn / 2) ** 2   # 4 reduc + 3 sends
        init = (mm * kk + kk * nn) * sp.init_copies_per_elem * 8 \
            / sp.mem_bw * contention
        return (max(t_kids) + comm + init) * (1 + sp.overhead)

    def _w(kid):
        if kid[0] == "a":
            return w_ata(kid[1], kid[2])
        return w_hasa(kid[1], kid[2], kid[3])

    return t_ata(m, n, p)


def simulate_metrics(n: int, ps, sp: SimParams = SimParams()) -> dict:
    """speedup / efficiency / Karp-Flatt across process counts."""
    t1 = simulate_ata_p(n, 1, sp)
    out = {"t1": t1, "rows": []}
    for p in ps:
        t = simulate_ata_p(n, p, sp)
        s = t1 / t
        e = s / p
        kf = (1.0 / s - 1.0 / p) / (1.0 - 1.0 / p) if p > 1 else 0.0
        out["rows"].append({"P": p, "time": t, "speedup": s,
                            "efficiency": e, "karp_flatt": kf})
    return out


# One NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the 700 W
# limit (a card set below it runs slower under load).
H100_FP32_FLOPS = 67e12           # fp32 on the CUDA cores (no TF32)
H100_TC16_FLOPS = 989e12          # bf16 / fp16 on the tensor cores
H100_HBM_BW = 3.35e12             # HBM3, bytes/s
H100_NVLINK_BW = 450e9            # NVLink 4, bytes/s per direction (900 GB/s
#                                   both ways)
# Per collective round (s): an ASSUMPTION of the order of NCCL's small-
# message latency over NVLink, not a measurement (one card is all this
# repository has measured on).
H100_LINK_LATENCY = 5e-6


def pipelined_bytes_score(read_bytes: float, write_bytes: float,
                          flops: float, *, pipeline_depth: int = 1,
                          grid_steps: int = 1,
                          flop_rate: float = H100_FP32_FLOPS,
                          hbm_bw: float = H100_HBM_BW) -> float:
    """Roofline score (HBM-byte-equivalents) of a bound leaf program under
    pipelining of its operand copies (DESIGN.md §16).

    Unpipelined (depth <= 1), each grid step serializes its operand
    copies against its products, so the cost is the SUM of the memory and
    compute terms.  With revolving buffers (depth >= 2) the next step's
    copies stream while the current step computes, so steady state pays
    the MAX of the two, plus one non-overlapped pipeline fill amortized
    over ``grid_steps``.  Compute is expressed in byte-equivalents
    (``flops * hbm_bw / flop_rate``) so the score stays comparable with
    the raw ``read_bytes + write_bytes`` ranking autotune used before
    this term existed.  The default rate is the fp32 CUDA-core peak: the
    fused leaf program computes in fp32 whatever its operand type."""
    mem = float(read_bytes) + float(write_bytes)
    cmp_eq = float(flops) * hbm_bw / flop_rate
    if pipeline_depth <= 1:
        return mem + cmp_eq
    fill = min(mem, cmp_eq) / max(int(grid_steps), 1)
    return max(mem, cmp_eq) + fill


# ---------------------------------------------------------------------------
# Distributed-gram communication model (beyond-paper; DESIGN.md §5).
#
# Per-device wire traffic and sequential message rounds of each
# ``core.distributed`` scheme, as closed forms in (m, n, R, T, c, dtype) —
# R = row-axis size, T = ring/col-axis size, c = replication factor.
# Collectives are costed with the standard ring algorithms (NCCL's ring
# all-reduce and reduce-scatter move these volumes):
#
#   all-reduce of V bytes over g devices:  2 V (g-1)/g   wire, 2(g-1) rounds
#   reduce-scatter:                          V (g-1)/g   wire,  (g-1) rounds
#   one ring hop (batch_isend_irecv):        V            wire,   1    round
#
# The per-device compute term (MAC flops) is included because the schemes
# engage different device counts on the same mesh: the row-only schemes
# leave the col/rep axes idle (replicated compute), the ring splits work
# R*T ways, and bfs25d splits the ring's block tasks a further c ways.
# ---------------------------------------------------------------------------

GRAM_SCHEMES = ("allreduce", "reducescatter", "ring", "bfs25d")


@dataclass
class GramCommCost:
    """Per-device cost of one distributed-gram scheme instance."""
    scheme: str
    devices: int            # devices engaged by the scheme's collectives
    wire_bytes: float       # per-device bytes on the wire (ring model)
    messages: int           # sequential collective rounds (latency term)
    flops: float            # per-device MAC flops (incl. duplicated work)
    mem_input_factor: int   # input replication (c for bfs25d, else 1)

    def time(self, *, alpha: float = H100_LINK_LATENCY,
             link_bw: float = H100_NVLINK_BW,
             flop_rate: float = H100_FP32_FLOPS) -> float:
        """alpha * rounds + bytes / link_bw + flops / rate."""
        return (alpha * self.messages + self.wire_bytes / link_bw
                + self.flops / flop_rate)


def gram_comm_cost(scheme: str, m: int, n: int, *, rows: int = 1,
                   ring: int | None = None, rep: int | None = None,
                   dtype_bytes: int = 4,
                   out_bytes: int | None = None) -> GramCommCost:
    """Cost of ``scheme`` for an (m, n) A on axis sizes (rows=R, ring=T,
    rep=c).  ``ring``/``rep`` are ignored by the schemes that do not use
    those axes (their compute is *replicated* there, which the flops term
    deliberately does not discount).

    ``dtype_bytes`` is the width of A — what the ring family's
    ring hops ship; ``out_bytes`` (default: same) is the wire width
    of C — what every reduction ships.  They differ when the caller
    reduces in a higher precision than the input (bf16 A, fp32 C), and
    charging both at the output width would overcharge the ring family's
    hop phase 2x."""
    R = max(int(rows), 1)
    b_in = float(dtype_bytes)
    b_out = float(dtype_bytes if out_bytes is None else out_bytes)
    total_macs = 2.0 * m * n * n / 2.0        # tril gram: ~m n^2 / 2 MACs x2

    if scheme == "allreduce":
        return GramCommCost(
            scheme=scheme, devices=R,
            wire_bytes=2.0 * n * n * b_out * (R - 1) / R,
            messages=2 * (R - 1),
            flops=total_macs / R, mem_input_factor=1)
    if scheme == "reducescatter":
        return GramCommCost(
            scheme=scheme, devices=R,
            wire_bytes=1.0 * n * n * b_out * (R - 1) / R,
            messages=R - 1,
            flops=total_macs / R, mem_input_factor=1)

    if ring is None or ring < 1:
        raise ValueError(f"scheme {scheme!r} needs ring=T")
    T = int(ring)
    half = T // 2
    m_loc, n_loc = m / R, n / T
    # per-device block work: diagonal ATA (~half the MACs of a full block
    # product) + `half` off-diagonal Strassen blocks, reduced over rows.
    blk_macs = 2.0 * m_loc * n_loc * n_loc

    if scheme == "ring":
        permute = half * m_loc * n_loc * b_in
        stack = (half + 1) * n_loc * n_loc * b_out
        return GramCommCost(
            scheme=scheme, devices=R * T,
            wire_bytes=permute + 2.0 * stack * (R - 1) / R,
            messages=half + 2 * (R - 1),
            flops=blk_macs * (half + 0.5), mem_input_factor=1)

    if scheme == "bfs25d":
        c = max(int(rep or 1), 1)
        n_off = -(-half // c)                 # ceil(half / c)
        g = c * R                             # merge-psum group size
        # one skew + (n_off - 1) stride-c hops = n_off permutes total
        permute = n_off * m_loc * n_loc * b_in
        stack = (half + 1) * n_loc * n_loc * b_out
        return GramCommCost(
            scheme=scheme, devices=R * T * c,
            wire_bytes=permute + 2.0 * stack * (g - 1) / g,
            messages=n_off + 2 * (g - 1),
            # each group: its n_off Strassen tasks + the duplicated diagonal
            flops=blk_macs * (n_off + 0.5), mem_input_factor=c)

    raise ValueError(f"unknown scheme {scheme!r}")


def rank_gram_schemes(m: int, n: int, *, rows: int = 1,
                      ring: int | None = None, rep: int | None = None,
                      dtype_bytes: int = 4,
                      out_bytes: int | None = None,
                      alpha: float = H100_LINK_LATENCY,
                      link_bw: float = H100_NVLINK_BW,
                      flop_rate: float | None = None,
                      schemes=None) -> list[GramCommCost]:
    """Feasibility-agnostic ranking (cheapest modeled time first) of the
    requested ``schemes`` (default: every scheme the axis sizes allow).

    ``flop_rate`` defaults to the rate of the kernel the schemes' local
    work runs: the fused leaf program widens every operand type (fp32,
    bf16, fp16, fp8) to fp32 before its products on the CUDA cores, so
    that is the fp32 CUDA-core peak, 67 TFLOP/s, whatever
    ``dtype_bytes`` is.  (The JAX package scales a bf16 peak by
    2/dtype_bytes, which matches its MXU, not this kernel.)"""
    if flop_rate is None:
        flop_rate = H100_FP32_FLOPS
    if schemes is None:
        schemes = ["allreduce", "reducescatter"]
        if ring:
            schemes.append("ring")
            if rep:
                schemes.append("bfs25d")
    costs = [gram_comm_cost(s, m, n, rows=rows, ring=ring, rep=rep,
                            dtype_bytes=dtype_bytes, out_bytes=out_bytes)
             for s in schemes]
    return sorted(costs, key=lambda cst: cst.time(
        alpha=alpha, link_bw=link_bw, flop_rate=flop_rate))


def choose_gram_scheme(m: int, n: int, **kw) -> str:
    """The cheapest scheme per :func:`rank_gram_schemes`."""
    return rank_gram_schemes(m, n, **kw)[0].scheme
