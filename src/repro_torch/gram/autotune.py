"""Per-bucket autotuning for the Gram service.

The port of ``repro/gram/autotune.py``.  The Benson–Ballard observation
carried into this repo: a fast-matmul variant only pays off when the
variant *and* blocking are selected per shape.  This module searches
``mode x levels x variant x gram x (bm, bk, bn) x pipeline_depth x
operand_dtype`` per (shape bucket, dtype, backend) — the variant and
gram-algebra axes enumerate the live leaf-IR registries, so registering
a new algebra automatically enters it in the contest — ranks candidates
with the analytic HBM traffic model (``kernels.strassen_fused``'s
``*_traffic_model``, the port's copies of the JAX package's), optionally
times the top-K on the device (CUDA events on the card, a synchronised
wall clock on the CPU), and persists the winner to a JSON cache under
``artifacts/autotune/``.  The tile choice inside a block (64 or 128, by
shared memory and waves) stays with the launch (``_launch`` and
``strassen_fused.PRODUCT_TILES``).

``kernels/ops.py`` consults this cache for its block-size defaults
(``resolve_block_defaults``) instead of a hardcoded 256.

Cache file format (``gram_autotune.json``, shared with the JAX
package)::

    {"version": 2,
     "entries": {
       "<backend>/torch-<version>/<device name>/<dtype>/<kind>/<M>x<N>": {
          "mode": "fused", "levels": 2, "variant": "strassen",
          "gram": "strassen", "bm": 256, "bk": 256, "bn": 256,
          "model_bytes": 1234, "measured_s": null, "source": "model",
          "torch": "<version>", "backend": "<backend>",
          "device_name": "<device name>"}}}

Keys are *bucketed* shapes (``bucket_shape``), so one entry serves every
request shape that rounds up to the same bucket, and they pin the
persist-time backend (``cuda`` or ``cpu``), torch version and device
name: a winner is a measurement of one toolchain on one card.  The JAX
package's keys pin ``<backend>/jax-<version>`` instead, so one file can
hold both packages' entries and neither ever matches the other's
lookups.  Invalidation: the file is re-read whenever its mtime changes
(delete it, or re-run ``autotune`` with ``refresh=True``).  Set
``REPRO_AUTOTUNE_CACHE`` to relocate the cache (tests point it at a tmp
dir).

Kinds: ``ata`` (forward column gram), ``aat`` (row gram,
``gram_of="rows"``), ``rank_k`` (the accumulating streamed update),
``ata_bwd`` (the Gram backward) — all scored by the one IR-driven
traffic core in ``kernels.strassen_fused``.
"""
from __future__ import annotations

import json
import math
import os
import time
import warnings
from pathlib import Path
from typing import Optional

import torch

from ..kernels.ops import DEFAULT_BLOCK
from ..kernels.strassen_fused import _dtype_name
from ..obs import metrics as _metrics
from ..runtime import faults as _faults

__all__ = [
    "bucket_shape", "candidate_space", "dedupe_candidates", "model_score",
    "autotune", "lookup", "resolve_block_defaults", "load_cache",
    "default_cache_path", "invalidate", "DEFAULT_BLOCK",
]


def _cache_event(outcome: str, amount: float = 1.0) -> None:
    """Count one cache-lifecycle event: "hit"/"miss" per lookup,
    "corrupt" (unparseable file degraded to empty), "stale_dropped"
    (pre-v2 entries dropped wholesale at load), "persist" (entry
    written), "invalidate" (winner dropped).  Resolved from the live
    registry per call so a test-time registry reset cannot orphan the
    counter."""
    _metrics.counter("gram_autotune_cache_total",
                     "autotune cache events by outcome").inc(
        amount, outcome=outcome)


# v2: the JAX package's cache version, whose keys carry the toolchain
# segment; pre-v2 files are ignored wholesale (stale by construction).
_CACHE_VERSION = 2

# (path, mtime) -> parsed entries; re-read on mtime change (invalidation).
_memo: dict = {}
# src/repro_torch/gram/autotune.py -> repo root is parents[3]
_DEFAULT_PATH = (Path(__file__).resolve().parents[3] / "artifacts"
                 / "autotune" / "gram_autotune.json")


def default_cache_path() -> Path:
    env = os.environ.get("REPRO_AUTOTUNE_CACHE")
    return Path(env) if env else _DEFAULT_PATH


def next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def bucket_shape(m: int, n: int, *, min_side: int = 32) -> tuple[int, int]:
    """Round a request shape up to the service bucket (powers of two,
    floored at ``min_side``).  Exact for Gram: zero-padding rows of A adds
    nothing to A^tA and zero columns are sliced away by the caller."""
    return (max(next_pow2(m), min_side), max(next_pow2(n), min_side))


def _default_backend() -> str:
    """Where an entry point runs when the caller names no device: the
    card when there is one."""
    return "cuda" if torch.cuda.is_available() else "cpu"


# card index -> its name in a cache key (a lookup runs on every entry
# point's call, so a card's name is read once)
_DEVICE_NAMES: dict = {}


def _device_name(backend: str) -> str:
    if backend != "cuda" or not torch.cuda.is_available():
        return backend
    index = torch.cuda.current_device()
    name = _DEVICE_NAMES.get(index)
    if name is None:
        name = _DEVICE_NAMES[index] = torch.cuda.get_device_name(
            index).replace("/", "_")
    return name


def _key(backend: str, dtype: str, kind: str, M: int, N: int) -> str:
    """Cache key for one tuned bucket: the persist-time backend, torch
    version and device name pinned beside the bucket, so that a winner
    measured under another toolchain or on another card never applies
    (lookups key on the same values, so mismatched entries simply never
    match)."""
    return (f"{backend}/torch-{torch.__version__}/{_device_name(backend)}/"
            f"{dtype}/{kind}/{M}x{N}")


# ---------------------------------------------------------------------------
# Search space + model scoring
# ---------------------------------------------------------------------------

def _variant_axis(kind: str) -> list:
    """(variant, gram) pairs ``kind`` can execute, from the live
    registries.  Gram kinds need square 2x2 variants for the off-diagonal
    table expansion; the gram-algebra axis only exists for them (matmul
    and everything else runs any registered split with the fixed
    placeholder gram)."""
    from ..core import leaf_ir
    if kind in ("ata", "aat", "rank_k", "ata_bwd"):
        variants = [v for v in leaf_ir.registered_algebras()
                    if leaf_ir.algebra_dims(v) == (2, 2, 2)]
        return [(v, g) for v in variants
                for g in leaf_ir.registered_gram_algebras()]
    return [(v, "strassen") for v in leaf_ir.registered_algebras()]


def candidate_space(M: int, N: int, *, backend: Optional[str] = None,
                    blocks=(128, 256, 512), levels=(0, 1, 2),
                    modes=("fused", "reference"), kind: str = "ata",
                    pipeline_depths=(1, 2), operand_dtypes=(None,)):
    """Enumerate (mode, levels, variant, gram, bm/bk/bn, pipeline_depth,
    operand_dtype) candidates for an (M, N) bucket.

    Only blocks the port's kernels accept are offered (positive
    multiples of 8: the leaf program copies its raw chunks in 16-byte
    vectors).  The variant/gram axes come from the live leaf-IR
    registries (``_variant_axis``).  Blocks larger than the bucket only
    add padding, so they are dropped (keeping at least the smallest
    candidate).  The grid only varies the knobs ``kind`` actually uses —
    ``aat`` ties bm=bk and ignores bn, and at levels=0 every (variant,
    gram) compiles the identical classical program, so only one
    candidate is emitted there.  ``pipeline_depths`` / ``operand_dtypes``
    are fused-kernel knobs: the reference recursion pins depth 1 /
    native operands.
    """
    accepted = [b for b in blocks if isinstance(b, int) and b >= 8
                and b % 8 == 0]
    if not accepted:
        raise ValueError(f"no block of {tuple(blocks)} is a positive "
                         f"multiple of 8, as the port's kernels need")
    usable = [b for b in accepted if b <= max(M, N)] or [min(accepted)]
    axis = _variant_axis(kind)
    out = []
    for mode in modes:
        for lv in levels:
            if mode == "reference":
                # blocking/pipelining are fused-kernel knobs; the
                # reference recursion leaves tiling to its leaves — one
                # candidate per level.
                out.append({"mode": "reference", "levels": lv,
                            "variant": "strassen", "gram": "strassen",
                            "bm": min(usable), "bk": min(usable),
                            "bn": min(usable), "pipeline_depth": 1,
                            "operand_dtype": None})
                continue
            pairs = axis if lv > 0 else [("strassen", "strassen")]
            for variant, gram in pairs:
                for bk in usable:
                    bns = [bk] if kind == "aat" else usable
                    for bn in bns:
                        for pd in pipeline_depths:
                            for od in operand_dtypes:
                                out.append({
                                    "mode": "fused", "levels": lv,
                                    "variant": variant, "gram": gram,
                                    "bm": bk, "bk": bk, "bn": bn,
                                    "pipeline_depth": int(pd),
                                    "operand_dtype": od})
    return dedupe_candidates(out, kind=kind)


def dedupe_candidates(cands, kind: str = "ata"):
    """Drop candidates that bind the identical executable config.

    The enumeration axes overshoot the kernel's real degrees of freedom:
    ``aat`` ties bm=bk and never reads bn, levels=0 compiles the same
    classical program for every (variant, gram) pair, and reference
    candidates ignore blocking and the fused perf knobs entirely.  Keyed
    on the knobs ``kind`` actually uses, first occurrence wins (order —
    and therefore model ranking — is preserved)."""
    seen, out = set(), []
    for c in cands:
        lv = c["levels"]
        alg = ((c["variant"], c.get("gram", "strassen")) if lv > 0
               else ("classical", "classical"))
        if c["mode"] == "reference":
            sig = ("reference", lv, alg)
        else:
            blocks = ((c["bm"], c["bk"]) if kind == "aat"
                      else (c["bk"], c["bn"]))
            sig = ("fused", lv, alg, blocks,
                   int(c.get("pipeline_depth") or 1),
                   c.get("operand_dtype"))
        if sig in seen:
            continue
        seen.add(sig)
        out.append(c)
    return out


def _pipelined_side_score(side: dict, cand: dict, in_bytes: int) -> float:
    """Score one traffic-model side dict for a candidate.

    Legacy byte-sum (read + write + intermediate) unless the candidate
    carries the pipeline knobs — entries tuned before those axes existed
    keep their historical scores bit-for-bit.  ``operand_dtype`` rescales
    operand read traffic by the quantized itemsize; the depth picks
    ``cost_model.pipelined_bytes_score``'s sum (depth 1) or max + fill
    (depth >= 2) of the memory and compute terms, at the H100 rates."""
    reads = float(side["read_bytes"])
    writes = float(side["write_bytes"])
    inter = float(side.get("intermediate_bytes", 0))
    if "pipeline_depth" not in cand and "operand_dtype" not in cand:
        return reads + writes + inter           # legacy candidate
    od = cand.get("operand_dtype")
    pd = int(cand.get("pipeline_depth") or 1)
    if od is not None:
        from ..kernels.strassen_fused import _resolve_operand_dtype
        reads *= _resolve_operand_dtype(od).itemsize / float(in_bytes)
    from ..core import cost_model
    return cost_model.pipelined_bytes_score(
        reads + inter, writes, float(side.get("flops", 0)),
        pipeline_depth=pd, grid_steps=int(side.get("grid_steps", 1)))


def model_score(m: int, n: int, cand: dict, *, in_bytes: int = 4,
                out_bytes: int = 4, kind: str = "ata") -> float:
    """HBM-bytes score (lower is better) used to seed the search.

    Fused candidates use the analytic kernel models — thin wrappers over
    the one IR-driven traffic core in ``kernels.strassen_fused``
    (``_traffic`` over a bound program spec), so every kind (``ata``,
    ``aat``, ``rank_k``, ``ata_bwd``) is scored by the machinery the
    executor is built on.  Reference candidates use a closed-form upper
    estimate of what the recursion (or the relevant dense baseline)
    materializes — a deliberate heuristic, so model-only search ranks
    fused candidates only and reference candidates compete through
    ``measure=True`` timings (see :func:`autotune`).
    """
    from ..kernels import strassen_fused as sf
    if kind == "ata_bwd":
        # cotangent="dense": score the entry point the measured runner
        # drives (autograd through the dense forward packs the cotangent)
        t = sf.ata_bwd_traffic_model(m, n, levels=cand["levels"],
                                     variant=cand["variant"],
                                     gram=cand.get("gram", "strassen"),
                                     bk=cand["bk"], bn=cand["bn"],
                                     in_bytes=in_bytes, cotangent="dense")
        side = t if cand["mode"] == "fused" else t["dense_baseline"]
        return _pipelined_side_score(side, cand, in_bytes)
    if kind == "rank_k":
        t = sf.rank_k_traffic_model(m, n, levels=cand["levels"],
                                    variant=cand["variant"],
                                    gram=cand.get("gram", "strassen"),
                                    bk=cand["bk"], bn=cand["bn"],
                                    in_bytes=in_bytes,
                                    state_bytes=out_bytes)
        # "reference" = the streamed update (delta stack + gather-add)
        # the accumulating kernel replaces
        side = t if cand["mode"] == "fused" else t["baseline"]
        return _pipelined_side_score(side, cand, in_bytes)
    if cand["mode"] == "fused":
        if kind == "aat":
            t = sf.aat_traffic_model(m, n, levels=cand["levels"],
                                     variant=cand["variant"],
                                     gram=cand.get("gram", "strassen"),
                                     bm=cand["bm"], bk=cand["bk"],
                                     in_bytes=in_bytes, out_bytes=out_bytes)
        else:
            t = sf.ata_traffic_model(m, n, levels=cand["levels"],
                                     variant=cand["variant"],
                                     gram=cand.get("gram", "strassen"),
                                     bk=cand["bk"], bn=cand["bn"],
                                     in_bytes=in_bytes, out_bytes=out_bytes)
        return _pipelined_side_score(t, cand, in_bytes)
    lv = cand["levels"]
    amplification = (7.0 / 4.0) ** lv
    d = m if kind == "aat" else n          # gram output dimension
    reads = m * n * in_bytes * max(amplification, 1.0)
    writes = d * d * out_bytes
    intermediates = (m * n + d * d) * in_bytes * (amplification - 1.0) * 2
    return float(reads + writes + intermediates)


# ---------------------------------------------------------------------------
# Cache IO
# ---------------------------------------------------------------------------

def load_cache(path: Optional[os.PathLike] = None) -> dict:
    """Entries dict from the JSON cache ({} when absent/corrupt).
    Memoized on (path, mtime): touching the file invalidates.

    A corrupt file (truncated by a crash mid-write, or bit rot) must
    never take serving down: it degrades to an empty cache — untuned
    defaults — with ONE warning per file snapshot (the mtime memo dedups
    it; the next ``_save_entry`` rewrites the file whole, which is the
    repair).  Entries that are not JSON objects are dropped."""
    p = Path(path) if path is not None else default_cache_path()
    try:                    # one stat a lookup: the hot path of every op
        mtime = os.stat(p).st_mtime_ns
    except OSError:
        return {}
    # chaos hook: an armed cache_corrupt fault truncates the file first,
    # exercising exactly the recovery path below
    if _faults.corrupt_file("gram.autotune.cache", p):
        try:
            mtime = os.stat(p).st_mtime_ns
        except OSError:
            return {}
    memo_key = (p, mtime)
    if memo_key in _memo:
        return _memo[memo_key]
    try:
        with open(p) as f:
            raw = json.load(f)
        entries = raw.get("entries", {}) if isinstance(raw, dict) else {}
        if not isinstance(entries, dict):
            raise ValueError(f"'entries' is a {type(entries).__name__}, "
                             "not an object")
        # pre-v2 files keyed without the toolchain — every entry is
        # potentially a stale winner; drop them all and let autotune
        # repopulate (the migration path)
        if not isinstance(raw, dict) or raw.get("version", 0) \
                < _CACHE_VERSION:
            _cache_event("stale_dropped", len(entries) or 1)
            entries = {}
        entries = {k: v for k, v in entries.items() if isinstance(v, dict)}
    except OSError:
        entries = {}
    except ValueError as e:
        warnings.warn(
            f"autotune cache {p} is corrupt ({e}); ignoring it and "
            f"serving with untuned defaults — the next autotune run "
            f"rewrites it", stacklevel=2)
        _cache_event("corrupt")
        entries = {}
    _memo.clear()           # one live file snapshot is enough
    _memo[memo_key] = entries
    return entries


def _write(p: Path, entries: dict) -> None:
    _RESOLVED.clear()       # this process's own write: seen at once
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(".tmp")
    with open(tmp, "w") as f:
        json.dump({"version": _CACHE_VERSION, "entries": entries}, f,
                  indent=1, sort_keys=True)
    os.replace(tmp, p)


def _save_entry(key: str, entry: dict, path: Optional[os.PathLike]) -> Path:
    p = Path(path) if path is not None else default_cache_path()
    entries = dict(load_cache(p))
    entries[key] = entry
    _write(p, entries)
    _cache_event("persist")
    return p


def invalidate(m: int, n: int, *, dtype="float32", kind: str = "ata",
               backend: Optional[str] = None, min_side: int = 32,
               cache_path: Optional[os.PathLike] = None) -> bool:
    """Drop the persisted winner for the bucket containing (m, n) — the
    action a cost-model drift finding maps to: the entry was a
    measurement of conditions that no longer hold, so the next autotune
    re-measures.  Returns whether an entry existed."""
    backend = backend or _default_backend()
    M, N = bucket_shape(m, n, min_side=min_side)
    key = _key(backend, _dtype_name(dtype), kind, M, N)
    p = Path(cache_path) if cache_path is not None else default_cache_path()
    entries = dict(load_cache(p))
    if key not in entries:
        return False
    del entries[key]
    _write(p, entries)
    _cache_event("invalidate")
    return True


def lookup(m: int, n: int, *, dtype="float32", kind: str = "ata",
           backend: Optional[str] = None, min_side: int = 32,
           cache_path: Optional[os.PathLike] = None) -> Optional[dict]:
    """Winner entry for the bucket containing (m, n), or None.
    ``backend`` defaults to the card when there is one; ``min_side``
    must match the bucketing used when tuning."""
    backend = backend or _default_backend()
    M, N = bucket_shape(m, n, min_side=min_side)
    hit = load_cache(cache_path).get(_key(backend, _dtype_name(dtype), kind,
                                          M, N))
    _cache_event("hit" if hit is not None else "miss")
    return hit


# The entry-point hook's answers: (cache path, backend, dtype, kind,
# bucket) -> (entry or None, time.monotonic() of the read).  A lookup
# stats the cache file, and a stat can take tens of microseconds on a
# card's host; every entry point of ``kernels/ops.py`` asks (the
# recursion on kernel leaves 38 times a Gram), where the JAX package asks
# once a trace.  So the hook re-reads a bucket at most every
# ``_RESOLVE_TTL_S``; this process's own writes clear it at once.
_RESOLVED: dict = {}
_RESOLVE_TTL_S = 1.0


def _resolved_entry(kind: str, m: int, n: int, dtype,
                    backend: Optional[str]) -> Optional[dict]:
    backend = backend or _default_backend()
    M, N = bucket_shape(m, n)
    key = (os.environ.get("REPRO_AUTOTUNE_CACHE"), backend,
           _dtype_name(dtype), kind, M, N)
    now = time.monotonic()
    held = _RESOLVED.get(key)
    if held is not None and now - held[1] < _RESOLVE_TTL_S:
        _cache_event("hit" if held[0] is not None else "miss")
        return held[0]
    entry = lookup(m, n, dtype=dtype, kind=kind, backend=backend)
    _RESOLVED[key] = (entry, now)
    return entry


def resolve_block_defaults(kind: str, m: int, n: int, dtype, *,
                           backend: Optional[str] = None,
                           **blocks) -> dict:
    """Fill ``None`` block sizes from the autotune cache (256 fallback).

    The hook through which ``kernels/ops.py`` consults the cache:
    explicit caller values always win; a missing entry, an unreadable
    cache or an entry whose blocks are not usable degrades to
    ``DEFAULT_BLOCK`` — a cache miss, never a device fallback.  Only
    ``mode="fused"`` winners carry meaningful block sizes (reference
    entries hold placeholders), so other entries are ignored here.  A
    bucket's answer is re-read from the file at most once a second (a
    write by this process is seen at once, another process's within the
    second; :func:`lookup` itself re-reads on every mtime change).
    """
    if all(v is not None for v in blocks.values()):
        return blocks
    best = None
    if kind in ("ata", "matmul", "ata_bwd", "aat", "rank_k"):
        best = _resolved_entry(kind, m, n, dtype, backend)
        if best is not None and best.get("mode") != "fused":
            best = None
    out = {}
    for k, v in blocks.items():
        tuned = (best or {}).get(k)
        if v is None and not (isinstance(tuned, int) and tuned >= 8
                              and tuned % 8 == 0):
            tuned = DEFAULT_BLOCK   # absent, or not a block the port takes
        out[k] = int(v if v is not None else tuned)
    return out


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------

def _build_runner(M: int, N: int, dtype, cand: dict, device,
                  kind: str = "ata"):
    """The candidate as a function of A on ``device``: what ``kind``'s
    entry point runs under its knobs."""
    from ..core.ata import ata

    galg = cand.get("gram", "strassen")
    # pipeline knobs are fused-kernel only; the reference recursion takes
    # pipeline_depth=None (a no-op there) and quantizes via ata()'s
    # operand_dtype oracle path
    pdepth = cand.get("pipeline_depth")
    odtype = cand.get("operand_dtype")
    if kind == "aat":
        def fn(a):
            return ata(a, gram_of="rows", levels=cand["levels"],
                       variant=cand["variant"], gram=galg,
                       mode=cand["mode"], block=cand["bk"],
                       out_dtype=torch.float32, pipeline_depth=pdepth,
                       operand_dtype=odtype, device=device)
        return fn

    if kind == "rank_k":
        # fused: the accumulating kernel on a live stack; reference: the
        # element-packed streamed update it replaces
        if cand["mode"] == "fused":
            from ..kernels.ops import rank_k_update
            t = -(-N // cand["bn"])

            def fn(a):
                stack = torch.zeros((t * (t + 1) // 2 * cand["bn"],
                                     cand["bn"]), dtype=torch.float32,
                                    device=device)
                return rank_k_update(stack, a, levels=cand["levels"],
                                     variant=cand["variant"], gram=galg,
                                     bk=cand["bk"], donate=False,
                                     pipeline_depth=pdepth,
                                     operand_dtype=odtype, device=device)
            return fn

        from . import stream as _stream

        def fn(a):
            state = _stream.init(N, device=device)
            return _stream.update(state, a, levels=cand["levels"],
                                  variant=cand["variant"],
                                  mode="auto").packed
        return fn

    if kind == "ata_bwd":
        # the gradient through the fused forward; the candidate mode
        # picks the backward ("reference" = the dense A (S + S^t))
        bwd = "fused" if cand["mode"] == "fused" else "dense"

        def fn(a):
            x = a.detach().requires_grad_()
            c = ata(x, levels=cand["levels"], variant=cand["variant"],
                    gram=galg, mode="fused", bwd=bwd, block=cand["bk"],
                    out_dtype=torch.float32, pipeline_depth=pdepth,
                    device=device)
            (g,) = torch.autograd.grad(c.sum(), x)
            return g
        return fn

    def fn(a):
        return ata(a, levels=cand["levels"], variant=cand["variant"],
                   gram=galg, mode=cand["mode"], block=cand["bk"],
                   out_dtype=torch.float32, pipeline_depth=pdepth,
                   operand_dtype=odtype, device=device)
    return fn


def _time_candidate(fn, a: torch.Tensor, iters: int = 2) -> float:
    """Best of ``iters`` runs of ``fn(a)`` in seconds, after one that
    builds and warms: CUDA events around it on the card, a wall clock
    around the (synchronous) call on the CPU."""
    fn(a)
    best = math.inf
    for _ in range(iters):
        if a.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(a)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(a)
            best = min(best, time.perf_counter() - t0)
    return best


def autotune(m: int, n: int, *, dtype="float32", kind: str = "ata",
             measure: bool = False, top_k: int = 3,
             blocks=(128, 256, 512), levels=(0, 1, 2),
             modes=("fused", "reference"), min_side: int = 32,
             pipeline_depths=(1, 2), operand_dtypes=(None,),
             cache_path: Optional[os.PathLike] = None, device=None,
             refresh: bool = False) -> dict:
    """Pick (and persist) the best config for the bucket containing (m, n)
    on ``device`` (None: the card; its type is the entry's backend).

    Model-only by default: ranks *fused* candidates by ``model_score``
    (the model is the fused kernel's; the reference estimate is a
    heuristic, so it never decides a contest).  With ``measure=True`` the
    top-K fused candidates plus the reference candidates run on
    ``device`` on a bucket-sized A (standard normal, seed 0) and the
    fastest wins.  Returns the cached entry when one exists unless
    ``refresh``.

    ``kind="ata_bwd"`` tunes the *backward*: candidates are scored with
    ``ata_bwd_traffic_model`` (mode "fused" = the packed-cotangent symm
    kind, "reference" = the dense ``A (S + S^t)``) and measured — when
    requested — as the gradient through the fused forward with the
    corresponding ``bwd=``.
    """
    from ..kernels.ops import resolve_device
    dev = resolve_device(device)
    backend = dev.type
    dtype = _dtype_name(dtype)
    M, N = bucket_shape(m, n, min_side=min_side)
    key = _key(backend, dtype, kind, M, N)
    if not refresh:
        hit = load_cache(cache_path).get(key)
        if hit is not None:
            return hit

    in_bytes = getattr(torch, dtype).itemsize
    cands = candidate_space(M, N, backend=backend, blocks=blocks,
                            levels=levels, modes=modes, kind=kind,
                            pipeline_depths=pipeline_depths,
                            operand_dtypes=operand_dtypes)

    def score(c):
        return model_score(M, N, c, in_bytes=in_bytes, kind=kind)

    fused = sorted((c for c in cands if c["mode"] == "fused"), key=score)
    refs = sorted((c for c in cands if c["mode"] == "reference"), key=score)
    winner, measured = (fused or refs)[0], None
    if measure:
        gen = torch.Generator(device=dev).manual_seed(0)
        a = torch.randn((M, N), generator=gen, device=dev).to(
            getattr(torch, dtype))
        timed = []
        for cand in fused[:top_k] + refs:
            try:
                runner = _build_runner(M, N, dtype, cand, dev, kind)
                timed.append((_time_candidate(runner, a), cand))
            except ValueError:
                continue    # a config the kernel refuses (shared memory)
        if timed:
            measured, winner = min(timed, key=lambda tc: tc[0])

    entry = {**winner,
             "model_bytes": score(winner),
             "measured_s": measured,
             "source": "measured" if measured is not None else "model",
             # introspection copies of what the key already pins
             "torch": torch.__version__,
             "backend": backend,
             "device_name": _device_name(backend)}
    _save_entry(key, entry, cache_path)
    return entry
