"""Fault-injection registry for robustness drills (chaos testing).

The port's copy of ``repro/runtime/faults.py`` (numpy only; the port
imports nothing of the JAX package).  Autotune's cache loader calls its
``corrupt_file`` hook; the serving layer's hooks come with the slice that
ports the engine.

The serving path's failure model (DESIGN.md §13) is exercised by
*injecting* the failures the ROADMAP's "millions of users" target implies:
poisoned operand/output tiles (NaN/Inf from a bad DMA or a low-precision
overflow), finite silent corruption (a wrong tile that only a Freivalds
probe can see), executables that raise or stall (a wedged device), a
corrupted autotune cache file, and a mesh that shrinks mid-run (a dead
replica group).

Two ways to arm it, one registry:

* **Context manager** (tests)::

      from repro_torch.runtime import faults
      with faults.inject(faults.FaultSpec("exec_fail", rate=1.0,
                                          site="gram.engine.exec*")):
          eng.step()          # every executable launch raises InjectedFault

* **Environment** (chaos CI / benchmarks)::

      REPRO_FAULTS="poison_output:rate=0.1,value=nan;exec_fail:rate=0.05"

  Profiles are ``;``-separated ``kind:key=val,key=val`` specs, parsed on
  first use and re-parsed whenever the variable's value changes.

Sites are dotted names matched with ``fnmatch`` globs (default ``*``), so
one profile can target a single bucket executable or the whole engine.
Every firing is appended to ``registry.events`` — tests assert on what
actually fired, not on probabilities.  Randomness is a seeded
``numpy`` generator: a chaos trace is reproducible.

The registry is *pull-based*: production code calls the narrow hooks
(``fire`` / ``poison`` / ``corrupt_file``) which are no-ops unless a
matching spec is armed — the fault-free hot path costs one attribute
check per hook.
"""
from __future__ import annotations

import itertools
import math
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from fnmatch import fnmatch
from typing import List, Optional, Tuple

import numpy as np

from ..obs import trace as _trace

__all__ = [
    "FaultSpec", "FaultEvent", "FaultRegistry", "InjectedFault",
    "ENV_VAR", "KINDS", "active", "install", "inject", "reset",
    "fire", "poison", "check_exec", "corrupt_file", "parse_profile",
]

ENV_VAR = "REPRO_FAULTS"

KINDS = (
    "poison_operand",   # overwrite a tile of an operand array
    "poison_output",    # overwrite a tile of a result array
    "exec_fail",        # raise InjectedFault at an executable launch
    "exec_delay",       # stall an executable launch by ``delay`` seconds
    "cache_corrupt",    # truncate a cache file in place (half its bytes)
    "mesh_shrink",      # signal the serving layer to drop a replica group
)


class InjectedFault(RuntimeError):
    """Raised by an armed ``exec_fail`` spec (a crashed executable)."""


@dataclass
class FaultSpec:
    """One armed fault: what to break, how often, and how hard.

    kind:  one of ``KINDS``.
    rate:  firing probability per opportunity (1.0 = always).
    times: total firing budget (None = unlimited).
    site:  fnmatch glob over the hook's dotted site name.
    value: poison payload — ``nan``/``inf`` for guard-visible corruption,
           any finite float for *silent* corruption only a Freivalds
           probe catches.
    delay: seconds for ``exec_delay``.
    """
    kind: str
    rate: float = 1.0
    times: Optional[int] = None
    site: str = "*"
    value: float = math.nan
    delay: float = 0.0
    fired: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")


@dataclass
class FaultEvent:
    kind: str
    site: str
    detail: str = ""
    t: float = 0.0        # time.perf_counter() at the firing — the same
    #                       clock the tracer uses, so fault events align
    #                       with request spans on one timeline
    seq: int = 0          # per-registry firing sequence (1-based): total
    #                       order even when perf_counter ties


@dataclass
class FaultRegistry:
    specs: List[FaultSpec] = field(default_factory=list)
    seed: int = 0
    events: List[FaultEvent] = field(default_factory=list)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._seq = itertools.count(1)

    # -- core matching ----------------------------------------------------
    def match(self, kind: str, site: str) -> Optional[FaultSpec]:
        """The first armed spec firing for (kind, site) this opportunity,
        with its budget decremented and the event logged (timestamped +
        sequence-numbered, and mirrored onto the tracer timeline as an
        instant); else None."""
        for spec in self.specs:
            if spec.kind != kind or not fnmatch(site, spec.site):
                continue
            if spec.times is not None and spec.fired >= spec.times:
                continue
            if spec.rate < 1.0 and self._rng.random() >= spec.rate:
                continue
            spec.fired += 1
            ev = FaultEvent(kind=kind, site=site,
                            t=time.perf_counter(), seq=next(self._seq))
            self.events.append(ev)
            _trace.instant(f"fault:{kind}", site=site, seq=ev.seq)
            return spec
        return None

    def count(self, kind: str) -> int:
        return sum(1 for e in self.events if e.kind == kind)

    # -- hooks ------------------------------------------------------------
    def fire(self, kind: str, site: str) -> bool:
        """Generic boolean hook (used for ``mesh_shrink``); for
        ``exec_fail``/``exec_delay`` prefer the dedicated hooks below."""
        return self.match(kind, site) is not None

    def check_exec(self, site: str) -> None:
        """Executable-launch hook: stall on an armed ``exec_delay``, raise
        ``InjectedFault`` on an armed ``exec_fail``."""
        spec = self.match("exec_delay", site)
        if spec is not None and spec.delay > 0:
            time.sleep(spec.delay)
        if self.match("exec_fail", site) is not None:
            raise InjectedFault(f"injected executable failure at {site}")

    def poison(self, kind: str, site: str,
               arr: np.ndarray) -> Tuple[np.ndarray, bool]:
        """(possibly-poisoned copy, fired?) for an operand/output array.

        Overwrites one random tile (up to 8x8 on the trailing two axes)
        with ``spec.value`` — NaN/Inf for guard-visible faults, a finite
        value for silent corruption.  The input is never mutated in
        place: retries must start from clean data.
        """
        spec = self.match(kind, site)
        if spec is None or arr.ndim < 2 or arr.size == 0:
            return arr, False
        out = np.array(arr, copy=True)
        h, w = out.shape[-2], out.shape[-1]
        th, tw = min(8, h), min(8, w)
        i = int(self._rng.integers(0, h - th + 1))
        j = int(self._rng.integers(0, w - tw + 1))
        flat = out.reshape(-1, h, w)
        b = int(self._rng.integers(0, flat.shape[0]))
        flat[b, i:i + th, j:j + tw] = spec.value
        self.events[-1].detail = f"tile[{b},{i}:{i+th},{j}:{j+tw}]" \
                                 f"={spec.value}"
        return out, True

    def corrupt_file(self, site: str, path) -> bool:
        """Truncate ``path`` to half its bytes on an armed
        ``cache_corrupt`` (models a crash mid-write / bit-rotted cache).
        Returns whether it fired."""
        spec = self.match("cache_corrupt", site)
        if spec is None:
            return False
        try:
            with open(path, "rb") as f:
                raw = f.read()
            with open(path, "wb") as f:
                f.write(raw[:max(1, len(raw) // 2)])
            self.events[-1].detail = str(path)
        except OSError:
            pass
        return True


_NULL = FaultRegistry()          # armed with nothing: every hook a no-op
_installed: Optional[FaultRegistry] = None
_env_cache: Tuple[Optional[str], Optional[FaultRegistry]] = (None, None)


def parse_profile(profile: str, *, seed: int = 0) -> FaultRegistry:
    """Registry from a ``REPRO_FAULTS`` profile string (see module doc).

    ``"poison_output:rate=0.1,value=inf;exec_fail:rate=0.05,times=3"``
    """
    specs = []
    for part in profile.split(";"):
        part = part.strip()
        if not part:
            continue
        kind, _, kvs = part.partition(":")
        kw = {}
        for kv in filter(None, (s.strip() for s in kvs.split(","))):
            k, _, v = kv.partition("=")
            if k in ("rate", "delay", "value"):
                kw[k] = float(v)
            elif k == "times":
                kw[k] = int(v)
            elif k == "site":
                kw[k] = v
            elif k == "seed":
                seed = int(v)
            else:
                raise ValueError(f"unknown fault spec key {k!r} in {part!r}")
        specs.append(FaultSpec(kind.strip(), **kw))
    return FaultRegistry(specs=specs, seed=seed)


def active() -> FaultRegistry:
    """The live registry: an installed one (context manager), else one
    parsed from ``$REPRO_FAULTS`` (cached until the value changes), else
    a null registry with nothing armed."""
    global _env_cache
    if _installed is not None:
        return _installed
    profile = os.environ.get(ENV_VAR)
    if not profile:
        return _NULL
    if _env_cache[0] != profile:
        _env_cache = (profile, parse_profile(profile))
    return _env_cache[1]


def install(registry: Optional[FaultRegistry]) -> None:
    """Install (or, with None, remove) the process-wide registry —
    overrides the environment profile."""
    global _installed
    _installed = registry


def reset() -> None:
    """Drop the installed registry and the env-profile cache."""
    global _installed, _env_cache
    _installed = None
    _env_cache = (None, None)


@contextmanager
def inject(*specs: FaultSpec, seed: int = 0):
    """Arm ``specs`` for the duration of the block; yields the registry
    (inspect ``.events`` afterwards).  Nestable: restores the previous
    registry on exit."""
    prev = _installed
    reg = FaultRegistry(specs=list(specs), seed=seed)
    install(reg)
    try:
        yield reg
    finally:
        install(prev)


# -- module-level convenience hooks (call sites stay one-liners) ----------

def fire(kind: str, site: str) -> bool:
    return active().fire(kind, site)


def poison(kind: str, site: str, arr: np.ndarray) -> np.ndarray:
    return active().poison(kind, site, arr)[0]


def check_exec(site: str) -> None:
    active().check_exec(site)


def corrupt_file(site: str, path) -> bool:
    return active().corrupt_file(site, path)
