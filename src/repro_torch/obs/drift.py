"""Online cost-model drift detection (DESIGN.md §14).

The port's copy of ``repro/obs/drift.py`` (plain Python: the port
imports nothing of the JAX package).  The engine of the port feeds only
the ``"wall"`` channel: the ``"traffic"`` channel's measurement is the
HLO census of a compiled XLA executable, which torch has no counterpart
of until ``roofline/`` is ported (ROADMAP.md Queue 1 #11).

The CAPS line of work (Ballard et al., arXiv 1202.3173) and the
Benson–Ballard practical-fast-matmul framework (arXiv 1409.2908) both
stress that a fast algorithm only pays off when it is *measured against
its model per configuration*.  This repo predicts every serving config's
cost in closed form (``core.cost_model``, the IR-driven traffic models
in ``kernels.strassen_fused``) and autotunes winners from those
predictions — but a persisted winner is a measurement of one moment: the
toolchain drifts, thermals drift, a neighbour tenant appears, and the
tuned config silently stops being the right one.

:class:`DriftDetector` keeps, per ``(key, channel)``, an EWMA of the
``measured / predicted`` ratio and flags keys whose ratio leaves the
``[1/theta, theta]`` band:

- channel ``"wall"`` — measured executable seconds vs predicted model
  *bytes*.  The units differ by an unknown machine constant
  (bytes/second), so findings normalize each key's ratio by the **median
  ratio across keys**: the constant cancels, and a bucket is flagged
  only when it deviates from how the model tracks the *rest of the
  fleet* — exactly the "this bucket's winner has drifted" signal, robust
  to the whole machine speeding up or slowing down.
- channel ``"traffic"`` — HLO-census HBM bytes vs traffic-model bytes.
  Same units, ratio ≈ 1 by construction when the model is honest, so
  the band applies directly (no normalization).

A finding is advisory: the serving layer surfaces it
(``GramEngine.stats()["drift"]``) and can hand it to
``gram.autotune.invalidate`` to drop the stale winner so the next
autotune re-measures (``GramEngine.invalidate_drifted``).
"""
from __future__ import annotations

import statistics
import threading
from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional, Tuple

__all__ = ["DriftRecord", "DriftFinding", "DriftDetector"]


@dataclass
class DriftRecord:
    """EWMA state for one (key, channel)."""
    ewma_ratio: float = 0.0
    n: int = 0
    last_measured: float = 0.0
    last_predicted: float = 0.0
    meta: dict = field(default_factory=dict)


@dataclass
class DriftFinding:
    key: Hashable
    channel: str                 # "wall" | "traffic"
    ratio: float                 # the flagged (normalized) ratio
    raw_ratio: float             # the un-normalized EWMA measured/predicted
    n: int                       # samples behind the EWMA
    theta: float
    meta: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {"key": str(self.key), "channel": self.channel,
                "ratio": self.ratio, "raw_ratio": self.raw_ratio,
                "n": self.n, "theta": self.theta, **self.meta}


class DriftDetector:
    """Per-(key, channel) EWMA of measured/predicted with a theta band.

    ``alpha`` is the EWMA weight of the newest sample; ``min_samples``
    gates findings (one noisy first batch must not quarantine a
    winner).  Thread-safe: the engine observes from its serving thread,
    scrapes read from anywhere.
    """

    def __init__(self, *, theta: float = 2.0, alpha: float = 0.25,
                 min_samples: int = 3):
        if theta <= 1.0:
            raise ValueError(f"theta must be > 1, got {theta}")
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.theta = theta
        self.alpha = alpha
        self.min_samples = max(1, min_samples)
        self._lock = threading.Lock()
        self._records: Dict[Tuple[Hashable, str], DriftRecord] = {}

    # -- observation ------------------------------------------------------
    def observe(self, key: Hashable, *, measured: float, predicted: float,
                channel: str = "wall", **meta) -> Optional[float]:
        """Fold one (measured, predicted) pair in; returns the updated
        EWMA ratio (None when the pair is unusable — non-positive values
        carry no ratio information and are dropped)."""
        if not (measured > 0 and predicted > 0):
            return None
        r = measured / predicted
        with self._lock:
            rec = self._records.get((key, channel))
            if rec is None:
                rec = self._records[(key, channel)] = DriftRecord()
            if rec.n == 0:
                rec.ewma_ratio = r
            else:
                rec.ewma_ratio = ((1 - self.alpha) * rec.ewma_ratio
                                  + self.alpha * r)
            rec.n += 1
            rec.last_measured = measured
            rec.last_predicted = predicted
            if meta:
                rec.meta.update(meta)
            return rec.ewma_ratio

    # -- introspection ----------------------------------------------------
    def record(self, key: Hashable, channel: str = "wall"
               ) -> Optional[DriftRecord]:
        with self._lock:
            return self._records.get((key, channel))

    def ratios(self, channel: str = "wall") -> Dict[Hashable, float]:
        with self._lock:
            return {k: rec.ewma_ratio
                    for (k, ch), rec in self._records.items()
                    if ch == channel}

    def _mature(self, channel: str) -> Dict[Hashable, DriftRecord]:
        with self._lock:
            return {k: rec for (k, ch), rec in self._records.items()
                    if ch == channel and rec.n >= self.min_samples}

    def findings(self, channel: Optional[str] = None) -> List[DriftFinding]:
        """Keys whose (normalized) ratio left ``[1/theta, theta]``.

        ``channel=None`` scans both channels.  The ``"wall"`` channel
        normalizes by the cross-key median (module docstring) — with
        fewer than two mature keys it cannot flag anything, by design:
        one bucket cannot be distinguished from the machine constant.
        """
        channels = (channel,) if channel else ("wall", "traffic")
        out: List[DriftFinding] = []
        for ch in channels:
            mature = self._mature(ch)
            if not mature:
                continue
            if ch == "wall":
                if len(mature) < 2:
                    continue
                med = statistics.median(
                    rec.ewma_ratio for rec in mature.values())
                if med <= 0:
                    continue
                norm = {k: rec.ewma_ratio / med
                        for k, rec in mature.items()}
            else:
                norm = {k: rec.ewma_ratio for k, rec in mature.items()}
            for k, ratio in sorted(norm.items(), key=lambda kv: str(kv[0])):
                if not (1.0 / self.theta <= ratio <= self.theta):
                    rec = mature[k]
                    out.append(DriftFinding(
                        key=k, channel=ch, ratio=ratio,
                        raw_ratio=rec.ewma_ratio, n=rec.n,
                        theta=self.theta, meta=dict(rec.meta)))
        return out

    def stale_keys(self, channel: Optional[str] = None) -> List[Hashable]:
        return [f.key for f in self.findings(channel)]

    def reset(self, key: Hashable = None,
              channel: Optional[str] = None) -> None:
        """Forget state — everything, one key, or one (key, channel)
        (after a winner is invalidated its history is meaningless)."""
        with self._lock:
            if key is None and channel is None:
                self._records.clear()
                return
            drop = [kc for kc in self._records
                    if (key is None or kc[0] == key)
                    and (channel is None or kc[1] == channel)]
            for kc in drop:
                del self._records[kc]

    def snapshot(self) -> dict:
        """JSON-friendly dump of every record + current findings."""
        with self._lock:
            records = {
                f"{k}|{ch}": {"ewma_ratio": rec.ewma_ratio, "n": rec.n,
                              "last_measured": rec.last_measured,
                              "last_predicted": rec.last_predicted,
                              **rec.meta}
                for (k, ch), rec in self._records.items()}
        return {"theta": self.theta, "alpha": self.alpha,
                "min_samples": self.min_samples, "records": records,
                "findings": [f.as_dict() for f in self.findings()]}
