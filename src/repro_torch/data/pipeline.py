"""Deterministic, resumable synthetic token pipeline.

The port's copy of ``repro/data/pipeline.py`` (numpy only): the same
Philox streams, so a batch is the JAX package's arrays bit for bit.

Every batch is a pure function of (seed, step) — computed with a
counter-based Philox generator — so a restart at step k reproduces the
exact stream with NO saved iterator state beyond the step integer, and a
different data-parallel topology reads identical global batches (elastic
restarts keep the data order bit-exact).

Two generators:
  * "markov": a noisy affine token chain x_{t+1} = (a*x_t + b + noise) mod V
    with per-sequence (a, b) — learnable structure so example training runs
    show loss decreasing;
  * "uniform": i.i.d. uniform tokens (pure-throughput benchmarking).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "markov"          # markov | uniform
    noise: float = 0.05           # markov corruption rate
    enc_seq: int = 0              # >0: also emit enc_inputs (B, enc_seq, enc_dim)
    enc_dim: int = 0


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=[seed, step]))


def get_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Batch for ``step``: {"inputs","labels"} (B, S) int32 [+ enc_inputs]."""
    rng = _rng(cfg.seed, step)
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    if cfg.kind == "uniform":
        toks = rng.integers(0, v, size=(b, s + 1), dtype=np.int64)
    else:
        # ONE affine successor map per seed (a learnable V->V lookup);
        # sequences start at random tokens.
        map_rng = _rng(cfg.seed, 2**31 - 1)
        a = int(map_rng.integers(1, max(v - 1, 2)))
        c = int(map_rng.integers(0, v))
        x0 = rng.integers(0, v, size=(b,))
        toks = np.empty((b, s + 1), dtype=np.int64)
        toks[:, 0] = x0
        for t in range(s):
            toks[:, t + 1] = (a * toks[:, t] + c) % v
        flip = rng.random((b, s + 1)) < cfg.noise
        toks = np.where(flip, rng.integers(0, v, size=(b, s + 1)), toks)
    batch = {"inputs": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    if cfg.enc_seq:
        batch["enc_inputs"] = rng.normal(
            0, 1, size=(b, cfg.enc_seq, cfg.enc_dim)).astype(np.float32)
    return batch


class SyntheticStream:
    """Stateful iterator facade; state == the step integer (resumable)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step

    def __iter__(self):
        return self

    def __next__(self):
        batch = get_batch(self.cfg, self.step)
        self.step += 1
        return batch

    @property
    def state(self) -> int:
        return self.step

    def restore(self, step: int) -> "SyntheticStream":
        self.step = step
        return self
