"""Training runtime of the port: the train step (gradient accumulation),
the fault-tolerant loop (checkpoint/restart, failure injection), the
straggler watchdog.

The port of ``repro/runtime/trainer.py``.  The train step is a function
of (state, batch); the Trainer owns the impure parts — data stream
position, checkpoint cadence, wall-clock watchdog — all of which are
reconstructed exactly on restart (the stream is a pure function of the
step, checkpoints carry the step).

Where the JAX trainer jits the step and donates its state, the port's
step consumes the state it is given: the optimizer's moments and
statistics and the parameters are updated in place (the same numbers),
and only the returned state is to be used.  A full-depth model holds no
second copy of its parameters or moments.  The Trainer runs on the card
unless it is given ``device="cpu"``.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch

from ..checkpoint.manager import CheckpointManager
from ..configs.base import ModelConfig, TrainConfig
from ..data.pipeline import DataConfig, get_batch
from ..kernels.ops import resolve_device
from ..models import init_params, loss_fn
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..optim import adamw, apply_updates, shampoo, warmup_cosine
from ..optim.tree import leaves, tree_map, unflatten

log = logging.getLogger("repro_torch.trainer")

TrainState = Dict[str, Any]          # {"step", "params", "opt_state"}


class SimulatedFailure(RuntimeError):
    """Injected node failure (tests/fault-drills)."""


@dataclass
class FailureInjector:
    at_step: int = -1

    def check(self, step: int):
        if step == self.at_step:
            raise SimulatedFailure(f"injected failure at step {step}")


@dataclass
class StragglerWatchdog:
    """EWMA step-time monitor. At scale this signal triggers hot-spare
    swap / grouped restart; in-container we surface the detection."""
    alpha: float = 0.1
    threshold: float = 2.0
    warmup: int = 3
    ewma: float = 0.0
    count: int = 0
    flagged: list = field(default_factory=list)

    def observe(self, dt: float) -> bool:
        self.count += 1
        if self.count <= self.warmup:
            self.ewma = dt if self.ewma == 0 else 0.5 * (self.ewma + dt)
            return False
        slow = dt > self.threshold * self.ewma
        if slow:
            self.flagged.append((self.count, dt, self.ewma))
            log.warning("straggler: step %d took %.3fs (ewma %.3fs)",
                        self.count, dt, self.ewma)
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow


def make_optimizer(tc: TrainConfig):
    sched = warmup_cosine(tc.learning_rate, tc.warmup_steps, tc.total_steps)
    if tc.optimizer == "shampoo":
        return shampoo(sched, block_size=tc.shampoo_block_size,
                       stat_interval=tc.shampoo_update_interval,
                       precond_interval=tc.shampoo_precond_interval,
                       ata_levels=tc.ata_levels,
                       weight_decay=tc.weight_decay, grad_clip=tc.grad_clip)
    return adamw(sched, weight_decay=tc.weight_decay, grad_clip=tc.grad_clip)


def _slice(batch, i: int, k: int):
    """Microbatch ``i`` of ``k``: rows [i B/k, (i+1) B/k) of every entry,
    as the JAX package's reshape to (k, B/k, ...) takes them."""
    def one(x):
        rows = x.shape[0] // k
        return x[i * rows:(i + 1) * rows]
    return {key: one(x) for key, x in batch.items()}


def make_train_step(cfg: ModelConfig, optimizer, *,
                    microbatch: int = 0) -> Callable:
    """(state, batch) -> (state, metrics).  The state passed in is
    consumed (updated in place, as a donated state); use the returned
    one.  ``microbatch`` k > 0 accumulates the gradients of k slices of
    the batch in fp32 and reports the last slice's metrics and the mean
    loss."""

    def value_and_grad(params, batch):
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = loss_fn(cfg, params, batch)
            grads = torch.autograd.grad(loss, flat)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, list(grads)

    def compute_grads(params, batch):
        if not microbatch:
            loss, metrics, grads = value_and_grad(params, batch)
            return loss, metrics, unflatten(params, grads)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves(params)]
        l_sum = torch.zeros((), dtype=torch.float32)
        for i in range(microbatch):
            loss, metrics, grads = value_and_grad(
                params, _slice(batch, i, microbatch))
            for a, g in zip(acc, grads):
                a.add_(g.float())
            del grads
            l_sum = l_sum + loss.float().cpu()
        for a in acc:
            a.div_(microbatch)
        return l_sum / microbatch, metrics, unflatten(params, acc)

    def train_step(state: TrainState, batch):
        loss, metrics, grads = compute_grads(state["params"], batch)
        updates, opt_state, om = optimizer.update(
            grads, state["opt_state"], state["params"], state["step"])
        del grads
        params = apply_updates(state["params"], updates, in_place=True)
        new_state = {"step": state["step"] + 1, "params": params,
                     "opt_state": opt_state}
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss_mean"] = loss
        return new_state, metrics

    return train_step


class Trainer:
    """Fault-tolerant training loop over the synthetic stream, on
    ``device`` (the card unless ``device="cpu"``).  Its step always
    donates the state (the JAX trainer's ``donate=True``, which the port
    does not take as an option)."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, dc: DataConfig,
                 workdir: str, *,
                 failure: Optional[FailureInjector] = None, device=None):
        self.cfg, self.tc, self.dc = cfg, tc, dc
        self.device = resolve_device(device)
        self.opt = make_optimizer(tc)
        self.ckpt = CheckpointManager(workdir, keep=tc.keep_checkpoints)
        self.failure = failure or FailureInjector()
        self.watchdog = StragglerWatchdog()
        self.step_fn = make_train_step(cfg, self.opt, microbatch=tc.microbatch)
        self.state = self._init_or_restore()
        self.metrics_history: list = []

    def _init_or_restore(self) -> TrainState:
        state, meta = self.ckpt.restore()
        if state is not None:
            log.info("restored checkpoint at step %d", meta["step"])
            step = state.pop("step")
            state = tree_map(lambda t: t.to(self.device), state)
            state["step"] = step.to(torch.int32)
            return state
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        params = init_params(self.cfg, gen, device=self.device)
        return {"step": torch.zeros((), dtype=torch.int32), "params": params,
                "opt_state": self.opt.init(params)}

    @property
    def step(self) -> int:
        return int(self.state["step"])

    def run(self, num_steps: int):
        """Run until ``self.step == num_steps`` (absolute), checkpointing
        every tc.checkpoint_every; resumable after any crash."""
        step_s = obs_metrics.histogram(
            "trainer_step_s", "wall seconds per optimizer step")
        steps_total = obs_metrics.counter(
            "trainer_steps_total", "optimizer steps completed")
        loss_g = obs_metrics.gauge("trainer_loss", "last step's loss")
        while self.step < num_steps:
            step = self.step
            batch = get_batch(self.dc, step)   # pure fn of step: resumable
            t0 = time.perf_counter()
            with obs_trace.span("train_step", step=step):
                self.state, metrics = self.step_fn(self.state, batch)
                loss = float(metrics["loss"])    # waits for the step
            dt = time.perf_counter() - t0
            self.watchdog.observe(dt)
            step_s.observe(dt)
            steps_total.inc()
            loss_g.set(loss)
            self.metrics_history.append(
                {k: float(v) for k, v in metrics.items()})
            new_step = step + 1
            if new_step % self.tc.checkpoint_every == 0 \
                    or new_step == num_steps:
                with obs_trace.span("checkpoint_save", step=new_step):
                    self.ckpt.save(new_step, self.state)
            # failure injection AFTER the optimizer step, BEFORE the next
            # checkpoint boundary — the worst-case crash point.
            self.failure.check(new_step)
        self.ckpt.wait()
        return self.metrics_history
