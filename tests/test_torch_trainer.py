"""The port's training runtime (``runtime.trainer``, ``launch.train``),
on the CPU.

- ``make_train_step`` with AdamW against the JAX package's jitted step,
  from the same state (``models.convert.train_state_from_jax``) and the
  same batches, fp32: one step from the initial state and three more,
  with and without gradient accumulation (``microbatch`` 2, and equal
  to the batch: slices of one row).  The parameters within 5e-4 of
  max|p|: the gradients sum in another order, and Adam divides each by
  its own magnitude (its first step from zero moments is g / (|g| +
  eps) times lr), which lifts the entries whose gradient is near eps;
  measured up to 1.9e-4 after the first step, 1.9e-5 - 7.9e-5 on steps
  from a later state.  The key bias, whose gradient is rounding alone,
  within 1e-3; the losses within 1e-5.
- ``Trainer`` (the JAX suite's tiny bf16 config): the loss falls, a
  ``SimulatedFailure`` then a restart resumes bit for bit, the
  watchdog, a Shampoo run, the instruments and spans.
- ``launch.train.main`` with ``--reduced --device cpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import reduced_arch as jax_reduced_arch
from repro.data import pipeline as jpipe
from repro.runtime import trainer as jtrainer
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import reduced_arch
from repro_torch.data.pipeline import DataConfig, get_batch
from repro_torch.launch import train as train_launch
from repro_torch.models.convert import train_state_from_jax
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.optim.tree import layer_groups, leaves
from repro_torch.runtime import (FailureInjector, SimulatedFailure,
                                 StragglerWatchdog, Trainer, make_optimizer,
                                 make_train_step)

TINY = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, d_ff=128,
            vocab_size=128, head_dim=32)
ROUNDING_DRIVEN = {("blocks", "attn", "bk"): 1e-3}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _tiny_cfg(**kw):
    return reduced_arch("qwen2.5-3b", **TINY, **kw)


def _tc(**kw):
    base = dict(learning_rate=3e-3, warmup_steps=5, total_steps=40,
                checkpoint_every=10, seed=0)
    base.update(kw)
    return TrainConfig(**base)


def _dc(**kw):
    return DataConfig(**{**dict(vocab_size=128, seq_len=32, global_batch=8,
                                seed=0, noise=0.0), **kw})


# ---------------------------------------------------------------------------
# make_train_step against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatch", [0, 2, 4])
def test_adamw_train_step_matches_jax(microbatch):
    """fp32, batches of 4 rows of 72 tokens (the chunked branch): the
    initial state carried over, then three steps of each package (two
    with four slices)."""
    jcfg = jax_reduced_arch("qwen2.5-3b", dtype="float32", **TINY)
    cfg = _tiny_cfg(dtype="float32")
    kw = dict(learning_rate=3e-3, warmup_steps=2, total_steps=20)
    jopt = jtrainer.make_optimizer(JaxTrainConfig(**kw))
    jstep = jax.jit(jtrainer.make_train_step(jcfg, jopt,
                                             microbatch=microbatch))
    tstep = make_train_step(cfg, make_optimizer(TrainConfig(**kw)),
                            microbatch=microbatch)
    params = jm.init_params(jcfg, jax.random.PRNGKey(0))
    js = {"step": jnp.zeros((), jnp.int32), "params": params,
          "opt_state": jopt.init(params)}
    dc = dict(vocab_size=128, seq_len=72, global_batch=4, seed=1)
    ts = train_state_from_jax(cfg, jax.tree.map(np.asarray, js),
                              device="cpu")
    for step in range(3 if microbatch < 4 else 2):
        js, jmet = jstep(js, jpipe.get_batch(jpipe.DataConfig(**dc), step))
        ts, tmet = tstep(ts, get_batch(DataConfig(**dc), step))
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for key in ("loss", "ce", "loss_mean", "grad_norm"):
            assert abs(float(tmet[key]) - float(jmet[key])) <= \
                1e-5 * abs(float(jmet[key])), (key, step)
        want = train_state_from_jax(cfg, jax.tree.map(np.asarray, js),
                                    device="cpu")
        for (path, got), (_, w) in zip(layer_groups(ts["params"]),
                                       layer_groups(want["params"])):
            for a, b in zip(got if isinstance(got, list) else [got],
                            w if isinstance(w, list) else [w]):
                bar = max(5e-4, ROUNDING_DRIVEN.get(path, 0))
                assert _rel(a.detach(), b) <= bar, (path, step)


def test_microbatch_equal_to_the_batch_accumulates_in_fp32():
    """``microbatch`` = the batch's rows (slices of one row): the
    accumulated fp32 gradient equals the mean of the rows' gradients,
    and its loss the mean of their losses; the metrics are the last
    row's."""
    from repro_torch.models import loss_fn
    cfg = _tiny_cfg(dtype="float32")
    params = __import__("repro_torch").models.init_params(cfg, 0,
                                                          device="cpu")
    batch = get_batch(_dc(global_batch=4), 0)
    seen = {}

    class Capture:
        def update(self, grads, state, params, step):
            seen["grads"] = grads
            return jax.tree.map(torch.zeros_like, params), state, {}
    step = make_train_step(cfg, Capture(), microbatch=4)
    _, met = step({"step": torch.zeros((), dtype=torch.int32),
                   "params": params, "opt_state": {}}, batch)
    flat = leaves(params)
    rows, losses = [], []
    for i in range(4):
        loss, m = loss_fn(cfg, params, {k: v[i:i + 1]
                                        for k, v in batch.items()})
        rows.append(torch.autograd.grad(loss, flat))
        losses.append(float(loss.detach()))
    assert abs(float(met["loss_mean"]) - np.mean(losses)) <= 1e-6
    assert abs(float(met["loss"]) - losses[-1]) <= 1e-6
    for i, g in enumerate(leaves(seen["grads"])):
        assert g.dtype == torch.float32
        want = sum(r[i] for r in rows) / 4
        assert _rel(g.numpy(), want.numpy()) <= 1e-6


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

def test_loss_decreases(tmp_path):
    tr = Trainer(_tiny_cfg(), _tc(), _dc(), str(tmp_path), device="cpu")
    hist = tr.run(30)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.2, (first, last)
    assert tr.state["params"]["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("optimizer", ["adamw", "shampoo"])
def test_failure_injection_and_bitexact_resume(tmp_path, optimizer):
    """A run killed at step 14 (after the checkpoint at 10) restarts from
    step 10 and reaches step 20 with the uninterrupted run's parameters
    and optimizer state, bit for bit."""
    cfg, dc = _tiny_cfg(), _dc()
    tc = _tc(optimizer=optimizer, shampoo_block_size=32,
             shampoo_precond_interval=4)
    ref = Trainer(cfg, tc, dc, str(tmp_path / "ref"), device="cpu")
    ref.run(20)
    crash = str(tmp_path / "crash")
    tr = Trainer(cfg, tc, dc, crash, failure=FailureInjector(14),
                 device="cpu")
    with pytest.raises(SimulatedFailure):
        tr.run(20)
    assert tr.step == 14
    tr.ckpt.wait()                  # the async writer's last commit
    tr2 = Trainer(cfg, tc, dc, crash, device="cpu")
    assert tr2.step == 10, "restored from the last committed checkpoint"
    assert tr2.state["step"].dtype == torch.int32
    tr2.run(20)
    for key in ("params", "opt_state"):
        got, want = leaves(tr2.state[key]), leaves(ref.state[key])
        assert len(got) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), key
    assert [h["loss"] for h in tr2.metrics_history] == \
        [h["loss"] for h in ref.metrics_history[10:]]


def test_straggler_watchdog_flags():
    wd = StragglerWatchdog(warmup=2, threshold=2.0)
    for _ in range(6):
        assert not wd.observe(0.1)
    assert wd.observe(0.5)               # 5x slower -> flagged
    assert len(wd.flagged) == 1
    assert not wd.observe(0.11)          # back to normal


def test_shampoo_trainer_runs(tmp_path):
    tc = _tc(optimizer="shampoo", shampoo_block_size=64,
             shampoo_precond_interval=5, ata_levels=1)
    tr = Trainer(_tiny_cfg(), tc, _dc(), str(tmp_path), device="cpu")
    hist = tr.run(8)
    assert all(np.isfinite(h["loss"]) for h in hist)
    gram = tr.state["opt_state"]["gram"]
    assert tuple(gram["blocks"]["mlp"]["w_up"]["l"].shape) == (4, 64, 64)
    assert float(gram["blocks"]["mlp"]["w_up"]["l"].abs().max()) > 0


def test_trainer_instruments_and_spans(tmp_path):
    obs_metrics.reset()
    old = obs_trace.get_tracer()
    tracer = obs_trace.set_tracer(obs_trace.Tracer(enabled=True))
    try:
        tr = Trainer(_tiny_cfg(), _tc(checkpoint_every=2), _dc(),
                     str(tmp_path), device="cpu")
        tr.run(3)
        names = [e.name for e in tracer.events()]
    finally:
        obs_trace.set_tracer(old)
    snap = {k: v["series"][""] for k, v in obs_metrics.snapshot().items()}
    assert snap["trainer_steps_total"] == 3
    assert snap["trainer_step_s"]["count"] == 3
    assert snap["trainer_loss"] == tr.metrics_history[-1]["loss"]
    assert names.count("train_step") == 3
    assert names.count("checkpoint_save") == 2      # steps 2 and 3
    assert tr.ckpt.all_steps() == [2, 3]


def test_trainer_refuses_to_run_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the trainer runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(_tiny_cfg(), _tc(), _dc(), str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_launch.main(["--arch", "qwen2.5-3b", "--reduced", "--steps",
                           "1", "--workdir", str(tmp_path)])


def test_launch_train_main(tmp_path, capsys):
    hist = train_launch.main(["--arch", "qwen2.5-3b", "--reduced",
                              "--device", "cpu", "--steps", "6", "--batch",
                              "2", "--seq", "80", "--lr", "3e-3",
                              "--workdir", str(tmp_path),
                              "--checkpoint-every", "3"])
    assert len(hist) == 6 and hist[-1]["loss"] < hist[0]["loss"]
    assert "steps=6 loss" in capsys.readouterr().out
    # the workdir now holds step 6: a second run to step 8 resumes there
    more = train_launch.main(["--arch", "qwen2.5-3b", "--reduced",
                              "--device", "cpu", "--steps", "8", "--batch",
                              "2", "--seq", "80", "--lr", "3e-3",
                              "--workdir", str(tmp_path)])
    assert len(more) == 2
