"""The port's serving engine against the JAX package's, on the CPU.

Both engines get the same weights (the JAX package's ``init_params``,
carried over by ``params_from_jax``), the same prompts and the same
schedule: slots 2, more requests than slots, prompt buckets of 16, 32
and 64 (= ``max_seq``, which fills the cache directly), greedy, in fp32
with ``attn_impl="flash"`` (the JAX prefill runs its Pallas kernel in
interpret mode, the port's the plain version).

With random weights, greedy decoding repeats one token per request, so
equal token streams prove little: the real check is the logits, step by
step (the prefill logits at every prompt position, then each decode
step's logits of every live slot), within 1e-4 of max|logits|.
Deadline expiry, priority order, eos and more requests than slots carry
over from tests/test_serving.py and the JAX engine's own contract.
"""
import importlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_arch as jax_reduced_arch
from repro.models import init_params as jax_init_params
from repro.runtime.serving import ServingEngine as JaxEngine
from repro_torch.configs.registry import reduced_arch
from repro_torch.models import forward
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime.serving import ServingEngine, _bucket

serving = importlib.import_module("repro_torch.runtime.serving")

F32_BAR = 1e-4
SMALL = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
             d_ff=128, vocab_size=256, head_dim=32, dtype="float32")
PROMPT_LENS = (5, 20, 50, 9)       # buckets 16, 32, 64 (= max_seq), 16
MAX_SEQ, N_NEW = 64, 6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced_arch("qwen2.5-3b", attn_impl="flash", **SMALL)
    cfg = reduced_arch("qwen2.5-3b", attn_impl="flash", **SMALL)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    # nonzero QKV biases, so that the engines see them
    for name in ("bq", "bk", "bv"):
        x = jp["blocks"]["attn"][name]
        jp["blocks"]["attn"][name] = jnp.asarray(
            rng.standard_normal(x.shape).astype(np.float32) * 0.1)
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, cfg, tp


def _prompts(seed=0, lens=PROMPT_LENS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).tolist() for n in lens]


class _JaxRecorder(JaxEngine):
    """The JAX engine, recording the prefill logits and each decode
    tick's logits with its live slots."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.prefills, self.ticks = [], []

    def _prefill_fn(self, plen):
        fn = super()._prefill_fn(plen)

        def rec(p, t, c):
            logits, c = fn(p, t, c)
            self.prefills.append(np.asarray(logits[0], np.float32))
            return logits, c
        return rec

    def _sample(self, logits):
        if logits.shape[0] == self.slots:
            live = [s for s, r in self.active.items() if r is not None]
            self.ticks.append((live, np.asarray(logits, np.float32)))
        return super()._sample(logits)


class _Recorder(ServingEngine):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.ticks = []

    def _sample(self, logits):
        if logits.shape[0] == self.slots:
            live = [s for s, r in self.active.items() if r is not None]
            self.ticks.append((live, logits.float().numpy()))
        return super()._sample(logits)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_bucket_matches_jax():
    from repro.runtime.serving import _bucket as jax_bucket
    for n in (1, 5, 16, 17, 50, 64, 65, 2032):
        assert _bucket(n) == jax_bucket(n)


def test_engine_matches_jax_engine_logits_and_tokens(setup, monkeypatch):
    jcfg, jp, cfg, tp = setup
    prompts = _prompts()
    assert {_bucket(len(p)) for p in prompts} == {16, 32, MAX_SEQ}

    jeng = _JaxRecorder(jcfg, jp, slots=2, max_seq=MAX_SEQ)
    prefills = []

    def recording_forward(*a, **kw):
        out = forward(*a, **kw)
        if kw.get("mode") == "prefill":
            prefills.append(out[0][0].float().numpy())
        return out
    monkeypatch.setattr(serving, "forward", recording_forward)
    eng = _Recorder(cfg, tp, slots=2, max_seq=MAX_SEQ, device="cpu")
    for e in (jeng, eng):
        for p in prompts:
            e.add_request(p, max_new_tokens=N_NEW)
    jdone = {r.uid: r.generated for r in jeng.run_to_completion()}
    done = {r.uid: r for r in eng.run_to_completion()}

    assert len(done) == len(prompts)
    assert {u: r.generated for u, r in done.items()} == jdone
    assert all(r.status == "ok" and len(r.generated) == N_NEW
               for r in done.values())
    # prefill: every prompt position, in admission order (FIFO here)
    assert len(prefills) == len(jeng.prefills) == len(prompts)
    for p, got, want in zip(prompts, prefills, jeng.prefills):
        assert got.shape == want.shape == (_bucket(len(p)), cfg.vocab_size)
        assert _rel(got[:len(p)], want[:len(p)]) <= F32_BAR
    # decode: every tick, every live slot
    assert len(eng.ticks) == len(jeng.ticks) > N_NEW
    for (live, got), (jlive, want) in zip(eng.ticks, jeng.ticks):
        assert live == jlive
        assert _rel(got[live], want[live]) <= F32_BAR


def test_engine_matches_no_cache_forward(setup):
    """Each generated token is the greedy token of a train-mode forward
    over the prompt and the tokens before it, with no cache."""
    _, _, cfg, tp = setup
    prompts = _prompts(seed=3, lens=(7, 12))
    eng = ServingEngine(cfg, tp, slots=2, max_seq=MAX_SEQ, device="cpu")
    for p in prompts:
        eng.add_request(p, max_new_tokens=4)
    by_uid = {r.uid: r.generated for r in eng.run_to_completion()}
    for uid, prompt in enumerate(prompts):
        toks = list(prompt)
        for _ in range(4):
            logits, _, _ = forward(cfg, tp, torch.tensor([toks]),
                                   mode="train")
            toks.append(int(torch.argmax(logits[0, -1])))
        assert by_uid[uid] == toks[len(prompt):]


def test_engine_more_requests_than_slots(setup):
    _, _, cfg, tp = setup
    rng = np.random.default_rng(1)
    eng = ServingEngine(cfg, tp, slots=2, max_seq=MAX_SEQ, device="cpu")
    for _ in range(5):
        eng.add_request(rng.integers(0, 256, size=6).tolist(),
                        max_new_tokens=3)
    finished = eng.run_to_completion()
    assert len(finished) == 5
    assert all(len(r.generated) == 3 for r in finished)
    assert eng.stats["prefill_tokens"] == 30
    assert eng.stats["decode_tokens"] == 5 * 2
    assert all(r.t_first is not None and r.t_first >= r.t_submit
               for r in finished)


def test_engine_eos_stops(setup):
    _, _, cfg, tp = setup
    prompt = [3, 1, 4, 1, 5]
    logits, _, _ = forward(cfg, tp, torch.tensor([prompt]), mode="train")
    first = int(torch.argmax(logits[0, -1]))
    eng = ServingEngine(cfg, tp, slots=1, max_seq=MAX_SEQ, device="cpu")
    eng.add_request(prompt, max_new_tokens=8, eos_id=first)
    finished = eng.run_to_completion()
    assert finished[0].generated == [first]


@pytest.mark.parametrize("engine", ["jax", "port"])
def test_deadline_expires_waiting_requests(setup, engine):
    """A request past its deadline while still waiting fails fast and
    takes no slot; one without a deadline is served."""
    jcfg, jp, cfg, tp = setup
    eng = JaxEngine(jcfg, jp, slots=1, max_seq=MAX_SEQ) if engine == "jax" \
        else ServingEngine(cfg, tp, slots=1, max_seq=MAX_SEQ, device="cpu")
    a = eng.add_request([1, 2, 3], max_new_tokens=2)
    b = eng.add_request([4, 5, 6], max_new_tokens=2, deadline_s=1e-3)
    time.sleep(0.01)
    done = {r.uid: r for r in eng.run_to_completion()}
    assert done[a].status == "ok" and len(done[a].generated) == 2
    assert done[b].status == "deadline" and done[b].generated == []


@pytest.mark.parametrize("engine", ["jax", "port"])
def test_priority_admits_first(setup, engine):
    """Priority first, earliest deadline next, FIFO last."""
    jcfg, jp, cfg, tp = setup
    eng = JaxEngine(jcfg, jp, slots=1, max_seq=MAX_SEQ) if engine == "jax" \
        else ServingEngine(cfg, tp, slots=1, max_seq=MAX_SEQ, device="cpu")
    uids = [eng.add_request([7, 8, 9], max_new_tokens=1) for _ in range(2)]
    late = eng.add_request([7, 8, 9], max_new_tokens=1, deadline_s=60.0)
    soon = eng.add_request([7, 8, 9], max_new_tokens=1, deadline_s=30.0)
    vip = eng.add_request([7, 8, 9], max_new_tokens=1, priority=1)
    order = [r.uid for r in eng.run_to_completion()]
    assert order == [vip, soon, late, *uids]


def test_temperature_sampling_is_seeded(setup):
    """Temperature sampling draws from the engine's generator: the same
    seed gives the same tokens (not the JAX engine's bits)."""
    _, _, cfg, tp = setup
    runs = []
    for _ in range(2):
        eng = ServingEngine(cfg, tp, slots=2, max_seq=MAX_SEQ,
                            temperature=1.0, seed=5, device="cpu")
        for p in _prompts(seed=4, lens=(6, 10)):
            eng.add_request(p, max_new_tokens=5)
        runs.append({r.uid: r.generated for r in eng.run_to_completion()})
    assert runs[0] == runs[1]
    assert all(0 <= t < cfg.vocab_size for g in runs[0].values() for t in g)


def test_engine_refuses_parameters_elsewhere(setup):
    _, _, cfg, tp = setup
    with pytest.raises(ValueError, match="lie on meta"):
        ServingEngine(cfg, dict(tp, embed=tp["embed"].to("meta")),
                      device="cpu")


def test_serve_launcher_on_cpu(capsys):
    from repro_torch.launch import serve
    finished = serve.main(["--device", "cpu", "--requests", "3",
                           "--max-new", "2", "--priority-every", "2"])
    assert len(finished) == 3
    out = capsys.readouterr().out
    assert out.startswith("served 3 requests, 6 tokens")
