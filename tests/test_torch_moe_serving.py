"""The port's serving engine on the moe family against the JAX package's
engine, on the CPU.

Both engines get the same weights (the JAX tree of
``test_torch_moe_models.jax_params``, carried over by
``params_from_jax``), the same prompts and the same schedule: reduced
Arctic and reduced DeepSeek-V3 at 2 layers, fp32, slots 2, prompt
buckets of 16 and 32 (= ``max_seq``: DeepSeek's prefill then takes the
expanded branch, a shorter bucket the absorbed one), greedy.  The
tokens must be the same, and the logits (each prefill's at every prompt
position, each decode tick's of every live slot) within 1e-4 of
max|logits|.

The JAX engine decodes its slots under ``vmap``, so each slot's MoE
dispatch sees one token and drops none; the port decodes the slots as
one batch and routes each row on its own to match.  A rigged router,
which sends every token to the same two experts, shows it: the port's
engine equals the JAX engine there, and the same engine with the rows
routed together (capacity 1 for two live slots) does not.
"""
import importlib

import numpy as np
import pytest
import torch

from repro.runtime.serving import ServingEngine as JaxEngine
from repro_torch.models import layers
from repro_torch.runtime.serving import ServingEngine, _bucket

from test_torch_moe_models import ARCHS, models
from test_torch_serving import _JaxRecorder, _Recorder

serving = importlib.import_module("repro_torch.runtime.serving")

F32_BAR = 1e-4
MAX_SEQ, N_NEW = 32, 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _serve(jcfg, jp, cfg, tp, prompts, monkeypatch):
    """Both engines on the same prompts: (JAX engine, port engine, the
    port's prefill logits, each engine's tokens by uid)."""
    jeng = _JaxRecorder(jcfg, jp, slots=2, max_seq=MAX_SEQ)
    prefills = []
    forward = serving.forward

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
    done = {r.uid: r.generated for r in eng.run_to_completion()}
    return jeng, eng, prefills, jdone, done


def _ticks_agree(eng, jeng):
    assert len(eng.ticks) == len(jeng.ticks) >= N_NEW - 1
    errs = []
    for (live, got), (jlive, want) in zip(eng.ticks, jeng.ticks):
        assert live == jlive
        errs.append(_rel(got[live], want[live]))
    return errs


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(arch, monkeypatch):
    jcfg, jp, cfg, tp = models(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (5, 20, 9)]
    assert {_bucket(len(p)) for p in prompts} == {16, MAX_SEQ}
    jeng, eng, prefills, jdone, done = _serve(jcfg, jp, cfg, tp, prompts,
                                              monkeypatch)
    assert done == jdone and all(len(g) == N_NEW for g in done.values())
    assert len(prefills) == len(jeng.prefills) == len(prompts)
    for p, got, want in zip(prompts, prefills, jeng.prefills):
        assert got.shape == want.shape == (_bucket(len(p)), cfg.vocab_size)
        assert _rel(got[:len(p)], want[:len(p)]) <= F32_BAR
    assert max(_ticks_agree(eng, jeng)) <= F32_BAR


def _rig_router(jp, cfg, seed=1):
    """Every token to the same two experts: a common direction u added to
    every embedding row, and router columns 0 and 1 along u (in the JAX
    tree, before it is carried over).  DeepSeek-V3's aux-free bias then
    picks the second: expert 0 takes nearly all the probability, and the
    largest bias among the rest outweighs what is left."""
    import jax
    import jax.numpy as jnp
    u = np.random.default_rng(seed).standard_normal(cfg.d_model)
    u /= np.linalg.norm(u)
    jp = jax.tree.map(lambda a: a, jp)
    jp["embed"] = jp["embed"] + jnp.asarray(0.5 * u, jp["embed"].dtype)
    for key in ("blocks", "mla_moe"):
        if key in jp:
            r = np.array(jp[key]["moe"]["router"])
            r[..., 0], r[..., 1] = 3.0 * u, 2.0 * u
            jp[key]["moe"]["router"] = jnp.asarray(r)
    return jp


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_decode_drops_no_token(arch, monkeypatch):
    """Two live slots whose tokens all go to the same two experts: routed
    together (two tokens, capacity 1) the second slot's token would be
    dropped at both; the JAX engine routes each slot alone and keeps it,
    and so does the port's batched decode."""
    from repro_torch.models.convert import params_from_jax
    import jax
    jcfg, jp, cfg, _ = models(arch)
    jp = _rig_router(jp, cfg)
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    assert layers.moe_capacity(2, cfg.moe) == 1
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (6, 10)]
    jeng, eng, _, jdone, done = _serve(jcfg, jp, cfg, tp, prompts,
                                       monkeypatch)
    xt = layers.apply_norm(tp["ln_f"], tp["embed"][:8][None], cfg)
    _, top_idx, _ = layers.moe_route(
        tp[("mla_moe" if cfg.mla else "blocks")][-1]["moe"], xt, cfg)
    pairs = {tuple(r) for r in top_idx.sort(-1).values.reshape(
        -1, cfg.moe.top_k).tolist()}
    assert len(pairs) == 1 and 0 in pairs.pop()
    assert done == jdone
    assert max(_ticks_agree(eng, jeng)) <= F32_BAR

    # the same engine with the rows routed together
    apply_moe = layers.apply_moe
    monkeypatch.setattr(layers, "apply_moe", lambda p, x, cfg, **kw:
                        apply_moe(p, x, cfg))
    joint = _Recorder(cfg, tp, slots=2, max_seq=MAX_SEQ, device="cpu")
    for p in prompts:
        joint.add_request(p, max_new_tokens=N_NEW)
    joint.run_to_completion()
    both_live = [i for i, (live, _) in enumerate(jeng.ticks)
                 if len(live) == 2]
    assert both_live
    errs = _ticks_agree(joint, jeng)
    assert min(errs[i] for i in both_live) > 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_serves_the_moe_archs(arch, capsys):
    from repro_torch.launch import serve
    finished = serve.main(["--arch", arch, "--device", "cpu", "--requests",
                           "3", "--max-new", "2"])
    assert len(finished) == 3 and all(len(r.generated) == 2
                                      for r in finished)
    assert capsys.readouterr().out.startswith("served 3 requests, 6 tokens")
