"""The port's chunked attention branch, remat, ``cross_entropy`` and
``loss_fn`` against the JAX package, on the CPU.

The chunked branch (sequences longer than ``chunk_q`` with
``attn_impl="xla"``) against the JAX package's under ``jax.grad`` for
causal inputs, and against the port's own one-shot branch for every
input.  Tolerances (fp32): forward <= 1e-5 of max|out|, gradients <= 1e-4
of max|grad| (sums in another order; measured 1e-7 - 6e-7).

The reference pads kv with position 2^30 and hides the padded slots only
through its mask, which masks nothing for non-causal attention with no
window and no ``kv_len``: the zero-padded keys then score 0 and count in
the softmax (ROADMAP.md Queue 3).  The port masks them always; a test
pins the reference's gap.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro.configs.registry import reduced_arch as jax_reduced_arch
from repro.models import layers as jax_layers
from repro.models import model as jax_model
import repro_torch.models as tm
from repro_torch.configs.registry import reduced_arch
from repro_torch.models import layers
from repro_torch.models.convert import params_from_jax

FWD_BAR, GRAD_BAR = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _qkv(b, sq, skv, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, np.float32) for s in (
        (b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d), (b, sq, h, d))]


def _port(q, k, v, w, **kw):
    """(out, (dq, dk, dv)) of the port's attention, the gradient of
    sum(out * w)."""
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = layers.attention(*ts, **kw)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax(q, k, v, w, **kw):
    """The JAX branch's output and ``jax.grad`` of sum(out * w), in one
    jitted call."""
    def f(*a):
        out = jax_layers.attention(*a, **kw)
        return jnp.sum(out * w), out
    args = [jnp.asarray(x) for x in (q, k, v)]
    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


CASES = {
    # (b, sq, skv, h, hkv, d), window, softcap
    "ragged": ((2, 160, 160, 4, 4, 16), None, None),
    "gqa": ((1, 160, 160, 8, 2, 16), None, None),
    "gqa_mqa_ragged": ((2, 100, 100, 4, 1, 32), None, None),
    "gemma2_window_softcap": ((1, 160, 160, 4, 2, 16), 40, 50.0),
    "window_shorter_than_chunk": ((1, 200, 200, 2, 2, 16), 24, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_matches_jax_forward_and_grad(case):
    """Causal, chunks of 64 (the reduced configs'): forward and the
    gradient of every input against ``jax.grad`` of the JAX branch."""
    shape, window, cap = CASES[case]
    q, k, v, w = _qkv(*shape)
    sq, skv = shape[1], shape[2]
    kw = dict(causal=True, window=window, attn_softcap=cap, chunk_q=64,
              chunk_kv=64)
    got, dgot = _port(q, k, v, w, q_pos=torch.arange(sq),
                      kv_pos=torch.arange(skv), **kw)
    want, dwant = _jax(q, k, v, w, q_pos=jnp.arange(sq),
                       kv_pos=jnp.arange(skv), **kw)
    assert _rel(got, want) <= FWD_BAR
    for g, gw in zip(dgot, dwant):
        assert _rel(g, gw) <= GRAD_BAR


@pytest.mark.parametrize("cq,ckv", [(64, 64), (64, 32), (48, 80)])
def test_chunked_equals_one_shot_for_any_chunks(cq, ckv):
    """Exact online softmax: the chunked branch is the one-shot branch
    whatever the chunk shapes (ragged at both), forward and gradient."""
    q, k, v, w = _qkv(2, 150, 150, 4, 2, 16, seed=1)
    pos = dict(q_pos=torch.arange(150), kv_pos=torch.arange(150))
    got, dgot = _port(q, k, v, w, chunk_q=cq, chunk_kv=ckv, **pos)
    want, dwant = _port(q, k, v, w, **pos)
    assert _rel(got, want) <= FWD_BAR
    for g, gw in zip(dgot, dwant):
        assert _rel(g, gw) <= GRAD_BAR


@pytest.mark.parametrize("window,kv_len", [(None, None), (30, None),
                                           (None, 90)])
def test_non_causal_ragged_matches_one_shot(window, kv_len):
    """Non-causal, ragged lengths (S 100 over Skv 120, chunks of 64): the
    port masks its padded kv slots whatever the mask says, so the chunked
    branch is the one-shot branch."""
    q, k, v, w = _qkv(1, 100, 120, 2, 2, 16, seed=2)
    kw = dict(causal=False, window=window,
              kv_len=None if kv_len is None else torch.tensor(kv_len),
              q_pos=torch.arange(100), kv_pos=torch.arange(120))
    got, dgot = _port(q, k, v, w, chunk_q=64, chunk_kv=64, **kw)
    want, dwant = _port(q, k, v, w, **kw)
    assert _rel(got, want) <= FWD_BAR
    for g, gw in zip(dgot, dwant):
        assert _rel(g, gw) <= GRAD_BAR


def test_reference_non_causal_defect_pinned():
    """The reference's chunked branch counts the zero-padded kv slots of
    a ragged non-causal input in its softmax: q, k, v (1, 100, 2, 16),
    numpy seed 0, chunks of 64, its chunked output ~0.1 of max|out| from
    its own one-shot output; the port's chunked output is its one-shot
    output, which the JAX one-shot branch agrees with."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 100, 2, 16), np.float32)
               for _ in range(3))
    jpos = dict(q_pos=jnp.arange(100), kv_pos=jnp.arange(100),
                causal=False)
    args = [jnp.asarray(x) for x in (q, k, v)]
    j_chunk = np.asarray(jax_layers.attention(*args, chunk_q=64, chunk_kv=64,
                                              **jpos))
    j_one = np.asarray(jax_layers.attention(*args, **jpos))
    tpos = dict(q_pos=torch.arange(100), kv_pos=torch.arange(100),
                causal=False)
    targs = [torch.from_numpy(x) for x in (q, k, v)]
    t_chunk = layers.attention(*targs, chunk_q=64, chunk_kv=64, **tpos)
    assert _rel(j_chunk, j_one) > 0.05          # the reference's gap
    assert _rel(t_chunk.numpy(), j_one) <= FWD_BAR
    # causal: the mask hides the padded slots, and the two agree
    jc = np.asarray(jax_layers.attention(*args, chunk_q=64, chunk_kv=64,
                                         q_pos=jnp.arange(100),
                                         kv_pos=jnp.arange(100)))
    tc = layers.attention(*targs, chunk_q=64, chunk_kv=64,
                          q_pos=torch.arange(100), kv_pos=torch.arange(100))
    assert _rel(tc.numpy(), jc) <= FWD_BAR


def test_chunked_bf16_matches_jax():
    """bf16 q, k, v (fp32 scores and carry, p rounded to bf16 before the
    value product, as the reference): the JAX suite's bf16 bar."""
    q, k, v, _ = _qkv(1, 160, 160, 4, 2, 16, seed=3)
    kw = dict(causal=True, chunk_q=64, chunk_kv=64)
    got = layers.attention(*(torch.from_numpy(x).bfloat16()
                             for x in (q, k, v)),
                           q_pos=torch.arange(160), kv_pos=torch.arange(160),
                           **kw)
    want = jax_layers.attention(*(jnp.asarray(x, jnp.bfloat16)
                                  for x in (q, k, v)),
                                q_pos=jnp.arange(160), kv_pos=jnp.arange(160),
                                **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=4e-2, atol=4e-2)


# ---------------------------------------------------------------------------
# The model: remat, cross_entropy, loss_fn
# ---------------------------------------------------------------------------

def _tiny(dtype="float32", **over):
    """The JAX suite's tiny trainer config (tests/test_trainer.py)."""
    kw = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
              d_ff=128, vocab_size=128, head_dim=32, dtype=dtype, **over)
    jcfg = jax_reduced_arch("qwen2.5-3b", **kw)
    cfg = reduced_arch("qwen2.5-3b", **kw)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, cfg, tp


def _batch(seq=96, b=2, vocab=128, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, seq + 1)).astype(np.int32)
    return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 9, 33), np.float32) * 3
    labels = rng.integers(0, 33, (2, 9))
    for z in (1e-4, 0.0):
        want = float(jax_model.cross_entropy(jnp.asarray(logits),
                                             jnp.asarray(labels), z_loss=z))
        got = float(tm.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels), z_loss=z))
        assert abs(got - want) <= 1e-6 * abs(want)
    bf = torch.from_numpy(logits).bfloat16()
    want = float(jax_model.cross_entropy(jnp.asarray(logits, jnp.bfloat16),
                                         jnp.asarray(labels)))
    assert abs(float(tm.cross_entropy(bf, labels)) - want) <= 1e-6 * want


@pytest.mark.parametrize("seq", [48, 96])
def test_loss_fn_and_grads_match_jax(seq):
    """loss_fn's metrics, and the gradient of every parameter against
    ``jax.grad``; at 96 tokens the layers take the chunked branch."""
    jcfg, jp, cfg, tp = _tiny()
    batch = _batch(seq)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in
                                       batch.items()}), has_aux=True))(jp)
    flat = [t.requires_grad_(True) for t in jax.tree.leaves(tp)]
    loss, met = tm.loss_fn(cfg, tp, batch)
    grads = torch.autograd.grad(loss, flat)
    met = {k: v.detach() for k, v in met.items()}
    assert set(met) == {"ce", "moe_aux", "loss"} == set(jmet)
    for key in met:
        assert abs(float(met[key]) - float(jmet[key])) <= \
            1e-5 * max(abs(float(jmet[key])), 1.0), key
    jconv = params_from_jax(cfg, jax.tree.map(np.asarray, jg), device="cpu")
    for g, want in zip(grads, jax.tree.leaves(jconv)):
        assert _rel(g.numpy(), want.numpy()) <= GRAD_BAR


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_remat_changes_memory_never_numbers(remat):
    """Each remat mode gives the "none" mode's loss and gradients bit for
    bit (rematerialization recomputes the same ops), through the chunked
    branch's own checkpointed steps."""
    _, _, cfg, tp = _tiny()
    batch = _batch(96, seed=1)

    def run(mode):
        c = dataclasses.replace(cfg, remat=mode)
        flat = [t.detach().clone().requires_grad_(True)
                for t in jax.tree.leaves(tp)]
        params = jax.tree.unflatten(jax.tree.structure(tp), flat)
        loss, _ = tm.loss_fn(c, params, batch)
        return loss, torch.autograd.grad(loss, flat)

    loss, grads = run(remat)
    loss0, grads0 = run("none")
    assert torch.equal(loss, loss0)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads0))


def test_remat_rejects_an_unknown_mode():
    _, _, cfg, tp = _tiny()
    c = dataclasses.replace(cfg, remat="everything")
    with pytest.raises(ValueError, match="remat"):
        tm.loss_fn(c, tp, _batch(16))


def test_loss_fn_refuses_moe_and_mtp():
    """What loss_fn once refused, the MoE term and DeepSeek-V3's
    multi-token prediction, now against the JAX package: reduced Arctic
    and DeepSeek-V3 at 2 layers (test_torch_moe_models.models), their
    metrics (``ce``, ``moe_aux``, ``mtp_ce``, ``loss``) and the gradient
    of every parameter against ``jax.grad``; the router bias, which only
    selects, has none in either."""
    from test_torch_moe_models import ARCHS, models
    for arch in ARCHS:
        jcfg, jp, cfg, tp = models(arch)
        batch = _batch(40, vocab=cfg.vocab_size, seed=2)
        (_, jmet), jg = jax.jit(jax.value_and_grad(
            lambda p: jm.loss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in
                                           batch.items()}),
            has_aux=True))(jp)
        flat = [t.requires_grad_(True) for t in jax.tree.leaves(tp)]
        loss, met = tm.loss_fn(cfg, tp, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        met = {k: v.detach() for k, v in met.items()}
        want = {"ce", "moe_aux", "loss"} | ({"mtp_ce"} if cfg.mtp else set())
        assert set(met) == set(jmet) == want
        assert float(met["moe_aux"]) > 0
        for key in met:
            assert abs(float(met[key]) - float(jmet[key])) <= \
                1e-5 * max(abs(float(jmet[key])), 1.0), (arch, key)
        jconv = params_from_jax(cfg, jax.tree.map(np.asarray, jg),
                                device="cpu")
        for g, w in zip(grads, jax.tree.leaves(jconv)):
            if not torch.any(w):
                assert g is None or not torch.any(g)
            else:
                assert _rel(g.numpy(), w.numpy()) <= GRAD_BAR, arch
