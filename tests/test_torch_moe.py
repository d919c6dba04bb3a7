"""The port's MoE layer against the JAX package's, on the CPU.

The same weights (the JAX package's ``init_moe``, carried over bit for
bit) and the same tokens (numpy, from a seed) go through
``repro.models.layers.apply_moe`` (its branch without a mesh policy) and
``repro_torch.models.layers.apply_moe``, for reduced Arctic (8 experts,
top-2, no shared expert) and reduced DeepSeek-V3 (8 experts, top-2, one
shared expert, the aux-free router bias): with capacity to spare and
with a capacity factor that drops tokens, with expert ids that tie in
the sort (every token on the same two experts), with a bias that moves
the selection, and each row routed on its own (the JAX engine's vmap
over its slots).

Tolerances: fp32 1e-4 of max|out| (sums in another order); bf16 0.1 of
max|out| (the two frameworks round to bf16 at other places); the
load-balance term and the gradients in fp32 1e-5 and 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_arch as jax_reduced_arch
from repro.models import layers as jax_layers
from repro_torch.configs.registry import reduced_arch
from repro_torch.models import layers
from repro_torch.models.convert import _tensor

ARCHS = ("arctic-480b", "deepseek-v3-671b")
F32_BAR, BF16_BAR = 1e-4, 1e-1
T = 48                              # tokens: 2 rows of 24


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _cfgs(arch, dtype="float32", capacity_factor=0.0):
    jcfg = jax_reduced_arch(arch, dtype=dtype)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=capacity_factor))
    cfg = reduced_arch(arch, dtype=dtype)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    return jcfg, cfg


def _weights(jcfg, seed=0, bias=None):
    jp = jax_layers.init_moe(jcfg, jax.random.PRNGKey(seed))
    if bias is not None:
        jp["router_bias"] = jnp.asarray(bias, jnp.float32)
    return jp, jax.tree.map(lambda a: _tensor(np.asarray(a), "cpu"), jp)


def _x(cfg, seed=1, rows=2):
    x = np.random.default_rng(seed).standard_normal(
        (rows, T // rows, cfg.d_model), np.float32)
    return x


def _both(jcfg, cfg, jp, tp, x, rows_apart=False):
    dt = jnp.dtype(jcfg.dtype)
    jx = jnp.asarray(x, dt)
    if rows_apart:
        want, jaux = jax.jit(jax.vmap(lambda p, r: jax_layers.apply_moe(
            p, r[None], jcfg), in_axes=(None, 0)))(jp, jx)
        want = want[:, 0]
    else:
        want, jaux = jax.jit(lambda p, xx: jax_layers.apply_moe(
            p, xx, jcfg))(jp, jx)
    got, aux = layers.apply_moe(tp, _tensor(np.asarray(jx), "cpu"), cfg,
                                rows_apart=rows_apart)
    return (got.float().numpy(), float(aux)), \
        (np.asarray(want, np.float32), np.asarray(jaux))


def _dropped(cfg, tp, x):
    """How many token-expert assignments the port's joint routing of x
    drops (past an expert's capacity)."""
    xt = torch.from_numpy(x).reshape(1, -1, cfg.d_model).to(
        layers.dtype_of(cfg))
    _, top_idx, _ = layers.moe_route(tp, xt, cfg)
    hits = torch.bincount(top_idx.reshape(-1), minlength=cfg.moe.num_experts)
    cap = layers.moe_capacity(xt.shape[1], cfg.moe)
    return int((hits - cap).clamp_min(0).sum())


@pytest.mark.parametrize("tokens,k,e,cf", [
    (1, 2, 8, 0.0), (1, 8, 256, 0.0), (48, 2, 8, 0.0), (48, 2, 8, 0.5),
    (2048, 2, 128, 0.0), (2048, 8, 256, 0.0), (7, 2, 8, 4.0)])
def test_moe_capacity_matches_jax(tokens, k, e, cf):
    from repro.configs.base import MoEConfig as JMoE
    from repro_torch.configs.base import MoEConfig
    kw = dict(num_experts=e, top_k=k, d_expert=8, capacity_factor=cf)
    assert layers.moe_capacity(tokens, MoEConfig(**kw)) == \
        jax_layers.moe_capacity(tokens, JMoE(**kw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [0.0, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(arch, cf, dtype):
    """Capacity to spare (factor 1.25 by default: some experts still
    overflow at 48 tokens) and factor 0.5, which drops a good share."""
    jcfg, cfg = _cfgs(arch, dtype, cf)
    jp, tp = _weights(jcfg)
    x = _x(cfg)
    (got, aux), (want, jaux) = _both(jcfg, cfg, jp, tp, x)
    if cf:
        assert _dropped(cfg, tp, x) > T // 4
    bar = F32_BAR if dtype == "float32" else BF16_BAR
    assert got.shape == want.shape == (2, T // 2, cfg.d_model)
    assert _rel(got, want) <= bar
    assert abs(aux - float(jaux)) <= 1e-5 * abs(float(jaux))


@pytest.mark.parametrize("arch", ARCHS)
def test_tied_expert_ids_keep_the_first_tokens(arch):
    """A router that sends every token to experts 0 and 1: all 2T
    assignments tie on two expert ids, and the stable sort keeps each
    expert's first ``capacity`` tokens in token order (an unstable sort
    would keep others); the rest get no expert output."""
    jcfg, cfg = _cfgs(arch)
    jp, tp = _weights(jcfg)
    router = np.asarray(jp["router"]).copy()
    x = np.abs(_x(cfg, seed=2)) + 0.1
    router[:, 0], router[:, 1] = 1.0, 0.9
    jp["router"] = jnp.asarray(router)
    tp["router"] = torch.from_numpy(router)
    (got, _), (want, _) = _both(jcfg, cfg, jp, tp, x)
    assert _rel(got, want) <= F32_BAR
    cap = layers.moe_capacity(T, cfg.moe)
    assert cap < T
    # the tokens past the capacity get the shared expert's output alone
    flat = got.reshape(T, -1)
    shared = np.zeros_like(flat)
    if "shared" in tp:
        shared = layers.apply_mlp(tp["shared"], torch.from_numpy(
            x.reshape(T, -1)), cfg).numpy()
    assert np.abs(flat[cap:] - shared[cap:]).max() == 0.0
    assert np.abs(flat[:cap] - shared[:cap]).max(axis=1).min() > 0.0


def test_aux_free_bias_moves_the_selection_not_the_gates():
    """DeepSeek-V3's router bias: a bias on experts 5 and 6 selects them
    for every token; the gates stay the softmax probabilities of the
    selected experts, renormalized."""
    jcfg, cfg = _cfgs("deepseek-v3-671b")
    bias = np.zeros(cfg.moe.num_experts, np.float32)
    bias[[5, 6]] = 10.0
    jp, tp = _weights(jcfg, bias=bias)
    x = _x(cfg, seed=3)
    (got, _), (want, _) = _both(jcfg, cfg, jp, tp, x)
    assert _rel(got, want) <= F32_BAR
    xt = torch.from_numpy(x).reshape(1, T, -1)
    probs, top_idx, gates = layers.moe_route(tp, xt, cfg)
    assert set(top_idx.unique().tolist()) == {5, 6}
    p56 = probs[..., [5, 6]]
    assert torch.allclose(gates.sort(-1).values,
                          (p56 / p56.sum(-1, keepdim=True)).sort(-1).values)
    _, top0, _ = layers.moe_route(dict(tp, router_bias=torch.zeros(8)), xt,
                                  cfg)
    assert not torch.equal(top0, top_idx)


@pytest.mark.parametrize("arch", ARCHS)
def test_rows_apart_routes_each_row_alone(arch):
    """``rows_apart``: each row of one token is its own dispatch
    (capacity 1, nothing dropped), as the JAX engine's vmap over slots;
    routed together the same rows drop tokens and give another output."""
    jcfg, cfg = _cfgs(arch)
    jp, tp = _weights(jcfg)
    # eight rows of one token each, near one another: routed together
    # they pick the same experts and overflow a capacity of 2
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((1, 1, cfg.d_model))
         + 0.05 * rng.standard_normal((8, 1, cfg.d_model))).astype(np.float32)
    (got, _), (want, _) = _both(jcfg, cfg, jp, tp, x, rows_apart=True)
    assert got.shape == want.shape == (8, 1, cfg.d_model)
    assert _rel(got, want) <= F32_BAR
    assert _dropped(cfg, tp, x) > 0
    joint, _ = layers.apply_moe(tp, torch.from_numpy(x), cfg)
    assert _rel(joint.numpy(), want) > 1e-2


def test_moe_load_aux_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((40, 8)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    top = np.argsort(-probs, -1)[:, :2]
    want = float(jax_layers.moe_load_aux(jnp.asarray(probs),
                                         jnp.asarray(top), 8))
    got = float(layers.moe_load_aux(torch.from_numpy(probs),
                                    torch.from_numpy(top), 8))
    assert abs(got - want) <= 1e-6 * want


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_gradients_match_jax(arch):
    """The gradient of sum(out * w) + aux through the dispatch, the
    drops included (factor 0.5), of x and of every weight."""
    jcfg, cfg = _cfgs(arch, capacity_factor=0.5)
    jp, tp = _weights(jcfg)
    x = _x(cfg, seed=6)
    w = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def jf(p, xx):
        out, aux = jax_layers.apply_moe(p, xx, jcfg)
        return jnp.sum(out * w) + aux
    jgp, jgx = jax.jit(jax.grad(jf, argnums=(0, 1)))(jp, jnp.asarray(x))
    flat = [t.requires_grad_(True) for t in jax.tree.leaves(tp)]
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = layers.apply_moe(tp, xt, cfg)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum() + aux,
                                flat + [xt], allow_unused=True)
    assert _rel(grads[-1].numpy(), jgx) <= 1e-4
    for g, want in zip(grads[:-1], jax.tree.leaves(jgp)):
        if not np.any(want):            # the router bias: selection only
            assert g is None or not torch.any(g)
        else:
            assert _rel(g.numpy(), want) <= 1e-4
