"""The port's Mamba2 SSD layer and the ssm family (reduced Mamba2-2.7B)
against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through
``repro.models.layers`` and ``repro_torch.models.layers``: ``_segsum``,
``_ssd_chunked`` (a sequence a multiple of the chunk and a ragged one,
with and without an initial state, one group and two) and its
gradient, ``apply_ssm`` in prefill and decode, and ``ssm_block``.  The
whole model's weights are the JAX tree's layout (``jax.eval_shape`` of
``init_params``) with numpy draws at its leaves, carried over by
``params_from_jax``: ``forward`` in train, prefill and decode mode, the
caches leaf by leaf, ``loss_fn`` and its gradients.

The JAX functions run under ``jax.jit`` (one compile a shape, where
eager dispatch would compile each primitive).

Tolerances: fp32 1e-5 of max|out|; a gradient 1e-4 of its leaf's
max|grad| (a sum over every position, as the port's other gradient
tests); bf16 logits 0.1 of max|logits|.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro.configs.registry import get_arch as jax_get_arch
from repro.configs.registry import reduced_arch as jax_reduced_arch
from repro.models import blocks as jax_blocks
from repro.models import layers as jax_layers
import repro_torch.models as tm
from repro_torch.configs.registry import get_arch, reduced_arch
from repro_torch.models import blocks, layers
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import param_count, param_spec

F32_BAR, GRAD_BAR, BF16_BAR = 1e-5, 1e-4, 1e-1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel(got, want):
    got, want = (np.asarray(x.detach().float() if torch.is_tensor(x) else x,
                            np.float32) for x in (got, want))
    return float(np.abs(got - want).max() / np.abs(want).max())


def jax_params(jcfg, seed=0):
    """The JAX tree's layout with numpy draws at its leaves: weights
    normal * 0.02; norm scales, ``d_skip`` 1 + noise; biases, ``conv_b``
    and ``dt_bias`` small noise; ``a_log`` log(1..H) + noise (so that
    every leaf the tests hold matters)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(s.shape).astype(np.float32)
        last = name.rsplit("'", 2)[-2]
        if last in ("scale", "norm", "q_norm", "k_norm", "d_skip"):
            x = 1.0 + 0.1 * x
        elif last == "a_log":
            x = np.log(np.arange(1, s.shape[-1] + 1, dtype=np.float32)) \
                + 0.1 * x
        elif last in ("bias", "bq", "bk", "bv", "bo", "b_in", "b_out",
                      "conv_b", "dt_bias"):
            x = 0.1 * x
        else:
            x = 0.02 * x
        return jnp.asarray(x, s.dtype)
    shapes = jax.eval_shape(lambda k: jm.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def models(arch, dtype="float32", **over):
    """(JAX config, JAX params, port config, port params) of the reduced
    ``arch``, the port's carried over from the JAX tree.  Cached: the
    tests do not change them."""
    kw = dict(dtype=dtype, **over)
    jcfg, cfg = jax_reduced_arch(arch, **kw), reduced_arch(arch, **kw)
    jp = jax_params(jcfg)
    return jcfg, jp, cfg, params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                          device="cpu")


@functools.lru_cache(maxsize=None)
def jit(fn, *args, **kw):
    """``fn`` with ``args`` and ``kw`` bound (the configs, the modes),
    under ``jax.jit``; one jitted function for each binding, so that its
    compiles are shared between the tests."""
    return jax.jit(functools.partial(fn, *args, **kw))


def flat(tree, prefix=()):
    """(path, leaf) of a port tree of dicts and lists; a list index is an
    int in the path."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from flat(v, prefix + (i,))
    else:
        yield prefix, tree


def jax_leaf(tree, path):
    """The JAX leaf of a port path: the keys, then the layer index on the
    stacked leaf."""
    for k in path:
        if isinstance(k, str):
            tree = tree[k]
    for k in path:
        if isinstance(k, int):
            tree = tree[k]
    return tree


def tmap(fn, tree):
    if isinstance(tree, dict):
        return {k: tmap(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tmap(fn, v) for v in tree]
    return fn(tree)


def loss_grads_match(jcfg, jp, cfg, tp, batch, tbatch, bar=GRAD_BAR):
    """``loss_fn``'s metrics and every parameter's gradient, against
    ``jax.grad``: each leaf within ``bar`` of its max|grad|.  A leaf whose
    gradient is zero but for rounding (the key bias: the softmax does not
    see it), below 1e-6 of the largest leaf's in JAX, must be so in the
    port too."""
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(jcfg, p, b), has_aux=True))(jp, batch)
    params = tmap(lambda t: t.detach().clone().requires_grad_(True), tp)
    loss, met = tm.loss_fn(cfg, params, tbatch)
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    assert set(met) == set(jmet)
    top = max(float(np.abs(np.asarray(g, np.float32)).max())
              for g in jax.tree.leaves(jg))
    for path, t in flat(params):
        want = np.asarray(jax_leaf(jg, path), np.float32)
        if np.abs(want).max() <= 1e-6 * top:
            assert float(t.grad.abs().max()) <= 1e-6 * top, path
            continue
        assert rel(t.grad, want) <= bar, (path, rel(t.grad, want))


# ---------------------------------------------------------------------------
# The SSD layer
# ---------------------------------------------------------------------------

def _ssd_inputs(b, s, h, p, g, n, seed=0):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(0.1 * rng.standard_normal(h)).astype(np.float32) \
        * np.arange(1, h + 1, dtype=np.float32) / h
    bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    st = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return xh, dt, a, bm, cm, st


@pytest.mark.parametrize("shape", [(5,), (3, 8), (2, 4, 16)])
def test_segsum_matches_jax(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_layers._segsum(jnp.asarray(x)))
    got = layers._segsum(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == shape + (shape[-1],)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max() <= 1e-6 * np.abs(want[fin]).max()


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("seq", [32, 45])
def test_ssd_chunked_matches_jax(seq, init, groups):
    """Chunks of 16 over 32 (a multiple) and 45 (ragged: zero-padded
    inside), with and without an initial state, one group and two (head
    h reads group h // (H / G), ``jnp.repeat``'s order)."""
    xh, dt, a, bm, cm, st = _ssd_inputs(2, seq, 4, 8, groups, 6)
    kw = {"init_state": st} if init else {}
    wy, wst = jit(jax_layers._ssd_chunked, chunk=16)(
        *(jnp.asarray(x) for x in (xh, dt, a, bm, cm)),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    y, fst = layers._ssd_chunked(
        *(torch.from_numpy(x) for x in (xh, dt, a, bm, cm)), 16,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert y.shape == (2, seq, 4, 8) and fst.shape == (2, 4, 8, 6)
    assert y.dtype == fst.dtype == torch.float32
    assert rel(y, wy) <= F32_BAR
    assert rel(fst, wst) <= F32_BAR


def test_ssd_groups_are_repeated_not_tiled():
    """With G = 2 and 4 heads, heads 0 and 1 read group 0: swapping the
    groups' B and C swaps the output's head pairs (0, 1) and (2, 3)."""
    xh, dt, a, bm, cm, _ = _ssd_inputs(1, 20, 4, 8, 2, 6, seed=3)
    xh = np.broadcast_to(xh[:, :, :1], xh.shape).copy()
    dt = np.broadcast_to(dt[:, :, :1], dt.shape).copy()
    a = np.full_like(a, a[0])
    y, _ = layers._ssd_chunked(
        *(torch.from_numpy(x) for x in (xh, dt, a, bm, cm)), 8)
    ys, _ = layers._ssd_chunked(
        *(torch.from_numpy(x) for x in (xh, dt, a, bm[:, :, ::-1].copy(),
                                        cm[:, :, ::-1].copy())), 8)
    torch.testing.assert_close(ys, y[:, :, [2, 3, 0, 1]])
    assert not torch.allclose(y[:, :, 0], y[:, :, 2])


def test_ssd_padding_keeps_the_final_state():
    """A ragged sequence's final state (padded inside the scan with dt 0)
    is the state after its last true position: the same as the state of
    the same tokens run in chunks that divide them."""
    xh, dt, a, bm, cm, _ = _ssd_inputs(1, 40, 4, 8, 1, 6, seed=4)
    args = [torch.from_numpy(x) for x in (xh, dt, a, bm, cm)]
    _, ragged = layers._ssd_chunked(*args, 16)       # 40 = 2 * 16 + 8
    _, even = layers._ssd_chunked(*args, 8)          # 40 = 5 * 8
    assert rel(ragged, even) <= F32_BAR


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunked_grad_matches_jax(groups):
    """The gradient of <y, w> + <final, u> with respect to every input
    (and the initial state) against ``jax.grad``, over a ragged 45."""
    xh, dt, a, bm, cm, st = _ssd_inputs(2, 45, 4, 8, groups, 6, seed=5)
    rng = np.random.default_rng(6)
    w = rng.standard_normal(xh.shape).astype(np.float32)
    u = rng.standard_normal(st.shape).astype(np.float32)

    def jf(*args):
        y, f = jax_layers._ssd_chunked(*args[:5], 16, init_state=args[5])
        return jnp.sum(y * w) + jnp.sum(f * u)
    inputs = (xh, dt, a, bm, cm, st)
    want = jax.jit(jax.grad(jf, argnums=tuple(range(6))))(
        *(jnp.asarray(x) for x in inputs))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    y, f = layers._ssd_chunked(*ts[:5], 16, init_state=ts[5])
    ((y * torch.from_numpy(w)).sum() + (f * torch.from_numpy(u)).sum()
     ).backward()
    for name, t, g in zip(("x", "dt", "a", "B", "C", "init"), ts, want):
        assert torch.isfinite(t.grad).all(), name
        assert rel(t.grad, g) <= F32_BAR, (name, rel(t.grad, g))


def _ssm_layer(dtype, seed=0, **over):
    jcfg, jp, cfg, tp = models("mamba2-2.7b", dtype, **over)
    return jcfg, jp["blocks"], cfg, tp["blocks"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_ssm_prefill_and_decode_match_jax(dtype):
    """``apply_ssm`` over a ragged 45-token prompt (chunks of 32) from a
    nonzero SSM state, then three decode steps from its conv window and
    state, each output and state against the JAX package's."""
    jcfg, jstack, cfg, tstack = _ssm_layer(dtype)
    jp = jax.tree.map(lambda a: a[1], jstack["ssm"])
    tp = tstack[1]["ssm"]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    s = cfg.ssm
    h = s.expand * cfg.d_model // s.head_dim
    st0 = 0.1 * rng.standard_normal((2, h, s.head_dim, s.state_dim)
                                    ).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    bar = F32_BAR if dtype == "float32" else BF16_BAR
    want, (wconv, wst) = jit(jax_layers.apply_ssm, cfg=jcfg)(
        jp, jx[:, :45], ssm_state=jnp.asarray(st0))
    step = jit(jax_layers.apply_ssm, cfg=jcfg, decode=True)
    got, (conv, st) = layers.apply_ssm(tp, tx[:, :45], cfg,
                                       ssm_state=torch.from_numpy(st0))
    assert got.dtype == tx.dtype and conv.dtype == tx.dtype
    assert st.dtype == torch.float32
    for g, w in ((got, want), (conv, wconv), (st, wst)):
        assert rel(g, w) <= bar
    for i in range(45, 48):
        want, (wconv, wst) = step(jp, jx[:, i:i + 1], conv_state=wconv,
                                  ssm_state=wst)
        got, (conv, st) = layers.apply_ssm(
            tp, tx[:, i:i + 1], cfg, conv_state=conv, ssm_state=st,
            decode=True)
        for g, w in ((got, want), (conv, wconv), (st, wst)):
            assert rel(g, w) <= bar


@pytest.mark.parametrize("groups", [1, 2])
def test_decode_after_prefill_equals_one_longer_prefill(groups):
    """A prefill of 37 tokens then 4 decode steps give the outputs and
    states of one prefill over the 41 tokens (its last 4 positions)."""
    _, _, cfg, tstack = _ssm_layer("float32",
                                   ssm=dataclasses.replace(
                                       get_arch("mamba2-2.7b").ssm,
                                       state_dim=16, head_dim=32, chunk=32,
                                       n_groups=groups))
    tp = tstack[0]["ssm"]
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 41, cfg.d_model)).astype(np.float32))
    whole, (wconv, wst) = layers.apply_ssm(tp, x, cfg)
    outs, (conv, st) = layers.apply_ssm(tp, x[:, :37], cfg)
    outs = [outs]
    for i in range(37, 41):
        o, (conv, st) = layers.apply_ssm(tp, x[:, i:i + 1], cfg,
                                         conv_state=conv, ssm_state=st,
                                         decode=True)
        outs.append(o)
    assert rel(torch.cat(outs, 1), whole) <= F32_BAR
    assert rel(conv, wconv) <= F32_BAR and rel(st, wst) <= F32_BAR


@pytest.mark.parametrize("d_ff", [0, 384])
def test_ssm_block_matches_jax(d_ff):
    """``ssm_block`` (norm, SSD, residual; the MLP only where d_ff is
    nonzero) in train mode and in prefill with a cache, written in
    place."""
    jcfg, jstack, cfg, tstack = _ssm_layer("float32", d_ff=d_ff)
    assert ("mlp" in tstack[0]) == bool(d_ff)
    jp = jax.tree.map(lambda a: a[0], jstack)
    x = np.random.default_rng(9).standard_normal((2, 24, cfg.d_model)
                                                 ).astype(np.float32)
    block = jit(jax_blocks.ssm_block, cfg=jcfg, layer_idx=0)
    want, _ = block(jp, jnp.asarray(x))
    got, nc = blocks.ssm_block(tstack[0], torch.from_numpy(x), cfg,
                               layer_idx=0)
    assert nc is None and rel(got, want) <= F32_BAR
    jc = jax.tree.map(lambda a: a[0], jm.init_cache(jcfg, 2, 0)["blocks"])
    tc = {k: v[0] for k, v in
          tm.init_cache(cfg, 2, 0, device="cpu")["blocks"].items()}
    want, wc = block(jp, jnp.asarray(x), cache=jc)
    got, nc = blocks.ssm_block(tstack[0], torch.from_numpy(x), cfg,
                               layer_idx=0, cache=tc)
    assert rel(got, want) <= F32_BAR
    for k in ("conv", "ssm"):
        assert nc[k] is tc[k] and rel(tc[k], wc[k]) <= F32_BAR


def test_init_ssm_leaves():
    """The SSD layer's parameters: the in-projection emits [z, x, B, C,
    dt]; ``a_log`` = log(1..H), ``d_skip`` ones and ``dt_bias`` zeros in
    fp32 in a bf16 model; ``w_out`` scaled by 1/sqrt(2 L)."""
    cfg = dataclasses.replace(reduced_arch("mamba2-2.7b"), num_layers=8)
    p = tm.init_params(cfg, 0, device="cpu")["blocks"][0]["ssm"]
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    h = d_in // s.head_dim
    assert p["w_in"].shape == (cfg.d_model, 2 * d_in + 2 * s.n_groups
                               * s.state_dim + h)
    assert p["conv_w"].shape == (s.conv_width, d_in + 2 * s.state_dim)
    for k in ("a_log", "d_skip", "dt_bias"):
        assert p[k].dtype == torch.float32 and p[k].shape == (h,)
    for k in ("w_in", "conv_w", "conv_b", "norm", "w_out"):
        assert p[k].dtype == torch.bfloat16
    torch.testing.assert_close(p["a_log"], torch.log(torch.arange(1., h + 1)))
    assert torch.equal(p["d_skip"], torch.ones(h))
    assert not p["dt_bias"].any() and not p["conv_b"].any()
    assert 0.6 < float(p["w_out"].float().std()) / (0.02 / 4) < 1.4
    assert 0.6 < float(p["w_in"].float().std()) / 0.02 < 1.4


# ---------------------------------------------------------------------------
# Mamba2 as a whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_forward_and_caches_match_jax(dtype):
    """Reduced Mamba2 (4 SSM layers, each with the reduced config's MLP):
    train mode over 70 tokens
    (ragged to the chunk of 32), a prefill of 37 and three decode
    steps, the logits and the caches leaf by leaf."""
    jcfg, jp, cfg, tp = models("mamba2-2.7b", dtype)
    bar = F32_BAR if dtype == "float32" else BF16_BAR
    toks = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, 70))
    jl, _, jh = jit(jm.forward, jcfg, mode="train")(jp, jnp.asarray(toks))
    tl, aux, th = tm.forward(cfg, tp, torch.from_numpy(toks), mode="train")
    assert float(aux) == 0.0
    assert rel(tl, jl) <= bar and rel(th, jh) <= bar
    jc, tc = jm.init_cache(jcfg, 2, 64), tm.init_cache(cfg, 2, 64,
                                                       device="cpu")
    assert set(tc["blocks"]) == {"conv", "ssm"}
    assert tc["blocks"]["ssm"].dtype == torch.float32
    assert tc["blocks"]["conv"].dtype == getattr(torch, dtype)
    jl, jc = jit(jm.prefill, jcfg)(jp, jnp.asarray(toks[:, :37]), jc)
    step = jit(jm.decode_step, jcfg)
    tl, tc = tm.prefill(cfg, tp, torch.from_numpy(toks[:, :37]), tc)
    assert rel(tl, jl) <= bar and int(tc["index"]) == 37
    for i in range(37, 40):
        jl, jc = step(jp, jnp.asarray(toks[:, i:i + 1]), jc)
        tl, tc = tm.decode_step(cfg, tp, torch.from_numpy(toks[:, i:i + 1]),
                                tc)
        assert rel(tl, jl) <= bar
    assert int(tc["index"]) == 40
    for k in ("conv", "ssm"):
        assert tuple(tc["blocks"][k].shape) == jc["blocks"][k].shape
        assert rel(tc["blocks"][k], jc["blocks"][k]) <= bar, k


def test_mamba2_loss_and_grads_match_jax():
    """``loss_fn`` (CE with z-loss, no MoE term) and the gradient of every
    parameter, the fp32 leaves of the SSD among them, at 2 layers over
    40 tokens, under ``remat="full"``."""
    jcfg, jp, cfg, tp = models("mamba2-2.7b", num_layers=2)
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 41))
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    loss_grads_match(jcfg, jp, cfg, tp,
                     {k: jnp.asarray(v) for k, v in batch.items()}, batch)


def test_mamba2_remat_changes_no_number():
    _, _, cfg, tp = models("mamba2-2.7b", num_layers=2)
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size, (1, 41))
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    grads = []
    for remat in ("full", "dots", "none"):
        params = tmap(lambda t: t.detach().clone().requires_grad_(True), tp)
        loss, _ = tm.loss_fn(dataclasses.replace(cfg, remat=remat), params,
                             batch)
        loss.backward()
        grads.append(params["blocks"][0]["ssm"]["w_in"].grad)
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[0],
                                                           grads[2])


def test_mamba2_tree_and_counts():
    """The full-width tree: 64 layers of [ln, ssm] and no attention; 2.83e9
    parameters, the JAX tree's count (the config's own count, which
    leaves out the norms, the conv and the per-head vectors, within 1 %),
    and
    ``params_from_jax`` maps every leaf of the JAX tree, the fp32 ones of
    a bf16 model as fp32."""
    full = get_arch("mamba2-2.7b")
    spec = param_spec(full)
    assert set(spec) == {"embed", "ln_f", "unembed", "blocks"}
    assert len(spec["blocks"]) == 64 and set(spec["blocks"][0]) == {
        "ln", "ssm"}
    shapes = [s for _, s in flat(spec)]
    total = sum(int(np.prod(s)) for s in shapes)
    assert round(total / 1e9, 2) == 2.83
    assert abs(total - full.param_count()) / total < 0.01
    jshapes = jax.eval_shape(lambda k: jm.init_params(jax_get_arch(
        "mamba2-2.7b"), k), jax.random.PRNGKey(0))
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jshapes)) \
        == total
    _, jp, cfg, tp = models("mamba2-2.7b")
    assert param_count(tp) == sum(x.size for x in jax.tree.leaves(jp))
    assert tmap(lambda t: tuple(t.shape), tp) == param_spec(cfg)
    # a bf16 model's fp32 leaves come over as fp32, bit for bit
    _, jp, _, tp = models("mamba2-2.7b", "bfloat16")
    for li in (0, 3):
        ssm = tp["blocks"][li]["ssm"]
        for k in ("a_log", "d_skip", "dt_bias"):
            assert ssm[k].dtype == torch.float32
            np.testing.assert_array_equal(
                ssm[k].numpy(), np.asarray(jp["blocks"]["ssm"][k][li]))
        assert ssm["w_in"].dtype == torch.bfloat16
