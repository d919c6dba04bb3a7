"""The port's moe family as whole models against the JAX package, on the
CPU: reduced Arctic (2 layers of GQA attention + 8 experts top-2 + the
dense residual) and reduced DeepSeek-V3 (1 dense and 1 MoE layer of MLA,
8 experts top-2, 1 shared, the aux-free router bias, the MTP head).

The JAX package's parameter tree (its layout from ``jax.eval_shape`` of
``init_params``, numbers drawn with numpy from a seed, so no init is
compiled) goes through ``params_from_jax``; the same tokens go through
both packages' ``forward`` in train, prefill and decode mode.  The JAX
reference decodes each row of the batch on its own (``vmap`` of
``decode_step`` over B = 1 caches, as its serving engine does): the
port's decode routes each row through the MoE on its own likewise.

Tolerances: fp32 1e-4 of max|logits|; bf16 0.1 of max|logits|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro.configs.registry import get_arch as jax_get_arch
from repro.configs.registry import reduced_arch as jax_reduced_arch
import repro_torch.models as tm
from repro_torch.configs.registry import get_arch, reduced_arch
from repro_torch.models import layers
from repro_torch.models.convert import params_from_jax, train_state_from_jax
from repro_torch.models.model import param_count, param_spec

ARCHS = ("arctic-480b", "deepseek-v3-671b")
F32_BAR, BF16_BAR = 1e-4, 1e-1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def jax_params(jcfg, seed=0):
    """The JAX tree's layout with numpy draws at its leaves: weights
    normal * 0.02, norm scales 1 + noise, the router bias small noise (so
    that it moves the selection)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(s.shape).astype(np.float32)
        if "scale" in name or "_norm'" in name:
            x = 1.0 + 0.1 * x
        elif "router_bias" in name:
            x = 0.01 * x
        else:
            x = 0.02 * x
        return jnp.asarray(x, s.dtype)
    shapes = jax.eval_shape(lambda k: jm.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def models(arch, dtype="float32", **over):
    kw = dict(dtype=dtype, num_layers=2, **over)
    jcfg, cfg = jax_reduced_arch(arch, **kw), reduced_arch(arch, **kw)
    jp = jax_params(jcfg)
    return jcfg, jp, cfg, params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                          device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def fp32(request):
    return models(request.param)


def _stack_rows(jc):
    """A (L, B, ...) JAX cache as B stacked B = 1 caches, the JAX serving
    engine's layout, and back."""
    b = jc["index"].shape[0] if jc["index"].ndim else \
        jax.tree.leaves({k: v for k, v in jc.items() if k != "index"})[0] \
        .shape[1]
    rows = {k: jax.tree.map(lambda a: jnp.moveaxis(a, 1, 0)[:, :, None], v)
            for k, v in jc.items() if k != "index"}
    rows["index"] = jnp.broadcast_to(jc["index"], (b,))
    return rows


def _unstack_rows(rows):
    out = {k: jax.tree.map(lambda a: jnp.moveaxis(a[:, :, 0], 0, 1), v)
           for k, v in rows.items() if k != "index"}
    out["index"] = rows["index"]
    return out


def jax_decode_rows(jcfg, jp):
    """The JAX package's decode step, each row on its own: a function of
    (tokens (B, 1), a (L, B, ...) cache) -> (logits (B, V), cache)."""
    step = jax.jit(jax.vmap(lambda t, c: jm.decode_step(jcfg, jp, t, c)))

    def run(toks, jc):
        logits, rows = step(jnp.asarray(toks)[:, None], _stack_rows(jc))
        return logits[:, 0], _unstack_rows(rows)
    return run


def test_forward_train_prefill_decode_match_jax(fp32):
    """Train mode over 80 tokens (past ``attn_chunk_q``: the chunked
    branch), with the MoE term and the final hidden state; a prefill of
    32 into a 48-slot cache (DeepSeek: the absorbed branch) and three
    decode steps, and the caches."""
    jcfg, jp, cfg, tp = fp32
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 80))
    jl, jaux, jh = jax.jit(lambda p, t: jm.forward(jcfg, p, t))(
        jp, jnp.asarray(toks))
    tl, aux, h = tm.forward(cfg, tp, torch.from_numpy(toks), mode="train")
    assert _rel(tl.numpy(), jl) <= F32_BAR
    assert _rel(h.numpy(), jh) <= F32_BAR
    assert float(aux) > 0 and abs(float(aux) - float(jaux)) <= \
        1e-5 * float(jaux)

    s = 32
    jl, jc = jax.jit(lambda p, t, c: jm.forward(
        jcfg, p, t, cache=c, mode="prefill"))(
            jp, jnp.asarray(toks[:, :s]), jm.init_cache(jcfg, 2, 48))
    tc = tm.init_cache(cfg, 2, 48, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), jm.init_cache(jcfg, 2, 48)) \
        == jax.tree.map(lambda a: tuple(a.shape), tc)
    tl, tc = tm.forward(cfg, tp, torch.from_numpy(toks[:, :s]), cache=tc,
                        mode="prefill")
    assert _rel(tl.numpy(), jl) <= F32_BAR
    decode = jax_decode_rows(jcfg, jp)
    for i in range(3):
        step = toks[:, s + i:s + i + 1]
        jl, jc = decode(step, jc)
        tl, tc = tm.decode_step(cfg, tp, torch.from_numpy(step), tc)
        assert _rel(tl.numpy(), jl) <= F32_BAR
    assert tc["index"].tolist() == s + 3
    for key in tc:
        if key != "index":
            for name, t in tc[key].items():
                assert _rel(t.numpy(), jc[key][name]) <= F32_BAR, (key, name)


def _record_routes(monkeypatch):
    """Each package's top-k expert ids, layer by layer: the port's from
    ``moe_route``, the JAX package's through a host callback on what its
    dispatch hands ``moe_load_aux`` (inside jit and scan)."""
    from repro.models import layers as jax_layers
    port, ref = [], []
    route, load_aux = layers.moe_route, jax_layers.moe_load_aux

    def port_route(p, xt, cfg):
        out = route(p, xt, cfg)
        port.append(out[1].reshape(-1, out[1].shape[-1]).sort(-1).values)
        return out

    def ref_aux(probs, top_idx, e):
        jax.debug.callback(lambda t: ref.append(np.sort(np.asarray(t), -1)),
                           top_idx, ordered=True)
        return load_aux(probs, top_idx, e)
    monkeypatch.setattr(layers, "moe_route", port_route)
    monkeypatch.setattr(jax_layers, "moe_load_aux", ref_aux)
    return port, ref


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bf16_matches_jax(arch, monkeypatch):
    """bf16 weights and activations, train mode over 40 tokens, each
    token's experts kept (capacity = tokens): a bf16 rounding that
    differs can flip a token's top-k, and then that token alone moves by
    an expert's output.  At most two of the 80 tokens may differ in
    their top-k; every other token is held at the bf16 bar."""
    moe = dataclasses.replace(
        reduced_arch(arch).moe, capacity_factor=4.0)   # E / k: dropless
    jcfg, jp, cfg, tp = models(arch, "bfloat16", moe=moe)
    port, ref = _record_routes(monkeypatch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))
    jl, jaux, _ = jax.jit(lambda p, t: jm.forward(jcfg, p, t))(
        jp, jnp.asarray(toks))
    jax.effects_barrier()
    tl, aux, _ = tm.forward(cfg, tp, torch.from_numpy(toks), mode="train")
    assert tl.dtype == torch.bfloat16
    assert len(port) == len(ref) == cfg.num_layers - (
        cfg.moe.first_dense_layers if cfg.mla else 0)
    flipped = np.zeros(80, bool)
    for p_, r_ in zip(port, ref):
        flipped |= (p_.numpy() != r_).any(-1)
    assert flipped.sum() <= 2, np.flatnonzero(flipped)
    keep = ~flipped.reshape(2, 40)
    got, want = tl.float().numpy()[keep], np.asarray(jl, np.float32)[keep]
    assert np.abs(got - want).max() <= BF16_BAR * np.abs(want).max()
    assert abs(float(aux) - float(jaux)) <= BF16_BAR * float(jaux)


def test_arctic_flash_prefill_matches_the_reference():
    """Arctic's serving path: the flash kernel (on the CPU its plain
    version) in every layer's prefill, against the JAX package's "xla"
    attention on the same cache."""
    jcfg, jp, cfg, tp = models("arctic-480b")
    fcfg = dataclasses.replace(cfg, attn_impl="flash")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 40))
    jl, _ = jax.jit(lambda p, t, c: jm.forward(
        jcfg, p, t, cache=c, mode="prefill"))(
            jp, jnp.asarray(toks), jm.init_cache(jcfg, 1, 64))
    tl, _ = tm.forward(fcfg, tp, torch.from_numpy(toks),
                       cache=tm.init_cache(fcfg, 1, 64, device="cpu"),
                       mode="prefill")
    assert _rel(tl.numpy(), jl) <= F32_BAR


def test_params_from_jax_maps_every_leaf(fp32):
    jcfg, jp, cfg, tp = fp32
    assert param_count(tp) == sum(x.size for x in jax.tree.leaves(jp))
    assert jax.tree.map(lambda t: tuple(t.shape), tp) == param_spec(cfg)
    tree = jax.tree.map(np.asarray, jp)
    stacks = [k for k, v in tp.items() if isinstance(v, list)]
    assert stacks == (["mla_dense", "mla_moe"] if cfg.mla else ["blocks"])
    for key in stacks:
        moe = tp[key][-1].get("moe")
        if moe is None:
            continue
        # the expert weights stay one (E, d, f) tensor a layer
        assert tuple(moe["w_gate"].shape) == (
            cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert)
        assert moe["router"].dtype == torch.float32
        np.testing.assert_array_equal(moe["w_up"].numpy(),
                                      tree[key]["moe"]["w_up"][-1])
    if cfg.mtp:
        np.testing.assert_array_equal(tp["mtp"]["proj"].numpy(),
                                      tree["mtp"]["proj"])
        stray = dict(tree, mtp=dict(tree["mtp"], extra=np.zeros(2)))
        with pytest.raises(ValueError, match="mtp/extra"):
            params_from_jax(cfg, stray, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=4)), tree, device="cpu")


def test_train_state_from_jax_carries_adamw_moments(fp32):
    jcfg, jp, cfg, tp = fp32
    tree = jax.tree.map(np.asarray, jp)
    state = {"step": np.int32(3), "params": tree,
             "opt_state": {"m": tree, "v": jax.tree.map(np.abs, tree)}}
    out = train_state_from_jax(cfg, state, device="cpu")
    assert int(out["step"]) == 3
    for key in ("m", "v"):
        assert jax.tree.map(lambda t: tuple(t.shape),
                            out["opt_state"][key]) == param_spec(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_matches_jax_at_full_width(arch):
    """The full configs' parameter trees, from shapes alone: the JAX
    package's ``init_params`` layout (``jax.eval_shape``, nothing
    allocated), its stacks as the port's per-layer lists; Arctic 4.8e11
    parameters, DeepSeek-V3 6.7e11 with its MTP head."""
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    want = jax.eval_shape(lambda k: jm.init_params(jcfg, k),
                          jax.random.PRNGKey(0))
    spec = param_spec(cfg)

    def stacked(x):
        if isinstance(x, list):
            return jax.tree.map(lambda s: (len(x), *s), x[0],
                                is_leaf=lambda s: isinstance(s, tuple))
        if isinstance(x, dict):
            return {k: stacked(v) for k, v in x.items()}
        return x
    assert stacked(spec) == jax.tree.map(lambda s: tuple(s.shape), want)
    n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(want))
    assert round(n / 1e11, 1) == {"arctic-480b": 4.8,
                                  "deepseek-v3-671b": 6.7}[arch]


def test_init_draws_large_leaves_in_slices(monkeypatch):
    """A leaf past ``Init.SLICE_ELEMENTS`` is drawn a slice of its leading
    axis at a time (the same numbers as drawing each slice alone); the
    smaller leaves are drawn whole, as before."""
    mk = layers.Init(torch.Generator().manual_seed(0), "cpu", torch.bfloat16)
    whole = mk.normal((3, 8, 16), 0.5)
    monkeypatch.setattr(layers.Init, "SLICE_ELEMENTS", 200)
    mk = layers.Init(torch.Generator().manual_seed(0), "cpu", torch.bfloat16)
    sliced = mk.normal((3, 8, 16), 0.5)
    gen = torch.Generator().manual_seed(0)
    want = torch.stack([(torch.randn((8, 16), generator=gen) * 0.5)
                        .bfloat16() for _ in range(3)])
    assert sliced.dtype == torch.bfloat16 and torch.equal(sliced, want)
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(whole, (torch.randn((3, 8, 16), generator=gen) * 0.5)
                       .bfloat16())
    router = mk.normal((300, 2), 0.02, dtype=torch.float32)
    assert router.dtype == torch.float32


def test_init_params_of_the_moe_archs():
    """The port's own random weights: the JAX package's tree, the router
    and its bias in fp32, every other leaf in the config's dtype."""
    for arch in ARCHS:
        cfg = reduced_arch(arch, num_layers=2)
        p = tm.init_params(cfg, 0, device="cpu")
        assert jax.tree.map(lambda t: tuple(t.shape), p) == param_spec(cfg)
        stack = p["mla_moe" if cfg.mla else "blocks"][-1]["moe"]
        assert stack["router"].dtype == torch.float32
        assert stack["w_down"].dtype == torch.bfloat16
        assert ("router_bias" in stack) == cfg.moe.router_aux_free_bias
