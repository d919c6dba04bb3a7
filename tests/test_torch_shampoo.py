"""The port's Shampoo on a model against the JAX package's, on the CPU:
the JAX suite's tiny trainer config (tests/test_trainer.py: 2 layers,
d 64, vocab 128) in fp32, the JAX train state carried over
(``models.convert.train_state_from_jax``) and both packages stepping on
from it.

Statistics within 1e-5 of max|stat| while the parameters agree.  The
inverse 4th roots are where the two packages part: ``eigh`` in fp32 of a
statistic with eigenvalues near ``matrix_eps`` (any rank-deficient
block: the tiny model's stacked per-layer vectors are 2 rows) is
ill-conditioned, and each package's root differs from a float64 root by
up to ~0.2 of max|root| there (``tests/test_torch_optim.py``).  So the
steps across a ``precond_interval`` boundary are held tight (parameters
<= 1e-4 of max|p|, roots <= 1e-3) at ``matrix_eps=1e-2``, where the
clamp makes the roots well defined, and at the default 1e-6 within 0.1
of max|p| (measured 0.044 after the boundary step, 0.054 one step
later).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro.configs.registry import reduced_arch as jax_reduced_arch
from repro.data import pipeline as jpipe
from repro.runtime.trainer import make_train_step as jax_make_train_step
from repro_torch.configs.registry import reduced_arch
from repro_torch.data import pipeline as tpipe
from repro_torch.models.convert import train_state_from_jax
from repro_torch.optim.tree import layer_groups, leaves
from repro_torch.runtime.trainer import make_train_step

# the packages export the functions under their modules' names
jsched, jshampoo_mod = (importlib.import_module(f"repro.optim.{m}")
                        for m in ("schedules", "shampoo"))
tsched, tshampoo_mod = (importlib.import_module(f"repro_torch.optim.{m}")
                        for m in ("schedules", "shampoo"))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------

TINY = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, d_ff=128,
            vocab_size=128, head_dim=32, dtype="float32")
DATA = dict(vocab_size=128, seq_len=96, global_batch=4, seed=0)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_reduced_arch("qwen2.5-3b", **TINY)
    cfg = reduced_arch("qwen2.5-3b", **TINY)
    params = jm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, params


def _shampoo_run(tiny, *, steps_before=2, steps_after=3, **opt_kw):
    """The JAX step runs ``steps_before`` steps; its state comes over to
    the port; both run ``steps_after`` more (a ``precond_interval`` of 3
    puts step 3 in between).  Yields the step, both states and losses."""
    jcfg, cfg, params = tiny
    jopt = jshampoo_mod.shampoo(jsched.warmup_cosine(3e-3, 2, 20), **opt_kw)
    topt = tshampoo_mod.shampoo(tsched.warmup_cosine(3e-3, 2, 20), **opt_kw)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt))
    tstep = make_train_step(cfg, topt)
    js = {"step": jnp.zeros((), jnp.int32), "params": params,
          "opt_state": jopt.init(params)}
    dc, tdc = jpipe.DataConfig(**DATA), tpipe.DataConfig(**DATA)
    for s in range(steps_before):
        js, _ = jstep(js, jpipe.get_batch(dc, s))
    ts = train_state_from_jax(cfg, jax.tree.map(np.asarray, js),
                              device="cpu")
    for s in range(steps_before, steps_before + steps_after):
        js, jmet = jstep(js, jpipe.get_batch(dc, s))
        ts, tmet = tstep(ts, tpipe.get_batch(tdc, s))
        conv = train_state_from_jax(cfg, jax.tree.map(np.asarray, js),
                                    device="cpu")
        yield s, ts, conv, float(tmet["loss"]), float(jmet["loss"])


# The key bias's gradient is zero in exact arithmetic (it shifts every
# score of a query by the same amount, which the softmax cancels), so its
# Adam update is driven by rounding: it is held within 1e-3 of its max
# (measured 6.5e-5 after one step), every other leaf within the test's bar.
ROUNDING_DRIVEN = {("blocks", "attn", "bk"): 1e-3}


def _check_params(ts, conv, bar, step):
    for (path, got), (_, want) in zip(layer_groups(ts["params"]),
                                      layer_groups(conv["params"])):
        got = got if isinstance(got, list) else [got]
        want = want if isinstance(want, list) else [want]
        for a, b in zip(got, want):
            assert _rel(a, b) <= max(bar, ROUNDING_DRIVEN.get(path, 0)), \
                (path, step)


def test_shampoo_state_layout_converts_one_to_one(tiny):
    """The port's ``init`` holds the JAX package's stacked layout: every
    statistic's path and shape, the layers' blocks in one stack a path."""
    jcfg, cfg, params = tiny
    jst = jshampoo_mod.shampoo(1e-3, block_size=32).init(params)
    conv = train_state_from_jax(
        cfg, {"step": np.int32(0), "params": jax.tree.map(np.asarray, params),
              "opt_state": jax.tree.map(np.asarray, jst)}, device="cpu")
    tst = tshampoo_mod.shampoo(1e-3, block_size=32).init(conv["params"])
    assert jax.tree.map(lambda t: tuple(t.shape), tst) == jax.tree.map(
        lambda t: tuple(t.shape), conv["opt_state"])
    for a, b in zip(leaves(tst["gram"]), leaves(conv["opt_state"]["gram"])):
        assert torch.equal(a, b)
    # a layer's wq (64 x 64) in blocks of 32: 2 layers x 2 x 2 blocks
    assert tuple(tst["gram"]["blocks"]["attn"]["wq"]["l"].shape) == \
        (8, 32, 32)


def test_shampoo_across_precond_boundary_matches_jax(tiny):
    """``matrix_eps`` 1e-2, blocks of 32, ``precond_interval`` 3, from
    the JAX state after 2 steps: steps 2, 3 (new roots) and 4.  The
    parameters within 1e-4 of max|p| (measured 1.8e-5 at step 4), the
    statistics within 1e-4 (1.6e-5: step 4's gradients are taken at
    parameters that differ by the roots' gap), the roots within 1e-3
    (1.4e-4)."""
    for s, ts, conv, tl, jl in _shampoo_run(
            tiny, block_size=32, precond_interval=3, matrix_eps=1e-2):
        assert abs(tl - jl) <= 1e-5 * abs(jl)
        _check_params(ts, conv, 1e-4, s)
        for path, _ in layer_groups(ts["params"]):
            node = ts["opt_state"]["gram"]
            want = conv["opt_state"]["gram"]
            for key in path:
                node, want = node[key], want[key]
            for key, bar in (("l", 1e-4), ("r", 1e-4), ("pl", 1e-3),
                             ("pr", 1e-3)):
                if want[key].numel():
                    assert _rel(node[key], want[key]) <= bar, (path, key, s)


def test_shampoo_default_eps_within_the_fp32_root_gap(tiny):
    """The trainer's default ``matrix_eps`` (1e-6): the parameters
    within 1e-5 of max|p| before the boundary and within 0.1 after it
    (the roots' fp32 gap, module docstring); the statistics within 1e-5
    of max|stat| up to the boundary step (later steps' gradients are
    taken at parameters that differ by that gap)."""
    for s, ts, conv, tl, jl in _shampoo_run(tiny, block_size=32,
                                            precond_interval=3):
        _check_params(ts, conv, 1e-5 if s < 3 else 0.1, s)
        if s > 3:
            continue
        for key in ("l", "r"):
            for path, _ in layer_groups(ts["params"]):
                node = ts["opt_state"]["gram"]
                want = conv["opt_state"]["gram"]
                for k in path:
                    node, want = node[k], want[k]
                if want[key].numel():
                    assert _rel(node[key], want[key]) <= 1e-5, (path, s)


def test_shampoo_fallbacks_to_adam_match_jax(tiny):
    """``max_blocks`` 1 with blocks of 32: every leaf wider than 32 falls
    back to Adam (the embed, the projections), as do the 1-D ones;
    statistics only for the rest.  Two steps within 1e-5 of max|p|."""
    jcfg, cfg, params = tiny
    jst = jshampoo_mod.shampoo(1e-3, block_size=32, max_blocks=1).init(
        params)
    planned = [k for k, v in jax.tree_util.tree_leaves_with_path(jst["gram"])
               if v.size]
    assert planned == []                   # every leaf is Adam
    for s, ts, conv, tl, jl in _shampoo_run(tiny, steps_before=1,
                                            steps_after=2, block_size=32,
                                            max_blocks=1):
        _check_params(ts, conv, 1e-5, s)


def test_shampoo_one_gram_launch_a_path_and_side(tiny, monkeypatch):
    """A statistics step calls the batched Gram twice for each
    preconditioned path (L and R over all its layers' blocks at once),
    never once a layer; a step off ``stat_interval`` calls it never."""
    jcfg, cfg, params = tiny
    conv = train_state_from_jax(
        cfg, {"step": np.int32(0), "params": jax.tree.map(np.asarray, params),
              "opt_state": {"m": jax.tree.map(np.asarray, params),
                            "v": jax.tree.map(np.asarray, params)}},
        device="cpu")
    calls = []
    real = tshampoo_mod.batched_gram

    def counting(blocks, **kw):
        calls.append(tuple(blocks.shape))
        return real(blocks, **kw)
    monkeypatch.setattr(tshampoo_mod, "batched_gram", counting)
    opt = tshampoo_mod.shampoo(1e-3, block_size=32, stat_interval=2)
    st = opt.init(conv["params"])
    planned = [p for p, g in layer_groups(conv["params"])
               if tshampoo_mod._plan(tshampoo_mod._stacked_shape(g), 32, 64)]
    grads = jax.tree.map(torch.ones_like, conv["params"])
    opt.update(grads, st, conv["params"], 0)
    assert len(calls) == 2 * len(planned)
    wq = planned.index(("blocks", "attn", "wq"))
    assert calls[2 * wq] == (8, 32, 32)     # 2 layers x 2 x 2 blocks
    calls.clear()
    opt.update(grads, st, conv["params"], 1)
    assert calls == []


@pytest.mark.parametrize("variant", ["classical", "winograd"])
def test_shampoo_statistics_strassen_equal_classical(tiny, variant):
    """The statistics through the Strassen recursion (``ata_levels``
    1, leaf 8) equal the classical and Winograd variants' within 1e-5 of
    max|stat|, and the fused path's plain version (``ata_mode="fused"``
    on the CPU) within the same."""
    _, cfg, params = tiny
    p = train_state_from_jax(
        cfg, {"step": np.int32(0), "params": jax.tree.map(np.asarray, params),
              "opt_state": {"m": jax.tree.map(np.asarray, params),
                            "v": jax.tree.map(np.asarray, params)}},
        device="cpu")["params"]
    g = jax.tree.map(lambda t: torch.randn(
        t.shape, generator=torch.Generator().manual_seed(t.numel())), p)
    states = {}
    for name, kw in (("strassen", {}), (variant, {"ata_variant": variant}),
                     ("fused", {"ata_mode": "fused", "ata_block": 16})):
        opt = tshampoo_mod.shampoo(1e-3, block_size=32, ata_leaf=8, **kw)
        st = opt.init(p)
        opt.update(g, st, p, 0)
        states[name] = st["gram"]
    for name in (variant, "fused"):
        for a, b in zip(leaves(states[name]), leaves(states["strassen"])):
            if b.numel():
                assert _rel(a, b) <= 1e-5, name
