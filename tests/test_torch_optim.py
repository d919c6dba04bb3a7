"""The port's optimizers and data pipeline against the JAX package's, on
the CPU.

- ``get_batch``: bit for bit (the same numpy Philox streams).
- Schedules and AdamW's bias corrections: fp32, as ``jnp`` computes
  them; the cosine schedule within one fp32 ulp of the peak lr
  (``torch.cos`` against XLA's), the rest bit for bit.
- AdamW on a tree of fp32 leaves: one and several steps within 1e-5 of
  max|p| (clipping and moments summed in another order).
- Shampoo's pieces: blocks and plans exactly; the inverse 4th root
  within 1e-5 of JAX's and of float64 where the statistic is full rank,
  and no farther from float64 than JAX's own where it is not
  (``tests/test_torch_shampoo.py`` holds Shampoo on a model).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe
from repro_torch.optim.tree import leaves

# the packages export the functions under their modules' names
jadamw_mod, jsched, jshampoo_mod = (
    importlib.import_module(f"repro.optim.{m}")
    for m in ("adamw", "schedules", "shampoo"))
tadamw_mod, tsched, tshampoo_mod = (
    importlib.import_module(f"repro_torch.optim.{m}")
    for m in ("adamw", "schedules", "shampoo"))


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
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(kind="markov"), dict(kind="uniform"),
                                dict(kind="markov", enc_seq=5, enc_dim=7,
                                     noise=0.3, seed=3)])
def test_get_batch_is_bit_identical(kw):
    args = dict(vocab_size=97, seq_len=33, global_batch=4, **kw)
    for step in (0, 1, 17):
        want = jpipe.get_batch(jpipe.DataConfig(**args), step)
        got = tpipe.get_batch(tpipe.DataConfig(**args), step)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    stream = tpipe.SyntheticStream(tpipe.DataConfig(**args), start_step=5)
    np.testing.assert_array_equal(
        next(stream)["inputs"],
        jpipe.get_batch(jpipe.DataConfig(**args), 5)["inputs"])
    assert stream.state == 6 and stream.restore(2).step == 2


# ---------------------------------------------------------------------------
# Schedules, bias corrections
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,args,of_lr", [
    ("warmup_cosine", (3e-4, 100, 1000), 2 ** -23),
    ("warmup_cosine", (3e-3, 5, 40), 2 ** -23),
    ("warmup_linear", (3e-4, 100, 1000, 1e-5), 0),
    ("constant", (3e-4,), 0)])
def test_schedules_match_jax(name, args, of_lr):
    """Bit for bit, but the cosine: within one fp32 ulp of the peak lr
    (``torch.cos`` and XLA's cos differ by an ulp; measured 0.81 of that
    bar)."""
    jf, tf = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    for step in range(0, 1200, 7):
        want = np.float32(jf(jnp.int32(step)))
        got = tf(step)
        assert got.dtype == torch.float32 and got.ndim == 0
        assert abs(float(got) - float(want)) <= of_lr * args[0], \
            (step, float(got), float(want))


def test_bias_corrections_match_jnp_bit_for_bit():
    for step in range(0, 2000, 3):
        t = jnp.int32(step) + 1
        want = (1.0 - 0.9 ** t.astype(jnp.float32),
                1.0 - 0.95 ** t.astype(jnp.float32))
        got = tadamw_mod.bias_corrections(0.9, 0.95, step)
        assert [float(x) for x in got] == [float(x) for x in want], step


# ---------------------------------------------------------------------------
# AdamW on a tree
# ---------------------------------------------------------------------------

def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((7, 5)).astype(np.float32) * scale,
            "b": {"c": rng.standard_normal((9,)).astype(np.float32) * scale,
                  "d": rng.standard_normal((3, 4, 2)).astype(np.float32)
                  * scale}}


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


def test_global_norm_clip_and_apply_match_jax():
    g = _tree(0, scale=3.0)
    assert _rel(tadamw_mod.global_norm(_t(g)),
                jadamw_mod.global_norm(g)) <= 1e-6
    got, gn = tadamw_mod.clip_by_global_norm(_t(g), 1.0)
    want, jn = jadamw_mod.clip_by_global_norm(g, 1.0)
    assert _rel(gn, jn) <= 1e-6
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        assert _rel(a, b) <= 1e-6
    p = jax.tree.map(lambda x: x.astype(jnp.bfloat16), _tree(1))
    u = _tree(2, scale=1e-2)
    want = jadamw_mod.apply_updates(p, u)
    tp = jax.tree.map(lambda x: torch.from_numpy(np.asarray(
        x, np.float32)).bfloat16(), p)
    got = tadamw_mod.apply_updates(tp, _t(u))
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    before = [x.clone() for x in leaves(tp)]
    out = tadamw_mod.apply_updates(tp, _t(u), in_place=True)
    assert all(x is y for x, y in zip(leaves(out), leaves(tp)))
    for x, b, y in zip(leaves(tp), leaves(got), before):
        assert torch.equal(x, b) and not torch.equal(x, y)


@pytest.mark.parametrize("kw", [dict(), dict(grad_clip=None),
                                dict(grad_clip=0.5, weight_decay=0.0)])
def test_adamw_steps_match_jax(kw):
    """One step, then four more from the same state, with a warmup
    schedule: the parameters within 1e-5 of max|p|, the moments of
    their max; the port writes its moments in place."""
    lr = jsched.warmup_cosine(1e-2, 2, 10)
    jopt = jadamw_mod.adamw(lr, **kw)
    topt = tadamw_mod.adamw(tsched.warmup_cosine(1e-2, 2, 10), **kw)
    jp, tp = _tree(3), _t(_tree(3))
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        g = _tree(10 + step, scale=0.5)
        ju, js, jm_ = jopt.update(g, js, jp, jnp.int32(step))
        m_before = leaves(ts["m"])
        tu, ts, tm_ = topt.update(_t(g), ts, tp, step)
        assert all(a is b for a, b in zip(leaves(ts["m"]), m_before))
        jp = jadamw_mod.apply_updates(jp, ju)
        tp = tadamw_mod.apply_updates(tp, tu)
        assert _rel(tm_["grad_norm"], jm_["grad_norm"]) <= 1e-6
        for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
            assert _rel(a, b) <= 1e-5, step
        for key in ("m", "v"):
            for a, b in zip(leaves(ts[key]), jax.tree.leaves(js[key])):
                assert _rel(a, b) <= 1e-5, (key, step)


def test_adamw_bf16_moments():
    opt = tadamw_mod.adamw(1e-3, moment_dtype=torch.bfloat16)
    p = _t(_tree(4))
    st = opt.init(p)
    assert all(x.dtype == torch.bfloat16 for x in leaves(st["m"]))
    u, st, _ = opt.update(_t(_tree(5)), st, p, 0)
    assert all(x.dtype == torch.float32 for x in leaves(u))


# ---------------------------------------------------------------------------
# Shampoo pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(40, 24), (3, 70, 33), (2, 64), (9,),
                                   (1, 64), (200, 8), (5, 1)])
@pytest.mark.parametrize("block,max_blocks", [(16, 64), (32, 3), (1024, 64)])
def test_plan_and_blocks_match_jax(shape, block, max_blocks):
    plan = tshampoo_mod._plan(shape, block, max_blocks)
    assert plan == jshampoo_mod._plan(shape, block, max_blocks)
    if plan is None:
        return
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = tshampoo_mod._to_blocks(torch.from_numpy(x), plan)
    want = np.asarray(jshampoo_mod._to_blocks(jnp.asarray(x), plan))
    np.testing.assert_array_equal(got.numpy(), want)
    back = tshampoo_mod._from_blocks(got, plan, shape)
    np.testing.assert_array_equal(back.numpy(), x)


def _f64_root(s, eps):
    bs = s.shape[-1]
    s = s / max(np.trace(s) / bs, 1e-30)
    w, u = np.linalg.eigh(s + eps * np.eye(bs))
    return (u * np.maximum(w, eps) ** -0.25) @ u.T


@pytest.mark.parametrize("rows", [2, 8, 256])
def test_inv_4th_root_as_accurate_as_jax(rows):
    """Full rank (256 rows of 32 columns): the port's root within 1e-5
    of JAX's and of float64.  Rank 2 and 8: fp32 ``eigh`` leaves the
    null space's eigenvalues at ``matrix_eps`` +- noise, raised to -1/4;
    the port's root is no farther from float64 than JAX's own, times
    1.5."""
    rng = np.random.default_rng(rows)
    g = rng.standard_normal((rows, 32)).astype(np.float32)
    s = np.stack([g.T @ g, (g.T @ g) * 3.0]).astype(np.float32)
    got = tshampoo_mod._inv_4th_root(torch.from_numpy(s), 1e-6).numpy()
    want = np.asarray(jax.vmap(lambda x: jshampoo_mod._inv_4th_root(
        x, 1e-6))(jnp.asarray(s)))
    oracle = np.stack([_f64_root(x.astype(np.float64), 1e-6) for x in s])
    port_err, jax_err = _rel(got, oracle), _rel(want, oracle)
    if rows == 256:
        assert _rel(got, want) <= 1e-5 and port_err <= 1e-5
    else:
        assert port_err <= 1.5 * jax_err, (port_err, jax_err)
