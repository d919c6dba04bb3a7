"""The port's MLA (DeepSeek-V3's multi-head latent attention) against the
JAX package's, on the CPU.

The same weights (the layout of the JAX package's ``init_mla`` /
``init_mla_block``, numbers drawn with numpy, carried over bit for bit)
and the same inputs (numpy, from a seed) go through ``repro.models`` and
``repro_torch.models`` at reduced
DeepSeek-V3 (4 heads, q rank 64, kv rank 32, nope 32, rope 16, v 32):
the cache content (``mla_compress``), the queries, both attention
branches (the absorbed one, which never expands K or V per position, and
the expanded one through ``attention``, one-shot and chunked), and
``mla_block`` at prefill (a prompt that fills the cache, and a bucket
shorter than it, which takes the absorbed branch) and at decode.

The reference's flash branch cannot run MLA (v's head_dim is not q's):
a test pins its failure and the port's refusal.

Tolerances: fp32 1e-4 of max|out|; bf16 0.1 of max|out|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro.configs.registry import reduced_arch as jax_reduced_arch
from repro.models import blocks as jax_blocks
from repro.models import layers as jax_layers
import repro_torch.models as tm
from repro_torch.configs.registry import reduced_arch
from repro_torch.models import blocks, layers
from repro_torch.models.convert import _tensor, params_from_jax

ARCH = "deepseek-v3-671b"
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


def _t(x):
    return _tensor(np.asarray(x), "cpu")


def _draw(init, seed):
    """``init``'s JAX tree (its layout from ``jax.eval_shape``, so nothing
    compiles) with numpy draws at its leaves: weights normal * 0.02, norm
    scales 1 + noise (so that the tests see them)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(s.shape).astype(np.float32)
        x = 1.0 + 0.1 * x if "norm" in name or "scale" in name else 0.02 * x
        return jnp.asarray(x, s.dtype)
    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(init, jax.random.PRNGKey(0)))


def _mla(dtype):
    jcfg = jax_reduced_arch(ARCH, dtype=dtype)
    cfg = reduced_arch(ARCH, dtype=dtype)
    jp = _draw(lambda k: jax_layers.init_mla(jcfg, k), seed=1)
    return dtype, jcfg, cfg, jp, jax.tree.map(_t, jp)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def mla(request):
    return _mla(request.param)


@pytest.fixture(scope="module")
def mla32():
    return _mla("float32")


def _x(cfg, b, s, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _bar(dtype):
    return F32_BAR if dtype == "float32" else BF16_BAR


def _in(jcfg, x):
    jx = jnp.asarray(x, jnp.dtype(jcfg.dtype))
    return jx, _t(jx)


def test_compress_and_queries_match_jax(mla):
    dtype, jcfg, cfg, jp, tp = mla
    jx, tx = _in(jcfg, _x(cfg, 2, 20))
    pos = np.arange(3, 23)
    want = jax.jit(lambda p, x: (
        jax_layers.mla_compress(p, x, jcfg, jnp.asarray(pos)),
        jax_layers.mla_queries(p, x, jcfg, jnp.asarray(pos))))(jp, jx)
    tpos = torch.from_numpy(pos)
    got = (layers.mla_compress(tp, tx, cfg, tpos),
           layers.mla_queries(tp, tx, cfg, tpos))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == layers.dtype_of(cfg)
        assert _rel(g.float().numpy(), w) <= _bar(dtype)


def _expanded(mla, seq):
    dtype, jcfg, cfg, jp, tp = mla
    jx, tx = _in(jcfg, _x(cfg, 2, seq, seed=seq))
    pos = np.arange(seq)
    chunk = jcfg.attn_chunk_q if seq > jcfg.attn_chunk_q else 0
    want, _ = jax.jit(lambda p, x: jax_layers.mla_attention(
        p, x, jcfg, positions=jnp.asarray(pos), q_pos=jnp.asarray(pos),
        kv_pos=jnp.asarray(pos), chunk_q=chunk,
        chunk_kv=jcfg.attn_chunk_kv))(jp, jx)
    tpos = torch.from_numpy(pos)
    got, _ = layers.mla_attention(tp, tx, cfg, positions=tpos, q_pos=tpos,
                                  kv_pos=tpos, chunk_q=chunk,
                                  chunk_kv=cfg.attn_chunk_kv)
    assert _rel(got.float().numpy(), want) <= _bar(dtype)


def test_expanded_branch_matches_jax(mla):
    """Train mode, K and V expanded from x, through the chunked branch
    (80 tokens, past ``attn_chunk_q`` of 64)."""
    _expanded(mla, 80)


def test_expanded_branch_one_shot_matches_jax(mla32):
    """The same at 24 tokens: the one-shot branch."""
    _expanded(mla32, 24)


def _absorbed(mla, sq):
    dtype, jcfg, cfg, jp, tp = mla
    jx, tx = _in(jcfg, _x(cfg, 1, sq, seed=3))
    jcache, tcache = _in(jcfg, _x(cfg, 1, 40, seed=4))
    cpos = np.arange(40)
    c_kv, k_rope = jax_layers.mla_compress(jp, jcache, jcfg,
                                           jnp.asarray(cpos))
    qpos = np.arange(20, 20 + sq)
    kw = dict(q_pos=qpos, kv_pos=cpos, positions=qpos)
    want, _ = jax.jit(lambda p, x, c, k: jax_layers.mla_attention(
        p, x, jcfg, c_kv=c, k_rope=k, kv_len=jnp.asarray(20 + sq),
        absorbed=True, **{a: jnp.asarray(v) for a, v in kw.items()}))(
            jp, jx, c_kv, k_rope)
    got, _ = layers.mla_attention(
        tp, tx, cfg, c_kv=_t(c_kv), k_rope=_t(k_rope),
        kv_len=torch.tensor(20 + sq), absorbed=True,
        **{a: torch.from_numpy(v) for a, v in kw.items()})
    assert _rel(got.float().numpy(), want) <= _bar(dtype)
    if dtype == "float32":
        # the same attention with K and V expanded
        expanded, _ = layers.mla_attention(
            tp, tx, cfg, c_kv=_t(c_kv), k_rope=_t(k_rope),
            kv_len=torch.tensor(20 + sq),
            **{a: torch.from_numpy(v) for a, v in kw.items()})
        assert _rel(got.numpy(), expanded.numpy()) <= 1e-5


def test_absorbed_branch_matches_jax(mla):
    """A query at position 20 over a 40-slot compressed cache of which 21
    are valid (``kv_len``), in the compressed space; in fp32 also
    against the same attention with K and V expanded."""
    _absorbed(mla, 1)


def test_absorbed_branch_of_a_bucket_matches_jax(mla32):
    """Eight queries at positions 20-27 (a prefill shorter than the
    cache takes this branch)."""
    _absorbed(mla32, 8)


def _block_pair(jcfg, cfg, moe, seed):
    jp = _draw(lambda k: jax_blocks.init_mla_block(jcfg, k, moe=moe), seed)
    return jp, jax.tree.map(_t, jp)


def _jpos(pos, max_seq, kv_len=None):
    return jax_blocks.PosInfo(jnp.asarray(pos), jnp.asarray(pos),
                              jnp.arange(max_seq),
                              None if kv_len is None else jnp.asarray(kv_len))


def _tpos(pos, max_seq, kv_len=None):
    return blocks.PosInfo(torch.from_numpy(pos), torch.from_numpy(pos),
                          torch.arange(max_seq),
                          None if kv_len is None else torch.tensor(kv_len))


@pytest.mark.parametrize("dtype,moe,prompt", [
    ("float32", False, 16), ("float32", True, 16), ("float32", False, 10),
    ("float32", True, 10), ("bfloat16", True, 10)])
def test_mla_block_prefill_then_decode_match_jax(dtype, moe, prompt):
    """A prompt of 16 into a 16-slot cache (the expanded branch) or of 10
    (the absorbed branch, written at position 0), then two decode steps
    written at their positions; the block's output and its cache."""
    jcfg = jax_reduced_arch(ARCH, dtype=dtype)
    cfg = reduced_arch(ARCH, dtype=dtype)
    jp, tp = _block_pair(jcfg, cfg, moe, seed=5)
    max_seq = 16
    jx, tx = _in(jcfg, _x(cfg, 1, prompt + 2, seed=6))
    m = cfg.mla
    jc = {"ckv": jnp.zeros((1, max_seq, m.kv_lora_rank), jcfg.dtype),
          "krope": jnp.zeros((1, max_seq, m.qk_rope_dim), jcfg.dtype)}
    tc = {k: _t(v) for k, v in jc.items()}
    run = jax.jit(lambda p, x, c, pos: jax_blocks.mla_block(
        p, x, jcfg, layer_idx=1, pos=pos, cache=c))
    pos = np.arange(prompt)
    want, jc, jaux = run(jp, jx[:, :prompt], jc, _jpos(pos, max_seq))
    got, tc, aux = blocks.mla_block(tp, tx[:, :prompt], cfg, layer_idx=1,
                                    pos=_tpos(pos, max_seq), cache=tc)
    assert _rel(got.float().numpy(), want) <= _bar(dtype)
    assert abs(float(aux) - float(jaux)) <= _bar(dtype) * max(float(jaux),
                                                             1.0)
    for i in range(prompt, min(prompt + 2, max_seq)):
        step = np.array([i])
        want, jc, _ = run(jp, jx[:, i:i + 1], jc,
                          _jpos(step, max_seq, i + 1))
        got, tc, _ = blocks.mla_block(tp, tx[:, i:i + 1], cfg, layer_idx=1,
                                      pos=_tpos(step, max_seq, i + 1),
                                      cache=tc)
        assert _rel(got.float().numpy(), want) <= _bar(dtype)
    for key in ("ckv", "krope"):
        assert _rel(tc[key].float().numpy(), jc[key]) <= _bar(dtype)


def test_mla_block_decode_one_index_per_row():
    """Rows at different positions decode in one call as each alone."""
    jcfg = jax_reduced_arch(ARCH, dtype="float32")
    cfg = reduced_arch(ARCH, dtype="float32")
    _, tp = _block_pair(jcfg, cfg, True, seed=8)
    x = torch.from_numpy(_x(cfg, 2, 1, seed=9))
    m = cfg.mla
    cache = {"ckv": torch.randn(2, 24, m.kv_lora_rank,
                                generator=torch.Generator().manual_seed(0)),
             "krope": torch.randn(2, 24, m.qk_rope_dim,
                                  generator=torch.Generator().manual_seed(1))}
    idx = np.array([5, 17])
    pos = blocks.PosInfo(torch.from_numpy(idx[:, None]),
                         torch.from_numpy(idx[:, None]), torch.arange(24),
                         torch.from_numpy(idx + 1))
    both, _, _ = blocks.mla_block(
        tp, x, cfg, layer_idx=1, pos=pos,
        cache={k: v.clone() for k, v in cache.items()}, rows_apart=True)
    for r in range(2):
        one, _, _ = blocks.mla_block(
            tp, x[r:r + 1], cfg, layer_idx=1,
            pos=_tpos(idx[r:r + 1], 24, int(idx[r]) + 1),
            cache={k: v[r:r + 1].clone() for k, v in cache.items()})
        assert _rel(both[r].numpy(), one[0].numpy()) <= 1e-6


def test_reference_mla_flash_defect_pinned():
    """The JAX package's flash branch returns q's head_dim (48) where
    MLA's v has 32, so its forward fails at the output reshape
    (``TypeError``); the port refuses MLA under flash with
    ``ValueError`` naming ROADMAP.md Queue 3."""
    jcfg = jax_reduced_arch(ARCH, dtype="float32", attn_impl="flash",
                            num_layers=2)
    cfg = reduced_arch(ARCH, dtype="float32", attn_impl="flash",
                       num_layers=2)
    jp = _draw(lambda k: jm.init_params(jcfg, k), seed=0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 8))
    with pytest.raises(TypeError, match="reshape"):
        jax.jit(lambda p, t: jm.forward(jcfg, p, t, mode="train"))(
            jp, jnp.asarray(toks))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    with pytest.raises(ValueError, match="Queue 3"):
        tm.forward(cfg, tp, torch.from_numpy(toks), mode="train")
    # the same model in "xla" runs
    xcfg = dataclasses.replace(cfg, attn_impl="xla")
    logits, _, _ = tm.forward(xcfg, tp, torch.from_numpy(toks), mode="train")
    assert torch.isfinite(logits).all()
