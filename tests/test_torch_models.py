"""The port's model side against the JAX package, on the CPU.

The same weights (the JAX package's ``init_params``, carried over by
``params_from_jax``) and the same inputs (numpy, from a seed) go through
``repro.models`` and ``repro_torch.models``.  The JAX flash branch runs
its Pallas kernel in interpret mode, the port's its plain version.

Tolerances:
- fp32: 1e-4 of max|out| of the JAX result (sums in another order);
- bf16: the JAX suite's own, ``rtol = atol`` 4e-2 for train and prefill
  and 5e-2 for decode (tests/test_models.py), as the two frameworks
  round to bf16 at other places.
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
from repro_torch.configs.registry import ARCHS, get_arch, reduced_arch
from repro_torch.models import blocks, layers
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import param_count, param_spec

F32_BAR = 1e-4
BF16_TOL = {"train": 4e-2, "prefill": 4e-2, "decode": 5e-2}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(x, dtype=None):
    """A numpy array (or JAX array) as a torch tensor, bf16 bit for bit."""
    from repro_torch.models.convert import _tensor
    t = _tensor(np.asarray(x), "cpu")
    return t if dtype is None else t.to(dtype)


def _bias_noise(tree, seed=7):
    """Nonzero biases and norm scales (init makes them 0 and 1), so that
    the tests see them."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        name = jax.tree_util.keystr(path)
        if any(k in name for k in ("'bq'", "'bk'", "'bv'", "'bo'",
                                   "'scale'", "_norm'")):
            noise = rng.standard_normal(x.shape).astype(np.float32) * 0.1
            return (x.astype(jnp.float32) + noise).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(f, tree)


def _models(arch, dtype="float32", impl="xla", **over):
    jcfg = jax_reduced_arch(arch, dtype=dtype, attn_impl=impl, **over)
    cfg = reduced_arch(arch, dtype=dtype, attn_impl=impl, **over)
    jp = _bias_noise(jm.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, cfg, tp


def _check(got, want, dtype, mode):
    if dtype == "float32":
        assert _rel(got, want) <= F32_BAR, (mode, _rel(got, want))
    else:
        tol = BF16_TOL[mode]
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# layers.attention and attn_block
# ---------------------------------------------------------------------------

def _qkv(b, sq, skv, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), np.float32),
            rng.standard_normal((b, skv, hkv, d), np.float32),
            rng.standard_normal((b, skv, hkv, d), np.float32))


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("window", [None, 12])
def test_attention_matches_jax(impl, window):
    q, k, v = _qkv(2, 40, 40, 4, 2, 32)
    pos = np.arange(40)
    kw = dict(causal=True, window=window, impl=impl, attn_softcap=None)
    want = jax_layers.attention(*(jnp.asarray(x) for x in (q, k, v)),
                                q_pos=jnp.asarray(pos),
                                kv_pos=jnp.asarray(pos), **kw)
    got = layers.attention(*(torch.from_numpy(x) for x in (q, k, v)),
                           q_pos=torch.from_numpy(pos),
                           kv_pos=torch.from_numpy(pos), **kw)
    assert _rel(got.numpy(), want) <= F32_BAR


@pytest.mark.parametrize("per_row", [False, True])
def test_attention_decode_step_with_kv_len(per_row):
    """One decode query against a 48-slot cache of which 20 are valid
    (the one-shot branch with ``kv_len``; flash is not taken there)."""
    q, k, v = _qkv(2, 1, 48, 4, 2, 32, seed=1)
    kv_pos = np.arange(48)
    want = jax_layers.attention(
        *(jnp.asarray(x) for x in (q, k, v)), q_pos=jnp.asarray([19]),
        kv_pos=jnp.asarray(kv_pos), kv_len=jnp.asarray(20), impl="flash")
    q_pos = torch.tensor([[19], [19]]) if per_row else torch.tensor([19])
    kv_len = torch.tensor([20, 20]) if per_row else torch.tensor(20)
    got = layers.attention(*(torch.from_numpy(x) for x in (q, k, v)),
                           q_pos=q_pos, kv_pos=torch.from_numpy(kv_pos),
                           kv_len=kv_len, impl="flash")
    assert _rel(got.numpy(), want) <= F32_BAR


def test_rope_pairs_interleaved_lanes():
    x = np.random.default_rng(2).standard_normal((2, 9, 3, 16), np.float32)
    pos = np.arange(9)
    cos, sin = jax_layers.rope_table(jnp.asarray(pos), 16, 1e6)
    want = jax_layers.apply_rope(jnp.asarray(x), cos, sin)
    tcos, tsin = layers.rope_table(torch.from_numpy(pos), 16, 1e6)
    got = layers.apply_rope(torch.from_numpy(x), tcos, tsin)
    assert _rel(got.numpy(), want) <= 1e-6


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("window", [None, 8])
def test_attn_block_matches_jax(impl, window):
    over = {} if window is None else {"sliding_window": window}
    jcfg = jax_reduced_arch("qwen2.5-3b", dtype="float32", attn_impl=impl,
                            **over)
    cfg = reduced_arch("qwen2.5-3b", dtype="float32", attn_impl=impl, **over)
    jp = _bias_noise(jax_blocks.init_attn_block(jcfg, jax.random.PRNGKey(4)))
    tp = jax.tree.map(lambda a: _t(a), jp)
    x = np.random.default_rng(3).standard_normal((2, 24, cfg.d_model),
                                                 np.float32)
    pos = np.arange(24)
    want, _ = jax_blocks.attn_block(
        jp, jnp.asarray(x), jcfg, layer_idx=0,
        pos=jax_blocks.PosInfo(jnp.asarray(pos), jnp.asarray(pos),
                               jnp.asarray(pos), None))
    got, _ = blocks.attn_block(
        tp, torch.from_numpy(x), cfg, layer_idx=0,
        pos=blocks.PosInfo(torch.from_numpy(pos), torch.from_numpy(pos),
                           torch.from_numpy(pos), None))
    assert _rel(got.numpy(), want) <= F32_BAR


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_train_prefill_decode_match_jax(dtype, impl):
    """Reduced Qwen2.5-3B (4 layers, d 256): train mode, then a prefill of
    32 tokens into a 48-slot cache and three decode steps; train mode
    over 80 tokens, past ``attn_chunk_q`` (64: "xla" takes the chunked
    branch)."""
    jcfg, jp, cfg, tp = _models("qwen2.5-3b", dtype, impl)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 80))
    jl, _, _ = jm.forward(jcfg, jp, jnp.asarray(toks), mode="train")
    tl, aux, hidden = tm.forward(cfg, tp, torch.from_numpy(toks),
                                 mode="train")
    assert tuple(tl.shape) == (2, 80, cfg.vocab_size)
    assert float(aux) == 0.0 and tuple(hidden.shape) == (2, 80, cfg.d_model)
    _check(tl.float().numpy(), jl, dtype, "train")

    s = 32
    jc = jm.init_cache(jcfg, 2, 48)
    tc = tm.init_cache(cfg, 2, 48, device="cpu")
    jl, jc = jm.forward(jcfg, jp, jnp.asarray(toks[:, :s]), cache=jc,
                        mode="prefill")
    tl, tc = tm.forward(cfg, tp, torch.from_numpy(toks[:, :s]), cache=tc,
                        mode="prefill")
    _check(tl.float().numpy(), jl, dtype, "prefill")
    assert int(tc["index"]) == s
    _check(tc["blocks"]["k"].float().numpy(), jc["blocks"]["k"], dtype,
           "prefill")
    for i in range(3):
        step = toks[:, s + i:s + i + 1]
        jl, jc = jm.decode_step(jcfg, jp, jnp.asarray(step), jc)
        tl, tc = tm.decode_step(cfg, tp, torch.from_numpy(step), tc)
        _check(tl.float().numpy(), jl, dtype, "decode")
    assert int(tc["index"]) == s + 3


def test_prefill_fills_a_cache_of_its_own_length():
    """A prompt as long as the cache takes the "fill" branch of the block's
    cache write; the next decode step clamps its write into the last slot,
    as ``lax.dynamic_update_slice`` does."""
    jcfg, jp, cfg, tp = _models("qwen2.5-3b", impl="flash")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 33))
    jl, jc = jm.prefill(jcfg, jp, jnp.asarray(toks[:, :32]),
                        jm.init_cache(jcfg, 1, 32))
    tl, tc = tm.prefill(cfg, tp, torch.from_numpy(toks[:, :32]),
                        tm.init_cache(cfg, 1, 32, device="cpu"))
    _check(tl.numpy(), jl, "float32", "prefill")
    jl, jc = jm.decode_step(jcfg, jp, jnp.asarray(toks[:, 32:]), jc)
    tl, tc = tm.decode_step(cfg, tp, torch.from_numpy(toks[:, 32:]), tc)
    _check(tl.numpy(), jl, "float32", "decode")
    _check(tc["blocks"]["v"].numpy(), jc["blocks"]["v"], "float32", "decode")


def test_decode_with_one_index_per_row():
    """The engine's batched decode: rows at different positions in one
    forward equal each row decoded alone."""
    _, _, cfg, tp = _models("qwen2.5-3b")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, (1, n)) for n in (9, 20)]
    nxt = rng.integers(0, cfg.vocab_size, (2, 1))
    alone, caches = [], []
    for p, t in zip(prompts, nxt):
        c = tm.init_cache(cfg, 1, 32, device="cpu")
        _, c = tm.prefill(cfg, tp, torch.from_numpy(p), c)
        caches.append({"index": c["index"].clone(),
                       "blocks": {k: v.clone() for k, v in
                                  c["blocks"].items()}})
        logits, _ = tm.decode_step(cfg, tp, torch.from_numpy(t[None]), c)
        alone.append(logits[0])
    batch = {"index": torch.stack([c["index"] for c in caches]),
             "blocks": {k: torch.cat([c["blocks"][k] for c in caches], 1)
                        for k in ("k", "v")}}
    logits, batch = tm.decode_step(cfg, tp, torch.from_numpy(nxt), batch)
    assert batch["index"].tolist() == [10, 21]
    for row, want in enumerate(alone):
        assert _rel(logits[row].numpy(), want.numpy()) <= 1e-5


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_ported_arch_matches_jax(arch):
    """Every arch at its reduced config (GQA, QKV bias, qk-norm, gemma2's
    softcaps, post-norms and alternating window, the moe family, Mamba2's
    SSD, Zamba2's shared block, Whisper's encoder-decoder over 16 frames
    of numpy embeddings), train mode over 96 tokens: the "xla" attention
    takes the chunked branch (chunks of 64)."""
    jcfg, jp, cfg, tp = _models(arch)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 96))
    enc = {}
    if cfg.family == "audio":
        enc = {"enc_inputs": np.random.default_rng(4).standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}
    jl, _, _ = jm.forward(jcfg, jp, jnp.asarray(toks), mode="train",
                          **{k: jnp.asarray(v) for k, v in enc.items()})
    tl, _, _ = tm.forward(cfg, tp, torch.from_numpy(toks), mode="train",
                          **{k: torch.from_numpy(v) for k, v in enc.items()})
    assert _rel(tl.numpy(), jl) <= F32_BAR


def test_params_from_jax_maps_every_leaf():
    jcfg, jp, cfg, tp = _models("qwen2.5-3b")
    jleaves = jax.tree.leaves(jp)
    n_blocks = len(jax.tree.leaves(jp["blocks"]))
    # each stacked block leaf becomes one tensor per layer
    tleaves = jax.tree.leaves(tp)
    assert len(tleaves) == len(jleaves) - n_blocks \
        + n_blocks * cfg.num_layers
    assert param_count(tp) == sum(x.size for x in jleaves)
    assert jax.tree.map(lambda t: tuple(t.shape), tp) == param_spec(cfg)
    for li in (0, cfg.num_layers - 1):
        np.testing.assert_array_equal(
            tp["blocks"][li]["attn"]["bq"].numpy(),
            np.asarray(jp["blocks"]["attn"]["bq"][li]))
    np.testing.assert_array_equal(tp["embed"].numpy(), np.asarray(jp["embed"]))

    tree = jax.tree.map(np.asarray, jp)
    extra = dict(tree, stray=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="does not map: \\['stray'\\]"):
        params_from_jax(cfg, extra, device="cpu")
    missing = dict(tree, ln_f={})
    with pytest.raises(ValueError, match="no leaf ln_f/scale"):
        params_from_jax(cfg, missing, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(dataclasses.replace(cfg, d_ff=cfg.d_ff * 2), tree,
                        device="cpu")


def test_bf16_parameters_carry_over_bit_for_bit():
    _, jp, _, tp = _models("qwen2.5-3b", "bfloat16")
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["embed"].view(torch.int16).numpy(),
        np.asarray(jp["embed"]).view(np.int16))


def test_init_params_is_seeded_and_shaped():
    cfg = reduced_arch("qwen2.5-3b")
    a = tm.init_params(cfg, 0, device="cpu")
    b = tm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert a["embed"].dtype == torch.bfloat16
    assert jax.tree.map(lambda t: tuple(t.shape), a) == param_spec(cfg)
    # at full width: the config's count, which leaves out the QKV biases
    # and the norms, is 3.09e9
    full = get_arch("qwen2.5-3b")
    shapes = jax.tree.leaves(param_spec(full),
                             is_leaf=lambda x: isinstance(x, tuple))
    d, kv = full.d_model, full.num_kv_heads * full.head_dim_
    extra = full.num_layers * (d + 2 * kv) + (2 * full.num_layers + 1) * d
    assert sum(int(np.prod(s)) for s in shapes) == \
        full.param_count() + extra
    assert round(full.param_count() / 1e9, 2) == 3.09


def test_unported_families_raise():
    """Every family of the JAX package is ported; one it does not know
    raises ``ValueError("unknown family ...")`` in ``init_params`` as the
    JAX package's does, and in ``init_cache`` and ``forward`` too."""
    jcfg = dataclasses.replace(jax_reduced_arch("qwen2.5-3b"), family="rnn")
    with pytest.raises(ValueError, match="unknown family rnn"):
        jm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = dataclasses.replace(reduced_arch("qwen2.5-3b"), family="rnn")
    with pytest.raises(ValueError, match="unknown family rnn"):
        tm.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="unknown family rnn"):
        tm.init_cache(cfg, 1, 8, device="cpu")
    tp = tm.init_params(reduced_arch("qwen2.5-3b"), 0, device="cpu")
    with pytest.raises(ValueError, match="unknown family rnn"):
        tm.forward(cfg, tp, torch.zeros((1, 4), dtype=torch.long))


def test_registry_matches_jax():
    """The JAX registry's ten archs, all six families, are the port's
    ``ARCHS`` with every field equal, and their reduced configs too."""
    from repro.configs.registry import ARCHS as JAX_ARCHS
    from repro_torch.configs.registry import PORTED_FAMILIES
    assert sorted(ARCHS) == sorted(JAX_ARCHS) and len(ARCHS) == 10
    assert {c.family for c in ARCHS.values()} == set(PORTED_FAMILIES)
    for name, jcfg in JAX_ARCHS.items():
        assert dataclasses.asdict(get_arch(name)) == dataclasses.asdict(jcfg)
        assert dataclasses.asdict(reduced_arch(name)) == \
            dataclasses.asdict(jax_reduced_arch(name))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_past_attn_chunk_q_takes_the_chunked_branch(dtype):
    """Train mode over 80 and 150 tokens, past the reduced configs'
    ``attn_chunk_q`` of 64: every layer's attention takes the chunked
    branch (ragged at 150), as the JAX package's does."""
    jcfg, jp, cfg, tp = _models("qwen2.5-3b", dtype)
    for seq in (80, 150):
        toks = np.random.default_rng(seq).integers(0, cfg.vocab_size,
                                                   (1, seq))
        jl, _, _ = jm.forward(jcfg, jp, jnp.asarray(toks), mode="train")
        tl, _, _ = tm.forward(cfg, tp, torch.from_numpy(toks), mode="train")
        _check(tl.float().numpy(), jl, dtype, "train")
