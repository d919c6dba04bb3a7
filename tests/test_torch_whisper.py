"""The port's audio family (reduced Whisper-small) against the JAX
package, on the CPU.

Reduced Whisper: 2 encoder layers over 16 frames, 4 decoder layers, d
256, LayerNorm, learned positions, a plain GELU MLP, biases on the
projections, tied embeddings.  Its weights are the JAX tree's layout with
numpy draws at the leaves (``test_torch_ssm.models``), carried over by
``params_from_jax``; the frame embeddings (the stub frontend's
``enc_inputs``) are numpy from a seed.  Held against the JAX package:
the decoder block's cross-attention, the non-causal encoder (its flash
branch too), ``forward`` in train, prefill and decode mode with the
cross keys and values cached, a batch of two decoded at per-row
positions, ``loss_fn`` and its gradients.  The serving engine refuses
the family, whose prefill needs ``enc_inputs``.

Tolerances: fp32 1e-5 of max|out|, a gradient 1e-4 of its leaf's
max|grad|, bf16 logits 0.1 of max|logits|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro.models import blocks as jax_blocks
from repro.models import layers as jax_layers
import repro_torch.models as tm
from repro_torch.configs.registry import get_arch
from repro_torch.models import blocks, layers
from repro_torch.models.model import param_spec
from repro_torch.runtime.serving import ServingEngine

from test_torch_ssm import (BF16_BAR, F32_BAR, flat, jit, loss_grads_match,
                            models, rel)

ARCH = "whisper-small"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(b, cfg, seed=30):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _pos(n):
    p = np.arange(n)
    return (jax_blocks.PosInfo(*(jnp.asarray(p),) * 3, None),
            blocks.PosInfo(*(torch.from_numpy(p),) * 3, None))


def test_cross_attention_block_matches_jax():
    """A decoder block (self-attention, cross-attention over an encoder
    output of 16 frames, MLP) in prefill with a cache: the cross keys and
    values written into ``ck``/``cv`` in place (the forward's test
    decodes from them)."""
    jcfg, jp, cfg, tp = models(ARCH)
    jb = jax.tree.map(lambda a: a[1], jp["blocks"])
    tb = tp["blocks"][1]
    assert {"ln_cross", "cross"} <= set(tb)
    rng = np.random.default_rng(31)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    jpos, tpos = _pos(12)
    block = jit(jax_blocks.attn_block, cfg=jcfg, layer_idx=1)
    jc = jax.tree.map(lambda a: a[1], jm.init_cache(jcfg, 2, 12)["blocks"])
    tc = {k: v[1] for k, v in
          tm.init_cache(cfg, 2, 12, device="cpu")["blocks"].items()}
    assert tuple(tc["ck"].shape) == (2, 16, 4, 64)
    want, wc = block(jb, jnp.asarray(x), pos=jpos, cache=jc,
                     enc_out=jnp.asarray(enc))
    got, nc = blocks.attn_block(tb, torch.from_numpy(x), cfg, layer_idx=1,
                                pos=tpos, cache=tc,
                                enc_out=torch.from_numpy(enc))
    assert rel(got, want) <= F32_BAR
    for k in ("k", "v", "ck", "cv"):
        assert nc[k] is tc[k] and rel(tc[k], wc[k]) <= F32_BAR, k


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_encoder_block_is_non_causal(impl):
    """An encoder block (``causal=False``) over 16 frames: the port's
    "xla" and flash branches (the kernel's plain version on the CPU)
    against the JAX package's "xla"; the last frame changes the first
    frame's output."""
    jcfg, jp, _, _ = models(ARCH)
    _, _, cfg, tp = models(ARCH, attn_impl=impl)
    jb = jax.tree.map(lambda a: a[0], jp["enc_blocks"])
    x = np.random.default_rng(32).standard_normal((2, 16, cfg.d_model)
                                                  ).astype(np.float32)
    jpos, tpos = _pos(16)
    want, _ = jit(jax_blocks.attn_block, cfg=jcfg, layer_idx=0,
                  causal=False)(jb, jnp.asarray(x), pos=jpos)
    got, _ = blocks.attn_block(tp["enc_blocks"][0], torch.from_numpy(x), cfg,
                               layer_idx=0, pos=tpos, causal=False)
    assert rel(got, want) <= F32_BAR
    x2 = x.copy()
    x2[:, -1] = np.random.default_rng(39).standard_normal(x2[:, -1].shape)
    got2, _ = blocks.attn_block(tp["enc_blocks"][0], torch.from_numpy(x2),
                                cfg, layer_idx=0, pos=tpos, causal=False)
    assert not torch.allclose(got2[:, 0], got[:, 0])


def test_flash_encoder_at_a_ragged_length():
    """The non-causal flash branch takes any number of frames (the kernel
    masks its ragged edges): over 600 frames, past the JAX package's kv
    block of 512 and not a multiple of it, the port's
    ``attention(impl="flash", causal=False)`` equals its "xla" branch
    (the JAX package's, ``test_torch_models.py``), where the JAX flash
    branch refuses (it would attend its zero-padded keys), as it refuses
    Whisper's 1500 frames (ROADMAP.md Queue 3)."""
    rng = np.random.default_rng(33)
    q, k, v = (rng.standard_normal((1, 600, 2, 16)).astype(np.float32)
               for _ in range(3))
    pos = torch.arange(600)
    want, got = (layers.attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                  q_pos=pos, kv_pos=pos, causal=False,
                                  impl=impl) for impl in ("xla", "flash"))
    assert rel(got, want) <= F32_BAR
    with pytest.raises(NotImplementedError, match="ragged kv"):
        jax_layers.attention(*(jnp.asarray(x) for x in (q, k, v)),
                             q_pos=jnp.asarray(pos.numpy()),
                             kv_pos=jnp.asarray(pos.numpy()), causal=False,
                             impl="flash")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_forward_prefill_decode_match_jax(dtype):
    """Train mode over 40 tokens with 16 frames a row; a prefill of 12
    into a 20-slot cache (the encoder run once, its keys and values
    cached), then (fp32) three decode steps from the cache alone; the
    logits and every cache entry."""
    jcfg, jp, cfg, tp = models(ARCH, dtype)
    bar = F32_BAR if dtype == "float32" else BF16_BAR
    toks = np.random.default_rng(34).integers(0, cfg.vocab_size, (2, 40))
    enc = _frames(2, cfg)
    jl, _, _ = jit(jm.forward, jcfg, mode="train")(
        jp, jnp.asarray(toks), enc_inputs=jnp.asarray(enc))
    tl, aux, _ = tm.forward(cfg, tp, torch.from_numpy(toks),
                            enc_inputs=torch.from_numpy(enc), mode="train")
    assert rel(tl, jl) <= bar and float(aux) == 0.0
    jc, tc = jm.init_cache(jcfg, 2, 20), tm.init_cache(cfg, 2, 20,
                                                       device="cpu")
    jl, jc = jit(jm.prefill, jcfg)(jp, jnp.asarray(toks[:, :12]), jc,
                                   enc_inputs=jnp.asarray(enc))
    tl, tc = tm.prefill(cfg, tp, torch.from_numpy(toks[:, :12]), tc,
                        enc_inputs=torch.from_numpy(enc))
    assert rel(tl, jl) <= bar
    steps = range(12, 15) if dtype == "float32" else ()
    for i in steps:
        jl, jc = jit(jm.decode_step, jcfg)(jp, jnp.asarray(toks[:, i:i + 1]),
                                           jc)
        tl, tc = tm.decode_step(cfg, tp, torch.from_numpy(toks[:, i:i + 1]),
                                tc)
        assert rel(tl, jl) <= bar
    assert int(tc["index"]) == 12 + len(steps)
    for name, t in tc["blocks"].items():
        assert tuple(t.shape) == jc["blocks"][name].shape
        assert rel(t, jc["blocks"][name]) <= bar, name


def test_decode_at_per_row_positions():
    """Two clips prefilled apart (prompts of 4 and 9 tokens), their caches
    stacked into a batch of two with one index a row, decoded together
    for three steps: each row's logits equal the JAX package's decode of
    that row alone (the learned position gathered at each row's own
    index)."""
    jcfg, jp, cfg, tp = models(ARCH)
    rng = np.random.default_rng(35)
    lens = (4, 9)
    toks = rng.integers(0, cfg.vocab_size, (2, 12))
    enc = _frames(2, cfg, seed=36)
    step = jit(jm.decode_step, jcfg)
    jcs, tcs = [], []
    for row, n in enumerate(lens):
        jc = jit(jm.prefill, jcfg)(jp, jnp.asarray(toks[row:row + 1, :n]),
                                   jm.init_cache(jcfg, 1, 16),
                                   enc_inputs=jnp.asarray(enc[row:row + 1]))[1]
        jcs.append(jc)
        tcs.append(tm.prefill(cfg, tp, torch.from_numpy(toks[row:row + 1, :n]),
                              tm.init_cache(cfg, 1, 16, device="cpu"),
                              enc_inputs=torch.from_numpy(enc[row:row + 1]))[1])
    batch = {"index": torch.stack([c["index"] for c in tcs]),
             "blocks": {k: torch.cat([c["blocks"][k] for c in tcs], 1)
                        for k in tcs[0]["blocks"]}}
    for i in range(3):
        nxt = np.stack([toks[row, n + i:n + i + 1]
                        for row, n in enumerate(lens)])
        tl, batch = tm.decode_step(cfg, tp, torch.from_numpy(nxt), batch)
        for row in range(2):
            jl, jcs[row] = step(jp, jnp.asarray(nxt[row:row + 1]), jcs[row])
            assert rel(tl[row], jl[0]) <= F32_BAR, (i, row)
    assert batch["index"].tolist() == [lens[0] + 3, lens[1] + 3]


def test_whisper_loss_and_grads_match_jax():
    """``loss_fn`` with ``enc_inputs`` in the batch and the gradient of
    every parameter (the encoder's, ``enc_pos`` and ``dec_pos`` among
    them) against ``jax.grad``, at 1 encoder and 2 decoder layers."""
    jcfg, jp, cfg, tp = models(ARCH, num_layers=2, encoder_layers=1)
    toks = np.random.default_rng(37).integers(0, cfg.vocab_size, (2, 25))
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:],
             "enc_inputs": _frames(2, cfg, seed=38)}
    loss_grads_match(jcfg, jp, cfg, tp,
                     {k: jnp.asarray(v) for k, v in batch.items()}, batch)


def test_whisper_needs_its_frames_and_no_engine():
    """Train and prefill without ``enc_inputs`` raise, as the JAX
    package's assertion does; the serving engine refuses the family (no
    request carries frames; the JAX engine cannot serve it either)."""
    _, _, cfg, tp = models(ARCH)
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="enc_inputs"):
        tm.forward(cfg, tp, toks, mode="train")
    with pytest.raises(ValueError, match="enc_inputs"):
        tm.prefill(cfg, tp, toks, tm.init_cache(cfg, 1, 8, device="cpu"))
    with pytest.raises(ValueError, match="audio"):
        ServingEngine(cfg, tp, slots=1, max_seq=8, device="cpu")


def test_whisper_tree_and_counts():
    """The full-width tree: 12 encoder and 12 decoder blocks (each with
    ``ln_cross`` and ``cross``), ``ln_enc``, ``enc_pos`` (1500, 768),
    ``dec_pos`` (32768, 768) and no ``unembed`` (tied)."""
    full = get_arch(ARCH)
    spec = param_spec(full)
    assert set(spec) == {"embed", "ln_f", "enc_blocks", "blocks", "ln_enc",
                         "enc_pos", "dec_pos"}
    assert len(spec["enc_blocks"]) == len(spec["blocks"]) == 12
    assert "cross" not in spec["enc_blocks"][0]
    assert spec["blocks"][0]["cross"]["bq"] == (768,)
    assert spec["enc_pos"] == (1500, 768) and spec["dec_pos"] == (32768, 768)
    total = sum(int(np.prod(s)) for _, s in flat(spec))
    assert total == 264628992
    cache = tm.init_cache(dataclasses.replace(full, num_layers=2), 1, 8,
                          device="cpu")
    assert tuple(cache["blocks"]["cv"].shape) == (2, 1, 1500, 12, 64)
