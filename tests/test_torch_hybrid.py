"""The port's hybrid family (reduced Zamba2-2.7B) against the JAX package,
and the serving engine on the recurrent families, on the CPU.

Zamba2 runs its SSM blocks in groups of ``hybrid_attn_every`` (2 in the
reduced config, so 2 groups of 2), each group followed by the shared
attention block: one weight set, a KV cache of its own for each call.
Its weights are the JAX tree's layout with numpy draws at the leaves
(``test_torch_ssm.models``), carried over by ``params_from_jax``; the
same tokens go through both packages' ``forward`` in train, prefill and
decode mode (``loss_fn`` and its gradients are held in
``test_torch_recurrent.py``).

The JAX serving engine right-pads each prompt to its bucket and so runs
the pads through a recurrent family's conv and SSM: a test pins that
reference defect (ROADMAP.md Queue 3), and that the port's engine, which
prefills such a request at its true length, matches the JAX package's
``prefill`` at that length followed by ``decode_step``
(``test_torch_recurrent.py`` holds it on more prompts).

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
from repro.configs.registry import get_arch as jax_get_arch
from repro.runtime.serving import ServingEngine as JaxEngine
import repro_torch.models as tm
from repro_torch.configs.registry import get_arch, reduced_arch
from repro_torch.models.model import param_spec
from repro_torch.runtime.serving import ServingEngine, _bucket

from test_torch_ssm import BF16_BAR, F32_BAR, flat, jit, models, rel

MAX_SEQ = 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zamba2_forward_and_caches_match_jax(dtype, impl):
    """Reduced Zamba2 (4 SSM layers with MLPs, the shared block after
    each pair): train mode over 70 tokens, a prefill of 37 into a
    48-slot cache and three decode steps, the logits and every cache
    entry (the SSM states, each call's KV) leaf by leaf.  The port's
    flash branch (its plain version on the CPU) is held against the JAX
    package's "xla"."""
    jcfg, jp, _, _ = models("zamba2-2.7b", dtype)
    _, _, cfg, tp = models("zamba2-2.7b", dtype, attn_impl=impl)
    bar = F32_BAR if dtype == "float32" else BF16_BAR
    toks = np.random.default_rng(20).integers(0, cfg.vocab_size, (2, 70))
    jl, _, _ = jit(jm.forward, jcfg, mode="train")(jp, jnp.asarray(toks))
    tl, _, _ = tm.forward(cfg, tp, torch.from_numpy(toks), mode="train")
    assert rel(tl, jl) <= bar
    jc, tc = jm.init_cache(jcfg, 2, 48), tm.init_cache(cfg, 2, 48,
                                                       device="cpu")
    assert tuple(tc["shared_attn"]["k"].shape) == (2, 2, 48, 4, 64)
    jl, jc = jit(jm.prefill, jcfg)(jp, jnp.asarray(toks[:, :37]), jc)
    tl, tc = tm.prefill(cfg, tp, torch.from_numpy(toks[:, :37]), tc)
    assert rel(tl, jl) <= bar
    step = jit(jm.decode_step, jcfg)
    for i in range(37, 40):
        jl, jc = step(jp, jnp.asarray(toks[:, i:i + 1]), jc)
        tl, tc = tm.decode_step(cfg, tp, torch.from_numpy(toks[:, i:i + 1]),
                                tc)
        assert rel(tl, jl) <= bar
    for key in ("blocks", "shared_attn"):
        for name, t in tc[key].items():
            assert tuple(t.shape) == jc[key][name].shape
            assert rel(t, jc[key][name]) <= bar, (key, name)


def test_zamba2_tree_and_counts():
    """The full-width tree: 54 SSM blocks, each with Zamba2's SwiGLU MLP
    (the JAX package gives every SSM block of a config with d_ff one),
    and ONE shared attention block; the cache has one KV entry for each
    of its 9 calls; the element count equals the JAX tree's."""
    full = get_arch("zamba2-2.7b")
    spec = param_spec(full)
    assert len(spec["blocks"]) == 54
    assert set(spec["blocks"][0]) == {"ln", "ssm", "ln_mlp", "mlp"}
    assert isinstance(spec["shared_attn"], dict)
    assert spec["shared_attn"]["attn"]["wq"] == (2560, 32 * 80)
    total = sum(int(np.prod(s)) for _, s in flat(spec))
    jshapes = jax.eval_shape(lambda k: jm.init_params(jax_get_arch(
        "zamba2-2.7b"), k), jax.random.PRNGKey(0))
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jshapes)) \
        == total
    cfg = dataclasses.replace(reduced_arch("zamba2-2.7b"), num_layers=6,
                              hybrid_attn_every=3)
    cache = tm.init_cache(cfg, 3, 20, device="cpu")
    assert tuple(cache["shared_attn"]["v"].shape) == (2, 3, 20, 4, 64)
    assert tuple(cache["blocks"]["ssm"].shape) == (6, 3, 16, 32, 16)
    assert cache["blocks"]["ssm"].dtype == torch.float32


# ---------------------------------------------------------------------------
# Serving the recurrent families
# ---------------------------------------------------------------------------

def _jax_true_length(jcfg, jp, prompt, n_new):
    """The JAX package's ``prefill`` at the prompt's true length, then
    ``decode_step``, greedy: (tokens, logits a token)."""
    cache = jm.init_cache(jcfg, 1, MAX_SEQ)
    logits, cache = jit(jm.prefill, jcfg)(jp, jnp.asarray([prompt]), cache)
    step = jit(jm.decode_step, jcfg)
    toks, rows = [], []
    for _ in range(n_new):
        rows.append(np.asarray(logits[0], np.float32))
        toks.append(int(jnp.argmax(logits[0])))
        if len(toks) < n_new:
            logits, cache = step(jp, jnp.asarray([[toks[-1]]]), cache)
    return toks, rows


def test_reference_engine_pads_recurrent_state_pinned():
    """The JAX engine right-pads a prompt to its bucket with token 0, and
    for a recurrent family the pads run through the conv and the SSM:
    reduced Mamba2, seed 0, one 20-token prompt in the 32 bucket, fp32.
    Its SSM state after prefill is not that of a prefill at the true
    length (max|d| near half of max|state|), and its greedy tokens part
    from the true-length ``prefill`` + ``decode_step`` at the third.  The
    port's engine keeps the true length: its state and tokens are the
    true-length prefill's.  A reference-side defect (ROADMAP.md Queue 3):
    do not copy it, do not fix it in ``src/repro/``."""
    jcfg, jp, cfg, tp = models("mamba2-2.7b")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               20).tolist()
    assert _bucket(len(prompt)) == 32
    n_new = 6
    want, _ = _jax_true_length(jcfg, jp, prompt, n_new)
    cache = jm.init_cache(jcfg, 1, MAX_SEQ)
    _, cache = jit(jm.prefill, jcfg)(jp, jnp.asarray([prompt]), cache)
    true_state = np.asarray(cache["blocks"]["ssm"], np.float32)

    jeng = JaxEngine(jcfg, jp, slots=1, max_seq=MAX_SEQ)
    jeng.add_request(prompt, max_new_tokens=n_new)
    jeng._admit()
    padded_state = np.asarray(jeng.cache["blocks"]["ssm"][0], np.float32)
    assert np.abs(padded_state - true_state).max() \
        > 0.1 * np.abs(true_state).max()
    jtoks = jeng.run_to_completion()[0].generated
    assert jtoks[:2] == want[:2] and jtoks != want

    eng = ServingEngine(cfg, tp, slots=1, max_seq=MAX_SEQ, device="cpu")
    eng.add_request(prompt, max_new_tokens=n_new)
    eng._admit()
    assert rel(eng.cache["blocks"]["ssm"][:, 0:1], true_state) <= F32_BAR
    assert eng.run_to_completion()[0].generated == want
    # the attention families keep the bucket
    dense = reduced_arch("qwen2.5-3b", dtype="float32")
    assert not ServingEngine(dense, tm.init_params(dense, 0, device="cpu"),
                             slots=1, max_seq=MAX_SEQ,
                             device="cpu").true_length
