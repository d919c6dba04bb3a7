"""The port's serving engine on the recurrent families (reduced Mamba2
and Zamba2), and Zamba2's loss and gradients, against the JAX package,
on the CPU.

The engine prefills a request of the ssm or the hybrid family at its
prompt's true length, where the JAX engine right-pads it to its bucket
and so runs the pads through the recurrence (pinned in
``test_torch_hybrid.py``).  Its tokens and logits are held against the
JAX package's ``prefill`` at the true length followed by
``decode_step``, with the weights of ``test_torch_ssm.models``.

Zamba2's ``loss_fn`` and the gradient of every parameter are held
against ``jax.grad``: the shared attention block's gradient sums its
calls.

Tolerances: fp32 logits 1e-5 of max|logits|, the tokens equal; a
gradient 1e-4 of its leaf's max|grad|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.runtime.serving import ServingEngine, _bucket

from test_torch_hybrid import MAX_SEQ, _jax_true_length
from test_torch_ssm import F32_BAR, loss_grads_match, models, rel

N_NEW = 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Recorder(ServingEngine):
    """The port's engine, keeping the logits each token was sampled from:
    each admission's (FIFO, so in uid order) and each decode tick's row
    of every live request."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.first, self.ticks = [], {}

    def _sample(self, logits):
        if logits.shape[0] == 1:                       # an admission
            self.first.append(logits[0].float().numpy())
        else:
            for slot, r in self.active.items():
                if r is not None:
                    self.ticks.setdefault(r.uid, []).append(
                        logits[slot].float().numpy())
        return super()._sample(logits)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_engine_prefills_at_the_true_length(arch):
    """Three prompts of 5, 20 and 5 tokens (buckets 16, 32, 16) over two
    slots (the third reuses a slot whose state the first left behind),
    fp32, greedy: each request's tokens equal, and its logits within
    1e-5, those of the JAX package's ``prefill`` at the prompt's true
    length followed by ``decode_step``."""
    jcfg, jp, cfg, tp = models(arch)
    rng = np.random.default_rng(22)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 20, 5)]
    assert all(_bucket(len(p)) > len(p) for p in prompts)
    eng = _Recorder(cfg, tp, slots=2, max_seq=MAX_SEQ, device="cpu")
    assert eng.true_length
    for p in prompts:
        eng.add_request(p, max_new_tokens=N_NEW)
    done = {r.uid: r.generated for r in eng.run_to_completion()}
    for uid, prompt in enumerate(prompts):
        toks, rows = _jax_true_length(jcfg, jp, prompt, N_NEW)
        assert done[uid] == toks, (uid, done[uid], toks)
        got = [eng.first[uid]] + eng.ticks[uid]
        assert len(got) == N_NEW
        for g, w in zip(got, rows):
            assert rel(g, w) <= F32_BAR


def test_zamba2_loss_and_grads_match_jax():
    """``loss_fn`` and every parameter's gradient over 40 tokens; the
    shared block's gradient sums its two calls."""
    jcfg, jp, cfg, tp = models("zamba2-2.7b")
    toks = np.random.default_rng(21).integers(0, cfg.vocab_size, (2, 41))
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    loss_grads_match(jcfg, jp, cfg, tp,
                     {k: jnp.asarray(v) for k, v in batch.items()}, batch)
