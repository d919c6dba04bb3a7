"""The fp32 flash attention at the CUDA-core kernel's tiles, on the CPU.

The fp32 kernel of ``csrc/flash_attention.cu`` takes 128 query rows a
block (64 at head_dim 256) over kv tiles of 64, and runs head dims 16, 32
and 80 as 64 and 128 with zero columns.  Its plain version, which the
card holds it against, follows the kv tile.  Here the plain version
(``flash_attention`` on CPU tensors) runs over more than one q tile and a
ragged last one (Sq a tile and a half), kv over two and a half tiles,
GQA 2:1, at every head dim the kernel takes, causal, under a sliding
window that reaches back past a kv tile, with a softcap, and non-causal
with Skv > Sq; against the JAX package's oracle on the same inputs (made
with numpy from a seed), at the JAX suite's fp32 tolerance (2e-5).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_ref as jax_ref

p_fa = importlib.import_module("repro_torch.kernels.flash_attention")

TOL = 2e-5
CASES = {"causal": dict(causal=True),
         "window": dict(causal=True, window=80),
         "softcap": dict(causal=True, softcap=30.0),
         "window_softcap": dict(causal=True, window=40, softcap=50.0),
         "non_causal": dict(causal=False)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, 4, sq, d), np.float32),
            rng.standard_normal((1, 2, skv, d), np.float32),
            rng.standard_normal((1, 2, skv, d), np.float32))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("d", p_fa.HEAD_DIMS)
def test_plain_version_at_the_fp32_tiles_matches_jax(d, case):
    bq, bk = p_fa.q_tile(torch.float32, d), p_fa.kv_tile(torch.float32, d)
    sq = bq + bq // 2
    skv = max(sq, 2 * bk + bk // 2) if case == "non_causal" \
        else 2 * bk + bk // 2
    q, k, v = _qkv(sq, skv, d, seed=d)
    kw = {"window": 0, "softcap": 0.0, **CASES[case]}
    got = p_fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               **kw)
    want = np.asarray(jax_ref(*(jnp.asarray(x) for x in (q, k, v)), **kw))
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
