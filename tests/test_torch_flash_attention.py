"""The port's flash attention, run as its plain version on the CPU.

The port's counterpart of tests/test_flash_attention.py.  The same
inputs, made with numpy from a seed, go through the JAX package's
``ops.flash_mha`` (the Pallas kernel in interpret mode) and through the
port's ``ops.flash_mha`` with ``device="cpu"``.  The CUDA kernel itself
is held against this plain version on the card by ``chip_smoke.py``.

Tolerances are the JAX suite's own (``rtol = atol``): 2e-5 in fp32,
2e-2 in bf16, where ``p`` is rounded to bf16 before ``P V`` at blocks
that differ between the two (the port's online softmax follows the CUDA
kernel's kv tiles: 64 in fp32, 128 in bf16, 64 at bf16 head_dim 256).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels.ref import flash_attention_ref as jax_ref
from repro_torch.kernels import ops, ref

p_fa = importlib.import_module("repro_torch.kernels.flash_attention")

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# tests/test_flash_attention.py's grid
GRID = [
    (2, 64, 64, 4, 4, 32),        # MHA square
    (2, 64, 64, 8, 2, 32),        # GQA 4:1
    (1, 128, 128, 4, 1, 16),      # MQA
    (1, 48, 48, 2, 2, 64),        # non-block-multiple seq (padding)
    (2, 32, 96, 4, 4, 32),        # cross-length causal (skv > sq)
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mk(b, sq, skv, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), np.float32),
            rng.standard_normal((b, skv, hkv, d), np.float32),
            rng.standard_normal((b, skv, hkv, d), np.float32))


def _both(qkv, dtype, **kw):
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jax_ops.flash_mha(*(jnp.asarray(x, jd) for x in qkv), **kw)
    got = ops.flash_mha(*(torch.from_numpy(x).to(td) for x in qkv),
                        device="cpu", **kw)
    assert got.dtype == td and tuple(got.shape) == tuple(want.shape)
    return got.float().numpy(), np.asarray(want, np.float32)


def _close(got, want, dtype):
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("b,sq,skv,h,hkv,d", GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_mha_matches_jax(b, sq, skv, h, hkv, d, dtype):
    got, want = _both(_mk(b, sq, skv, h, hkv, d), dtype, causal=True,
                      block_q=32, block_kv=32)
    _close(got, want, dtype)


@pytest.mark.parametrize("window", [16, 48])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_mha_sliding_window(window, dtype):
    """At blocks of 32 a window of 16 leaves rows whose first worked kv
    block is wholly masked (the block skip tests the q block's first
    row): their junk ``p = exp(0)`` must be wiped by the first real score,
    which the finite mask value -1e30 does."""
    got, want = _both(_mk(1, 128, 128, 4, 2, 32), dtype, causal=True,
                      window=window, block_q=32, block_kv=32)
    assert np.isfinite(got).all()
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_mha_softcap(dtype):
    got, want = _both(_mk(1, 64, 64, 2, 2, 32), dtype, causal=True,
                      softcap=50.0, block_q=32, block_kv=32)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_mha_non_causal(dtype):
    got, want = _both(_mk(2, 64, 64, 4, 2, 32), dtype, causal=False,
                      block_q=32, block_kv=32)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_mha_prefill_into_a_larger_cache(dtype):
    """The serving prefill: q is the prompt bucket, kv the whole cache
    (Skv > Sq), positions aligned at the top left, the default blocks;
    the kv past the prompt is masked by causality."""
    got, want = _both(_mk(1, 32, 128, 4, 2, 64), dtype, causal=True)
    _close(got, want, dtype)


def test_flash_mha_window_softcap_head_dim_256():
    got, want = _both(_mk(1, 80, 80, 2, 1, 256, seed=3), "float32",
                      causal=True, window=20, softcap=30.0, block_q=32,
                      block_kv=32)
    _close(got, want, "float32")


@pytest.mark.parametrize("b,sq,skv,h,hkv,kw", [
    (1, 64, 64, 4, 4, {}),                              # causal
    (2, 64, 64, 8, 2, {}),                              # GQA 4:1
    (1, 72, 96, 4, 2, {}),                              # ragged Sq, Skv > Sq
    (1, 80, 80, 4, 2, {"window": 24, "softcap": 30.0}),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_mha_head_dim_80_matches_jax(b, sq, skv, h, hkv, kw, dtype):
    """head_dim 80 (zamba2-2.7b's), which both kernels run as 128 with
    zero columns past 80."""
    got, want = _both(_mk(b, sq, skv, h, hkv, 80, seed=11), dtype,
                      causal=True, block_q=32, block_kv=32, **kw)
    _close(got, want, dtype)


@pytest.mark.parametrize("d", p_fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_at_each_kernel_tile_matches_ref(d, dtype):
    """The plain version, whose online softmax follows the kernel's kv
    tile for its dtype and head_dim, over more than one tile and a ragged
    edge (Sq one tile and a half, Skv two and a half, a window reaching
    back past a tile), against the JAX package's oracle on the same
    (rounded) inputs."""
    td = getattr(torch, dtype)
    bk = p_fa.kv_tile(td, d)
    q, k, v = (torch.from_numpy(x.transpose(0, 2, 1, 3).copy()).to(td)
               for x in _mk(1, bk + bk // 2, 2 * bk + bk // 2, 4, 2, d,
                            seed=d))
    kw = dict(causal=True, window=bk + 8, softcap=0.0)
    got = p_fa.flash_attention(q, k, v, **kw)
    want = np.asarray(jax_ref(*(jnp.asarray(x.float().numpy())
                                for x in (q, k, v)), **kw))
    assert got.dtype == td
    _close(got.float().numpy(), want, dtype)


def test_kernel_tiles():
    """The kernel's tiles, which the plain version and the planted faults
    of the card's checks follow: bf16 q tiles of 128 rows and kv tiles of
    128 (64 at head_dim 256); fp32 q tiles of 128 rows (64 at head_dim
    256) and kv tiles of 64."""
    assert [p_fa.kv_tile(torch.bfloat16, d) for d in p_fa.HEAD_DIMS] == \
        [128, 128, 128, 128, 128, 64]
    assert {p_fa.kv_tile(torch.float32, d) for d in p_fa.HEAD_DIMS} == {64}
    assert {p_fa.q_tile(torch.bfloat16, d) for d in p_fa.HEAD_DIMS} == {128}
    assert [p_fa.q_tile(torch.float32, d) for d in p_fa.HEAD_DIMS] == \
        [128, 128, 128, 128, 128, 64]


@pytest.mark.parametrize("causal,window,softcap",
                         [(True, 0, 0.0), (True, 24, 0.0), (False, 0, 50.0)])
def test_flash_attention_ref_matches_jax(causal, window, softcap):
    q, k, v = (x.transpose(0, 2, 1, 3) for x in _mk(2, 48, 64, 4, 2, 32))
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = np.asarray(jax_ref(*(jnp.asarray(x) for x in (q, k, v)), **kw))
    got = ref.flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                                  **kw).numpy()
    _close(got, want, "float32")


@pytest.mark.parametrize("window", [0, 40])
def test_plain_version_matches_ref_at_kernel_level(window):
    """``flash_attention`` on (B, H, S, D), Skv > Sq and neither a
    multiple of the kernel's fp32 tiles of 64, against the plain oracle."""
    q, k, v = (torch.from_numpy(x.transpose(0, 2, 1, 3).copy())
               for x in _mk(1, 96, 160, 4, 2, 16, seed=5))
    got = p_fa.flash_attention(q, k, v, window=window, block_q=32,
                               block_kv=32)
    want = ref.flash_attention_ref(q, k, v, window=window)
    _close(got.numpy(), want.numpy(), "float32")


def test_non_causal_ragged_kv_raises_as_in_jax():
    qkv = _mk(1, 48, 48, 2, 2, 32)
    with pytest.raises(NotImplementedError, match="ragged kv"):
        jax_ops.flash_mha(*(jnp.asarray(x) for x in qkv), causal=False,
                          block_q=32, block_kv=32)
    with pytest.raises(NotImplementedError, match="ragged kv"):
        ops.flash_mha(*(torch.from_numpy(x) for x in qkv), causal=False,
                      block_q=32, block_kv=32, device="cpu")


@pytest.mark.parametrize("d", [8, 48, 96, 512])
def test_unsupported_head_dim_is_refused(d):
    """The kernel takes head_dim 16, 32, 64, 80, 128 and 256; any other
    size is refused on every device, before anything runs (the JAX
    package's interpret mode takes any size, its TPU kernel a lane-aligned
    one)."""
    qkv = _mk(1, 16, 16, 2, 2, d)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_mha(*(torch.from_numpy(x) for x in qkv), device="cpu")


@pytest.mark.parametrize("sq,skv,block_kv,window",
                         [(80, 40, 32, 0), (80, 40, 32, 30), (100, 50, 16, 0),
                          (70, 20, 512, 0)])
def test_flash_mha_rows_past_ragged_kv_as_in_jax(sq, skv, block_kv, window):
    """Causal, Sq > Skv: the JAX package zero-pads kv to a multiple of
    its block, and the rows past Skv see those zero keys; the port pads
    kv there too (and only there: elsewhere the kernel masks the ragged
    edge itself)."""
    got, want = _both(_mk(1, sq, skv, 2, 1, 16, seed=7), "float32",
                      causal=True, window=window, block_q=32,
                      block_kv=block_kv)
    _close(got, want, "float32")


def test_wrapper_takes_any_lengths_and_ignores_blocks():
    """The kernel tiles by ``q_tile`` and ``kv_tile`` and masks the ragged
    edges itself:
    ``block_q`` and ``block_kv`` are the JAX signature's and change
    nothing, and Sq and Skv need not be multiples of them."""
    q, k, v = (torch.from_numpy(x.transpose(0, 2, 1, 3).copy())
               for x in _mk(1, 40, 72, 4, 2, 32, seed=9))
    want = p_fa.flash_attention(q, k, v)
    for bq, bk in ((16, 16), (32, 48), (512, 512)):
        got = p_fa.flash_attention(q, k, v, block_q=bq, block_kv=bk)
        assert torch.equal(got, want)
    _close(want.numpy(), ref.flash_attention_ref(q, k, v).numpy(),
           "float32")


def test_wrapper_refusals():
    q = torch.zeros(1, 2, 32, 32)
    with pytest.raises(TypeError, match="one dtype"):
        p_fa.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="H % Hkv"):
        p_fa.flash_attention(q, torch.zeros(1, 3, 32, 32),
                             torch.zeros(1, 3, 32, 32))
    with pytest.raises(RuntimeError, match="forward-only"):
        p_fa.flash_attention(q.clone().requires_grad_(), q, q)
    with torch.no_grad():
        p_fa.flash_attention(q.clone().requires_grad_(), q, q)
