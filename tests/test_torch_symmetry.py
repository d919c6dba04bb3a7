"""The port's packed-triangle storage against the JAX package's: same
layout, same values, and stacks written by JAX load as they are."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import symmetry as jsym
from repro_torch.core import symmetry as tsym


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These shapes are small: one intra-op thread keeps the test from
    crowding the suite's other workers on a shared CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dense(n, seed):
    return np.random.default_rng(seed).standard_normal((n, n)) \
        .astype(np.float32)


@pytest.mark.parametrize("n,bn", [(40, 8), (64, 8), (64, 16)])
def test_pack_unpack_blocks_match_jax(n, bn):
    c = _dense(n, seed=n + bn)
    want = np.asarray(jsym.pack_tril_blocks(jnp.asarray(c), bn))
    got = tsym.pack_tril_blocks(torch.from_numpy(c), bn)
    np.testing.assert_array_equal(got.numpy(), want)
    for symmetrize in (False, True):
        want_u = np.asarray(jsym.unpack_tril_blocks(
            jnp.asarray(want), n, bn, symmetrize=symmetrize))
        # a stack from the JAX package, handed over as a numpy array
        got_u = tsym.unpack_tril_blocks(want, n, bn, symmetrize=symmetrize)
        np.testing.assert_array_equal(got_u.numpy(), want_u)


@pytest.mark.parametrize("symmetrize", [False, True])
def test_unpack_blocks_of_a_stack_is_each_slot_unpacked(symmetrize):
    """Leading dimensions of a packed stack carry over: a (2, 3) stack of
    packed grams unpacks slot by slot as the JAX package unpacks each."""
    stacks = np.stack([np.asarray(jsym.pack_tril_blocks(
        jnp.asarray(_dense(40, seed=s)), 8)) for s in range(6)])
    got = tsym.unpack_tril_blocks(stacks.reshape(2, 3, *stacks.shape[1:]),
                                  40, 8, symmetrize=symmetrize)
    assert got.shape == (2, 3, 40, 40)
    for s in range(6):
        np.testing.assert_array_equal(
            got.reshape(6, 40, 40)[s].numpy(),
            np.asarray(jsym.unpack_tril_blocks(
                jnp.asarray(stacks[s]), 40, 8, symmetrize=symmetrize)))


@pytest.mark.parametrize("n,bn", [(40, 8), (64, 16)])
def test_tril_vector_and_symmetrize_match_jax(n, bn):
    c = _dense(n, seed=7)
    stack = np.asarray(jsym.pack_tril_blocks(jnp.asarray(c), bn))
    for k in (n, n - 3):
        np.testing.assert_array_equal(
            tsym.tril_vector_from_blocks(stack, bn, k).numpy(),
            np.asarray(jsym.tril_vector_from_blocks(jnp.asarray(stack),
                                                    bn, k)))
    np.testing.assert_array_equal(
        tsym.symmetrize_from_lower(torch.from_numpy(c)).numpy(),
        np.asarray(jsym.symmetrize_from_lower(jnp.asarray(c))))


def test_tri_index_coords_and_errors_match_jax():
    for t in (1, 5, 8):
        assert tsym.tri_count(t) == jsym.tri_count(t)
        np.testing.assert_array_equal(tsym.tri_coords(t).numpy(),
                                      jsym.tri_coords(t))
        assert tsym.tri_coords(t).dtype == torch.int32
    assert [tsym.tri_index(i, j) for i in range(6) for j in range(i + 1)] \
        == [jsym.tri_index(i, j) for i in range(6) for j in range(i + 1)]
    for mod in (tsym, jsym):
        with pytest.raises(ValueError):
            mod.tri_index(1, 2)
        with pytest.raises(ValueError):
            mod.pack_tril_blocks(np.zeros((40, 40), np.float32), 16)


def test_bf16_stack_from_jax_loads():
    c = _dense(16, seed=3)
    stack = np.asarray(jsym.pack_tril_blocks(
        jnp.asarray(c).astype(jnp.bfloat16), 8))
    got = tsym.unpack_tril_blocks(stack, 16, 8, symmetrize=False)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jsym.unpack_tril_blocks(
        jnp.asarray(stack), 16, 8, symmetrize=False).astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("n", [1, 7, 24, 33])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("symmetrize", [False, True])
def test_pack_unpack_tril_match_jax(n, dtype, symmetrize):
    """Element-packed storage: ``jnp.tril_indices`` order, the same bits
    both ways, and a packed vector from the JAX package (bf16 included,
    as a numpy array) unpacks as it is."""
    jc = jnp.asarray(_dense(n, seed=n)).astype(getattr(jnp, dtype))
    tc = tsym._as_tensor(np.asarray(jc))
    want = np.asarray(jsym.pack_tril(jc))
    got = tsym.pack_tril(tc)
    assert got.dtype == getattr(torch, dtype) and got.shape == (
        n * (n + 1) // 2,)
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))
    want_u = np.asarray(jsym.unpack_tril(jnp.asarray(want), n,
                                         symmetrize=symmetrize))
    got_u = tsym.unpack_tril(want, n, symmetrize=symmetrize)
    assert got_u.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got_u.float().numpy(),
                                  want_u.astype(np.float32))
    # the round trip, and the gather from a block stack, agree with it
    np.testing.assert_array_equal(tsym.pack_tril(got_u).float().numpy(),
                                  want.astype(np.float32))
    bn = 8
    pad = -(-n // bn) * bn
    dense = torch.zeros(pad, pad, dtype=tc.dtype)
    dense[:n, :n] = tc
    stack = tsym.pack_tril_blocks(dense, bn)
    np.testing.assert_array_equal(
        tsym.tril_vector_from_blocks(stack, bn, n).float().numpy(),
        want.astype(np.float32))


@pytest.mark.parametrize("shape", [(), (1,), (6,), (7,), (5,), (0,), (2, 3),
                                   (1, 6), (6, 1)])
def test_unpack_tril_shape_checks_match_jax(shape):
    """A packed tensor broadcasts to n(n+1)/2 entries as the reference's
    ``.at[].set`` broadcasts it: 0-d and length 1 fill the triangle, the
    right length unpacks, every other shape raises ``ValueError``."""
    n = 3
    packed = (np.arange(int(np.prod(shape)), dtype=np.float32) + 1) \
        .reshape(shape)
    try:
        want = np.asarray(jsym.unpack_tril(jnp.asarray(packed), n))
    except ValueError:
        want = None
    if want is None:
        with pytest.raises(ValueError, match="does not broadcast"):
            tsym.unpack_tril(torch.from_numpy(packed), n)
        return
    for symmetrize in (False, True):
        np.testing.assert_array_equal(
            tsym.unpack_tril(torch.from_numpy(packed), n,
                             symmetrize=symmetrize).numpy(),
            np.asarray(jsym.unpack_tril(jnp.asarray(packed), n,
                                        symmetrize=symmetrize)))
