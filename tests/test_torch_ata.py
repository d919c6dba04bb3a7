"""The port's ``ata`` / ``ata_full`` entry points against the JAX
package's reference recursion on the same inputs (``device="cpu"``).

fp32 tolerance 1e-5 of max|C| (tests/test_fused_ata.py:330); the reference
recursions of both packages differ only in summation order.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import ata as jax_ata, ata_full as jax_ata_full
from repro_torch.core import (ata, ata_full, strassen_matmul,
                               unpack_tril_blocks)
from repro_torch.kernels import ops


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These shapes are small: one intra-op thread keeps the test from
    crowding the suite's other workers on a shared CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("levels", [0, 1, 2, "auto"])
@pytest.mark.parametrize("mode", ["reference", "fused"])
@pytest.mark.parametrize("m,n", [(57, 31), (40, 72)])
def test_ata_matches_jax_reference(m, n, mode, levels):
    a = _rand((m, n), seed=m + n)
    want = jax_ata(jnp.asarray(a), levels=levels, leaf=8, mode="reference")
    got = ata(torch.from_numpy(a), levels=levels, leaf=8, mode=mode,
              block=8, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, n)
    assert _rel(got.numpy(), want) <= 1e-5
    full = ata_full(torch.from_numpy(a), levels=levels, leaf=8, mode=mode,
                    block=8, device="cpu")
    want_full = jax_ata_full(jnp.asarray(a), levels=levels, leaf=8,
                             mode="reference")
    assert _rel(full.numpy(), want_full) <= 1e-5
    assert torch.equal(full, full.T)


@pytest.mark.parametrize("variant", ["strassen", "winograd"])
def test_gram_of_rows_reference_matches_jax(variant):
    a = _rand((45, 70), seed=2)
    want = jax_ata(jnp.asarray(a), gram_of="rows", levels=2, leaf=8,
                   variant=variant, mode="reference")
    got = ata(torch.from_numpy(a), gram_of="rows", levels=2, leaf=8,
              variant=variant, mode="reference", device="cpu")
    assert tuple(got.shape) == (45, 45)
    assert _rel(got.numpy(), want) <= 1e-5


def test_auto_mode_and_bf16_on_cpu():
    a = _rand((64, 48), seed=4)
    ab = torch.from_numpy(a).to(torch.bfloat16)
    got = ata(ab, levels=2, leaf=8, device="cpu")      # auto -> reference
    want = jax_ata(jnp.asarray(a).astype(jnp.bfloat16), levels=2, leaf=8,
                   mode="reference")
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5
    packed = ops.ata_fused_packed(torch.from_numpy(a), levels=1, bk=16,
                                  bn=16, device="cpu")
    t = 64 // 16                # 48 columns pad to 2 leaves of 32
    assert tuple(packed.shape) == (t * (t + 1) // 2 * 16, 16)
    dense = unpack_tril_blocks(packed, 64, 16, symmetrize=False)
    assert _rel(torch.tril(dense)[:48, :48].numpy(),
                np.tril(a.astype(np.float64).T @ a)) <= 1e-5


def test_errors():
    a = torch.from_numpy(_rand((16, 16), seed=5))
    with pytest.raises(ValueError):
        ata(a[0], device="cpu")
    with pytest.raises(ValueError):
        ata(a, gram_of="diag", device="cpu")
    with pytest.raises(ValueError):
        ata(a, mode="bogus", device="cpu")
    with pytest.raises(ValueError):
        ata(a, mode="fused", base_syrk=lambda x: x, device="cpu")
    # the row gram and the matmul run their fused kinds now (the plain
    # versions on the CPU); without a card, only device="cpu" runs
    rows = ata(a, gram_of="rows", mode="fused", block=8, device="cpu")
    assert _rel(rows.numpy(), np.tril(a.double().numpy()
                                      @ a.double().numpy().T)) <= 1e-5
    prod = strassen_matmul(a, a, mode="fused", block=8, device="cpu")
    assert _rel(prod.numpy(), a.double().numpy() @ a.double().numpy()) \
        <= 1e-5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            strassen_matmul(a, a, mode="fused")
    # the precision knobs: fp16 operand tiles on both paths against the
    # quantized float64 oracle; the accumulator and stochastic rounding
    # are the fused path's, and the reference path ignores them, as the
    # JAX package's does
    aq = a.half().double().numpy()
    a64 = a.double().numpy()
    for mode in ("reference", "fused"):
        got = ata(a, mode=mode, operand_dtype=torch.float16, device="cpu")
        assert _rel(got.numpy(), np.tril(aq.T @ aq)) <= 1e-5
        got = ata(a, mode=mode, acc_dtype="float64", device="cpu")
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), np.tril(a64.T @ a64)) <= 1e-5
    assert torch.equal(ata(a, mode="reference", sr_seed=3, device="cpu"),
                       ata(a, mode="reference", device="cpu"))
    sr = ata(a, mode="fused", sr_seed=3, out_dtype=torch.bfloat16,
             device="cpu")
    assert sr.dtype == torch.bfloat16
    assert _rel(sr.float().numpy(), np.tril(a64.T @ a64)) <= 2.0 ** -7
    with pytest.raises(ValueError, match="bfloat16"):
        ata(a, mode="fused", sr_seed=3, device="cpu")
    with pytest.raises(ValueError):
        ata(a, mode="fused", acc_dtype="float16", device="cpu")
    # the fused path differentiates through the symm kind
    x = a.clone().requires_grad_()
    ata(x, mode="fused", device="cpu").sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    # the reference path differentiates through autograd
    x = a.clone().requires_grad_()
    ata(x, levels=1, leaf=4, mode="reference", device="cpu").sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape


def test_leaf_hooks_force_reference():
    a = torch.from_numpy(_rand((32, 24), seed=6))
    calls = []

    def syrk(x):
        calls.append(tuple(x.shape))
        return torch.tril(x.T @ x)

    got = ata(a, levels=1, leaf=4, base_syrk=syrk, device="cpu")
    assert calls
    assert _rel(got.numpy(), np.tril(a.double().numpy().T
                                     @ a.double().numpy())) <= 1e-5


def test_strassen_matmul_runs_on_cpu_only_when_asked():
    """``device="cpu"`` runs the reference recursion on the CPU and gives
    the JAX package's product; ``mode="auto"`` is the reference there,
    as ``resolve_mode`` gives for a CPU tensor (on the card it is the
    fused matmul kind)."""
    from repro.core import strassen_matmul as jax_strassen_matmul
    a, b = _rand((40, 33), seed=7), _rand((33, 50), seed=8)
    want = jax_strassen_matmul(jnp.asarray(a), jnp.asarray(b), levels=2,
                               leaf=8, mode="reference")
    for mode in ("auto", "reference"):
        got = strassen_matmul(torch.from_numpy(a), torch.from_numpy(b),
                              levels=2, leaf=8, mode=mode, device="cpu")
        assert got.device.type == "cpu" and tuple(got.shape) == (40, 50)
        assert _rel(got.numpy(), want) <= 1e-5
    got_t = strassen_matmul(torch.from_numpy(a.T.copy()),
                            torch.from_numpy(b), trans_a=True, levels=1,
                            leaf=8, device="cpu")
    assert _rel(got_t.numpy(), a.astype(np.float64) @ b) <= 1e-5
