"""The port's gram.verify: the Freivalds-style output guards.

The cases of tests/test_gram_verify.py, run through the port's module on
numpy arrays and on torch tensors, each verdict equal to the JAX
package's on the same inputs; the vetoes land in the port's own tracer.
"""
import numpy as np
import pytest
import torch

from repro.core.symmetry import pack_tril
from repro.gram import verify as jax_verify
from repro_torch.gram import verify
from repro_torch.gram.verify import (VerificationError, check_packed_state,
                                     freivalds_gram, verify_gram)
from repro_torch.obs import trace


@pytest.fixture
def a():
    return np.random.default_rng(0).standard_normal((40, 24)) \
        .astype(np.float32)


@pytest.fixture
def tracer():
    """A recording tracer of the port's, for one test."""
    old = trace.get_tracer()
    rec = trace.set_tracer(trace.Tracer(enabled=True))
    yield rec
    trace.set_tracer(old)


def _gram(a):
    a64 = a.astype(np.float64)
    return a64.T @ a64


def _as(form, x):
    """``x`` as the port's guards may receive it."""
    if form == "numpy":
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


FORMS = ["numpy", "tensor"]


def _same_verdict(port, ref):
    assert (port.ok, port.finite, port.diag_ok, port.freivalds_ok,
            port.probes) == (ref.ok, ref.finite, ref.diag_ok,
                             ref.freivalds_ok, ref.probes)
    assert port.max_rel_err == pytest.approx(ref.max_rel_err, rel=1e-9)
    assert port.reason() == ref.reason()


def _check(form, a, c, **kw):
    port = verify_gram(_as(form, a), _as(form, c), **kw)
    _same_verdict(port, jax_verify.verify_gram(a, c, **kw))
    return port


@pytest.mark.parametrize("form", FORMS)
def test_correct_gram_passes(form, a):
    v = _check(form, a, _gram(a), probes=4)
    assert v.ok and v.finite and v.diag_ok and v.freivalds_ok
    assert v.probes == 4 and v.reason() == "ok"


@pytest.mark.parametrize("form", FORMS)
def test_tril_only_gram_passes(form, a):
    assert _check(form, a, np.tril(_gram(a)), probes=4, full=False).ok


@pytest.mark.parametrize("form", FORMS)
def test_rows_gram_identity(form, a):
    a64 = a.astype(np.float64)
    assert _check(form, a, a64 @ a64.T, probes=4, gram_of="rows").ok


@pytest.mark.parametrize("form", FORMS)
def test_nan_caught_and_skips_probes(form, a, tracer):
    c = _gram(a)
    c[3, 5] = np.nan
    v = _check(form, a, c, probes=4)
    assert not v.ok and not v.finite
    assert v.probes == 0, "probes must not run over NaN data"
    assert "non-finite" in v.reason()
    (ev,) = [e for e in tracer.events() if e.name == "verify_veto"]
    assert ev.attrs == {"reason": "non_finite"}


@pytest.mark.parametrize("form", FORMS)
def test_negative_diagonal_caught(form, a, tracer):
    c = _gram(a)
    c[2, 2] = -abs(c).max()
    v = _check(form, a, c, probes=0)
    assert not v.ok and v.finite and not v.diag_ok
    assert "diagonal" in v.reason()
    assert [e.attrs["reason"] for e in tracer.events()] == \
        ["negative_diagonal"]


@pytest.mark.parametrize("form", FORMS)
def test_freivalds_catches_finite_silent_corruption(form, a, tracer):
    c = _gram(a)
    c[7, 3] += 0.5 * abs(c).max()
    c[3, 7] = c[7, 3]
    passed, err = freivalds_gram(_as(form, a), _as(form, c), probes=4)
    assert (passed, err) == pytest.approx(jax_verify.freivalds_gram(
        a, c, probes=4))
    assert not passed and err > 1e-3
    v = _check(form, a, c, probes=4)
    assert not v.ok and "freivalds" in v.reason()
    assert [e.attrs["reason"] for e in tracer.events()] == ["freivalds"]


def test_freivalds_probabilistic_bound(a):
    c = _gram(a)
    c[5, 9] += abs(c).max()
    c[9, 5] = c[5, 9]
    hits = [not freivalds_gram(a, c, probes=1,
                               rng=np.random.default_rng(t))[0]
            for t in range(64)]
    want = [not jax_verify.freivalds_gram(
        a, c, probes=1, rng=np.random.default_rng(t))[0] for t in range(64)]
    assert hits == want
    assert sum(hits) >= 32, f"detected {sum(hits)}/64 < the 1/2 bound"


@pytest.mark.parametrize("form", FORMS)
def test_zero_matrix_passes(form):
    z = np.zeros((8, 6), np.float32)
    assert _check(form, z, np.zeros((6, 6)), probes=2).ok


@pytest.mark.parametrize("form", FORMS)
def test_shape_mismatch_rejected(form, a):
    with pytest.raises(ValueError):
        freivalds_gram(_as(form, a), _as(form, np.zeros((5, 5))))


def test_default_rtol_by_dtype():
    for dt in (np.float32, np.float64, "bfloat16", np.float16,
               "float8_e4m3fn", "float8_e5m2", "float32"):
        assert verify.default_rtol(dt) == jax_verify.default_rtol(dt)
    for dt, name in ((torch.float32, "float32"), (torch.float64, "float64"),
                     (torch.bfloat16, "bfloat16"), (torch.float16, "float16"),
                     (torch.float8_e4m3fn, "float8_e4m3fn"),
                     (torch.float8_e5m2, "float8_e5m2")):
        assert verify.default_rtol(dt) == jax_verify.default_rtol(name)
    assert verify.default_rtol(torch.float32) == pytest.approx(1e-4)
    assert verify.default_rtol(torch.float8_e5m2) == pytest.approx(5e-1)


def test_tensor_dtype_sets_the_default_tolerance(a):
    """A bf16 tensor is probed at bf16's tolerance, as a bf16 array
    would be: a Gram 1 % off passes there and fails at fp32's."""
    c = _gram(a) * 1.01
    ab = torch.from_numpy(a).to(torch.bfloat16)
    assert verify_gram(ab, c, probes=4).ok
    assert not verify_gram(torch.from_numpy(a), c, probes=4).ok


@pytest.mark.parametrize("form", FORMS)
def test_check_packed_state_ok_and_corrupt(form, a, tracer):
    packed = np.asarray(pack_tril(_gram(a)))
    check_packed_state(_as(form, packed), 24)
    bad = packed.copy()
    bad[10] = np.inf
    with pytest.raises(VerificationError, match="non-finite"):
        check_packed_state(_as(form, bad), 24)
    r = 5
    bad2 = packed.copy()
    bad2[r * (r + 3) // 2] = -1e6
    with pytest.raises(VerificationError, match="negative diagonal"):
        check_packed_state(_as(form, bad2), 24)
    ok = packed.copy()
    ok[r * (r + 3) // 2 - 1] = -1e6
    check_packed_state(_as(form, ok), 24)
    assert [(e.attrs["reason"], e.attrs["where"]) for e in
            tracer.events()] == [("non_finite", "stream"),
                                 ("negative_diagonal", "stream")]
