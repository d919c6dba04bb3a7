"""The port's leaf-program IR against the JAX package's.

Same programs (counts and lowered tables, bit for bit), same
registration errors, and tables carried across with
``import_algebras``.  Registrations go into the port's registry only:
the JAX registry is read, never written, since other test files
enumerate it.
"""
import numpy as np
import pytest

from repro.core import leaf_ir as jax_ir
from repro.kernels import strassen_fused as jax_sf
from repro_torch.core import leaf_ir
from repro_torch.kernels import strassen_fused as sf

VARIANTS = ("strassen", "winograd", "classical")
GRAMS = ("strassen", "dps")
LEVELS = (0, 1, 2, 3)


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("gram", GRAMS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_ata_program_and_tables_match_jax(variant, gram, levels):
    ours = leaf_ir.compile_program("ata", levels, variant, gram=gram)
    ref = jax_ir.compile_program("ata", levels, variant, gram=gram)
    assert ours.blocks == ref.blocks
    assert ours.max_terms == ref.max_terms
    assert ours.max_contributions == ref.max_contributions
    assert ours.n_dests() == ref.n_dests()
    got = sf._program_tables("ata", levels, variant, gram)
    want = jax_sf._program_tables("ata", levels, variant, gram)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_registry_errors_match_jax():
    with pytest.raises(ValueError):
        leaf_ir.get_algebra("nope")
    with pytest.raises(ValueError):
        leaf_ir.register_algebra("strassen", leaf_ir.get_algebra("strassen"))
    with pytest.raises(ValueError):
        leaf_ir.compile_program("gemm", 1)
    with pytest.raises(ValueError):
        leaf_ir.compile_program("ata", 1, trans_a=True)
    with pytest.raises(ValueError):
        leaf_ir.compile_program("matmul", -1)


@pytest.mark.parametrize("table,match", [
    ((), "non-empty"),
    ((((), ((0, 0, 1),), ((0, 0, 1),)),), "empty a_quads"),
    (((((0, 0, 1),), ((0, 0, 1),)),), r"\(a, b, dest\) triple"),
    (((((0, 0),), ((0, 0, 1),), ((0, 0, 1),)),), r"\(row, col, coeff\)"),
    (((((0, 0, 0),), ((0, 0, 1),), ((0, 0, 1),)),), "nonzero finite real"),
    (tuple((((i, j, 1),), ((j, kq, 1),), ((i, kq, 2),))
           for i in range(2) for j in range(2) for kq in range(2)),
     "identity"),
])
def test_register_algebra_rejects_malformed_tables(table, match):
    """The cases and messages of tests/test_leaf_ir.py, on the port."""
    with pytest.raises(ValueError, match=match):
        leaf_ir.register_algebra("bad-torch-test", table)
    assert "bad-torch-test" not in leaf_ir.registered_algebras()


def _bad_grams(base):
    wrong_sym = ((((0, 0, 2),), ((0, 0, 1, 0),)),) + base["sym"][1:]
    return [
        (dict(sym=(((), ((0, 0, 1, 0),)),), mm=base["mm"]),
         "empty term list"),
        (dict(sym=((((0, 0),), ((0, 0, 1, 0),)),), mm=base["mm"]),
         r"\(g, o, coeff\)"),
        (dict(sym=((((0, 0, 1),), ((0, 0, 1),)),), mm=base["mm"]),
         r"\(di, dj, coeff, trans\)"),
        (dict(sym=((((0, 0, 1),), ((0, 1, 1, 0),)),), mm=base["mm"]),
         "lower triangle"),
        (dict(sym=((((0, 0, 1),), ((1, 0, 1, 1),)),), mm=base["mm"]),
         "sym dest"),
        (dict(sym=base["sym"], mm=()), "at least one mm"),
        (dict(sym=(), mm=base["mm"]), "at least one sym"),
        (dict(sym=wrong_sym, mm=base["mm"]), "identity"),
    ]


@pytest.mark.parametrize("case", range(8))
def test_register_gram_algebra_validation(case):
    """The cases and messages of tests/test_leaf_ir.py, on the port."""
    kw, match = _bad_grams(leaf_ir.get_gram_algebra("strassen"))[case]
    with pytest.raises(ValueError, match=match):
        leaf_ir.register_gram_algebra("bad-gram-torch-test", **kw)
    assert "bad-gram-torch-test" not in leaf_ir.registered_gram_algebras()
    with pytest.raises(ValueError, match="already registered"):
        leaf_ir.register_gram_algebra(
            "strassen", **leaf_ir.get_gram_algebra("strassen"))


@pytest.mark.parametrize("levels", [1, 2])
def test_import_algebras_round_trip(levels):
    """JAX entries registered in the port under new names lower to the
    same tables, bit for bit, as the JAX package's own."""
    leaf_ir.import_algebras(
        {"winograd-from-jax": jax_ir.get_algebra("winograd")},
        {"dps-from-jax": jax_ir.get_gram_algebra("dps")},
        dims={"winograd-from-jax": jax_ir.algebra_dims("winograd")},
        overwrite=True)
    assert leaf_ir.algebra_dims("winograd-from-jax") == (2, 2, 2)
    got = sf._program_tables("ata", levels, "winograd-from-jax",
                             "dps-from-jax")
    want = jax_sf._program_tables("ata", levels, "winograd", "dps")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert "winograd-from-jax" not in jax_ir.registered_algebras()


def test_reregistration_invalidates_lowered_tables():
    sf._program_tables("ata", 1, "strassen")
    sf._device_tables("ata", 1, "strassen", "strassen", "cpu")
    assert sf._program_tables.cache_info().currsize > 0
    assert sf._device_tables.cache_info().currsize > 0
    leaf_ir.register_algebra("strassen", leaf_ir.get_algebra("strassen"),
                             overwrite=True)
    assert sf._program_tables.cache_info().currsize == 0
    assert sf._device_tables.cache_info().currsize == 0
