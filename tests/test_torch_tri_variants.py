"""Bounded, varying-start and quad families of the port vs the JAX
package's across thread counts and line sizes, on the CPU, exactly (the
other triangular cases: tests/test_torch_triangular.py)."""

import pytest

from tests.test_torch_triangular import run_both

VARIANTS = [{"thread_num": 1}, {"thread_num": 2}, {"cls": 8},
            {"thread_num": 2, "cls": 8}]


@pytest.mark.parametrize("kw", VARIANTS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
@pytest.mark.parametrize("model", ["cholesky", "lu", "trmm", "symm",
                                   "durbin", "syrk_tri"])
def test_run_matches_jax_variants(model, kw):
    run_both(model, 16, kw)
