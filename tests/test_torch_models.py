"""All 29 registry families of the port vs the JAX package's, on the CPU.

- both flattens (``flatten_nest``, which picks the affine or the quad
  form, and ``flatten_nest_quad`` itself) give field-for-field equal
  ``FlatRef``s, and both refuse the same nests;
- ``pluss_torch.engine.run(device="cpu")`` equals ``pluss.engine.run``
  exactly at n=16 with the reference's four threads (the rectangular
  families here, the bounded ones in tests/test_torch_models_bounded.py),
  and conserves accesses;
- ``python -m pluss_torch.cli acc --cpu`` prints the JAX CLI's block below
  the banner for bounded, varying-start and quad families.

Specs are built by the JAX package and carried into the port through its
codec JSON.
"""

import dataclasses

import numpy as np
import pytest

from pluss import cli as jax_cli
from pluss import engine as jax_engine
from pluss import models as jax_models
from pluss import spec as jax_spec
from pluss.spec_codec import spec_to_json as jax_spec_to_json
from pluss_torch import cli, engine, spec
from pluss_torch.models import REGISTRY
from pluss_torch.spec_codec import spec_from_json


def carried(model: str, n: int):
    return spec_from_json(jax_spec_to_json(jax_models.REGISTRY[model](n)))


def test_registry_is_the_jax_registry():
    assert sorted(REGISTRY) == sorted(jax_models.REGISTRY)
    assert len(REGISTRY) == 29
    assert BOUNDED == ["cholesky", "correlation", "covariance", "durbin",
                       "gramschmidt", "lu", "ludcmp", "symm", "syrk_tri",
                       "trisolv", "trmm"]


def flattened(mod, nest, fn):
    """``[FlatRef as data]`` of ``mod.<fn>(nest)``, or the error's type
    name and code when the flatten refuses the nest."""
    try:
        return [dataclasses.asdict(f) for f in getattr(mod, fn)(nest)]
    except ValueError as e:
        return (type(e).__name__, getattr(e, "code", None))


@pytest.mark.parametrize("model", sorted(REGISTRY))
def test_flatten_matches_jax(model):
    for n in (13, 16):
        for jn, tn in zip(jax_models.REGISTRY[model](n).nests,
                          carried(model, n).nests):
            for fn in ("flatten_nest", "flatten_nest_quad"):
                assert flattened(spec, tn, fn) == \
                    flattened(jax_spec, jn, fn), (n, fn)
            assert spec.nest_iteration_size(tn) == \
                jax_spec.nest_iteration_size(jn)
            assert spec.nest_is_quad(tn) == jax_spec.nest_is_quad(jn)


#: families with a bounded, varying-start or quad nest
BOUNDED = sorted(m for m in REGISTRY if any(
    spec.nest_has_bounds(n) or spec.nest_has_varying_start(n)
    for n in REGISTRY[m](16).nests))


def assert_run_matches_jax(model):
    want = jax_engine.run(jax_models.REGISTRY[model](16))
    got = engine.run(carried(model, 16), device="cpu")
    assert got.max_iteration_count == want.max_iteration_count
    np.testing.assert_array_equal(got.noshare_dense, want.noshare_dense)
    assert got.share_raw == want.share_raw
    # conservation: every access is one no-share event, one cold miss or
    # one share event
    total = int(got.noshare_dense.sum()) + sum(
        sum(d.values()) for d in got.share_raw)
    assert total == got.max_iteration_count
    return got, want


@pytest.mark.parametrize("model", sorted(set(REGISTRY) - set(BOUNDED)))
def test_run_matches_jax(model):
    assert_run_matches_jax(model)


def block(text: str) -> list[str]:
    """The lines of the first acc block below its banner."""
    lines = text.splitlines()
    assert lines[0].split(":")[0] in ("TPU VMAP", "TORCH CPU")
    return lines[1:lines.index("max iteration traversed") + 2]


@pytest.mark.parametrize("model", ["cholesky", "trmm", "syrk_tri", "durbin"])
def test_acc_block_matches_jax_cli(model, capsys):
    """``pluss.cli acc`` prints one block per backend, the vmap one first;
    the port's vmap block equals it below the banner."""
    jax_cli.main(["acc", "--cpu", "--backends", "vmap", "--model", model,
                  "--n", "16"])
    want = capsys.readouterr().out
    assert cli.main(["acc", "--cpu", "--backends", "vmap", "--model", model,
                     "--n", "16"]) == 0
    got = capsys.readouterr().out
    assert got.startswith("TORCH CPU: ")
    assert block(got) == block(want)
    assert got.splitlines()[1:] == block(got) + [""]
