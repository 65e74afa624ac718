"""The port's static prediction (``analysis.ri``) vs the JAX package's, and
vs the port's own engine, on the CPU.

- ``ri.predict`` and ``ri.report_doc`` equal JAX's for all 29 families at
  n=16: method, period horizon, per-thread noshare/share histograms,
  access count, the composed curve, the exact plateau, and the report
  document as JSON text;
- every derivable family's prediction is bit-identical to the port's
  ``engine.run(device="cpu")`` (``check_against_engine``: histograms ``==``
  and, since CRI sums in sorted key order, the MRC too);
- the budget refusal (PL702) under a small ``PLUSS_PREDICT_BUDGET``;
- ``engine.DEVICE_DISPATCHES`` stays put across ``predict``, and counts
  engine runs as the JAX package counts them.
"""

import json

import numpy as np
import pytest

from pluss import models as jax_models
from pluss.analysis import ri as jax_ri
from pluss.config import SamplerConfig as JaxConfig
from pluss.spec_codec import spec_to_json as jax_spec_to_json
from pluss_torch import engine
from pluss_torch.analysis import ri
from pluss_torch.config import SamplerConfig
from pluss_torch.models import REGISTRY
from pluss_torch.spec_codec import spec_from_json

MODELS = sorted(REGISTRY)


def carried(model: str, n: int):
    return spec_from_json(jax_spec_to_json(jax_models.REGISTRY[model](n)))


def pred_fields(p):
    return (p.model, p.thread_num, p.derivable, p.method, p.periods,
            p.noshare, p.share, p.accesses,
            [(d.code, d.severity.name, d.message) for d in p.diagnostics])


@pytest.mark.parametrize("cfg_kw", [{}, {"thread_num": 2, "chunk_size": 8}])
@pytest.mark.parametrize("model", MODELS)
def test_predict_matches_jax(model, cfg_kw):
    jrep = jax_ri.predict(jax_models.REGISTRY[model](16), JaxConfig(**cfg_kw))
    rep = ri.predict(carried(model, 16), SamplerConfig(**cfg_kw))
    assert pred_fields(rep.prediction) == pred_fields(jrep.prediction)
    assert rep.rihist == jrep.rihist
    assert (rep.curve is None) == (jrep.curve is None)
    if rep.curve is not None:
        assert np.array_equal(rep.curve, jrep.curve)
    assert (rep.plateau, rep.plateau_in_bracket) == \
        (jrep.plateau, jrep.plateau_in_bracket)
    assert json.dumps(ri.report_doc(rep)) == \
        json.dumps(jax_ri.report_doc(jrep))


@pytest.mark.parametrize("model", MODELS)
def test_prediction_bit_identical_to_port_engine(model):
    spec, cfg = carried(model, 16), SamplerConfig()
    rep = ri.predict(spec, cfg)
    assert rep.prediction.derivable, rep.prediction.diagnostics
    res = engine.run(spec, cfg, device="cpu")
    ok, detail = ri.check_against_engine(rep, res, cfg)
    assert ok, detail
    assert detail["histogram_identical"] and detail["mrc_exact"]
    assert detail["mrc_l2_error"] == 0.0


def test_check_against_engine_flags_a_wrong_histogram():
    spec, cfg = carried("gemm", 16), SamplerConfig()
    rep = ri.predict(spec, cfg)
    res = engine.run(spec, cfg, device="cpu")
    res.noshare_dense[0, 1] += 1
    ok, detail = ri.check_against_engine(rep, res, cfg)
    assert not ok and not detail["histogram_identical"]


@pytest.mark.parametrize("model", ["lu", "mvt", "cholesky"])
def test_budget_refusal_pl702(model, monkeypatch):
    monkeypatch.setenv("PLUSS_PREDICT_BUDGET", "16")
    rep = ri.predict(carried(model, 16), SamplerConfig())
    jrep = jax_ri.predict(jax_models.REGISTRY[model](16), JaxConfig())
    assert not rep.prediction.derivable
    assert [d.code for d in rep.prediction.diagnostics] == ["PL702"]
    assert pred_fields(rep.prediction) == pred_fields(jrep.prediction)
    assert json.dumps(ri.report_doc(rep)) == \
        json.dumps(jax_ri.report_doc(jrep))


def test_predict_makes_no_device_dispatch(monkeypatch):
    monkeypatch.setattr(engine, "run", lambda *a, **k: pytest.fail(
        "the predict path called engine.run"))
    before = engine.DEVICE_DISPATCHES
    for model in ("gemm", "lu"):        # closed-form rung, dense rung
        assert ri.predict(carried(model, 16)).prediction.derivable
    assert engine.DEVICE_DISPATCHES == before


def test_device_dispatches_count_as_jax_counts(monkeypatch):
    """One per run that is not rerouted; a rerouted run and a direct
    ``run_sliced`` count nothing (``pluss/engine.py``)."""
    spec = carried("gemm", 16)
    before = engine.DEVICE_DISPATCHES
    engine.run(spec, device="cpu")
    assert engine.DEVICE_DISPATCHES == before + 1
    engine.run_sliced(spec, device="cpu", thread_batch=1)
    assert engine.DEVICE_DISPATCHES == before + 1
    monkeypatch.setattr(engine, "_auto_dispatch",
                        lambda *a, **k: (1, "forced for the test"))
    engine.run(spec, device="cpu")
    assert engine.DEVICE_DISPATCHES == before + 1
