"""The port's static schedule search (``analysis.tune``) vs the JAX
package's, on the CPU.

- ``tune`` reports for gemm, mvt and syrk at n=16: the verdict, the
  diagnostics and the whole report document (every candidate's floor,
  bracket, score, prune), equal as JSON text, over the default grid and
  a narrower one with a window axis;
- the tuner's telemetry: the ``tune.search`` span and the
  ``tune.{pruned,derived,memo_hits}`` counters, as JAX counts them;
- ``check_winner`` on the CPU: the winner's engine run verifies;
- every candidate label and document prints JAX's default share cap,
  though the port's search has no share-cap axis (its engine has no cap).
"""

import json

import pytest

from pluss import models as jax_models
from pluss import obs as jax_obs
from pluss.analysis import tune as jax_tune
from pluss.spec_codec import spec_to_json as jax_spec_to_json
from pluss_torch import engine, obs
from pluss_torch.analysis import tune
from pluss_torch.config import SHARE_CAP
from pluss_torch.spec_codec import spec_from_json


def carried(model: str, n: int):
    return spec_from_json(jax_spec_to_json(jax_models.REGISTRY[model](n)))


GRIDS = {
    "default": {},
    "window": {"candidates_of": lambda mod: mod.space(
        (1, 2, 4), (1, 4, 16), (None, 64))},
}


def report_pair(model, grid):
    kw = GRIDS[grid]
    jkw = {"candidates": kw["candidates_of"](jax_tune)} if kw else {}
    tkw = {"candidates": kw["candidates_of"](tune)} if kw else {}
    want = jax_tune.tune(jax_models.REGISTRY[model](16), **jkw)
    got = tune.tune(carried(model, 16), **tkw)
    return got, want


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("model", ["gemm", "mvt", "syrk"])
def test_tune_report_matches_jax(model, grid):
    got, want = report_pair(model, grid)
    assert got.code == want.code
    assert [(d.code, d.severity.name, d.message) for d in got.diagnostics] \
        == [(d.code, d.severity.name, d.message) for d in want.diagnostics]
    assert json.dumps(got.doc(), indent=1) == \
        json.dumps(want.doc(), indent=1)
    assert got.winner.candidate.label() == want.winner.candidate.label()


def test_candidate_labels_carry_jax_share_cap():
    assert SHARE_CAP == jax_tune.SHARE_CAP == 1024
    assert [c.label() for c in tune.space()] == \
        [c.label() for c in jax_tune.space()]


def test_tune_telemetry_matches_jax(tmp_path):
    spec, jspec = carried("mvt", 16), jax_models.REGISTRY["mvt"](16)
    obs.configure(str(tmp_path / "t.jsonl"))
    jax_obs.configure(str(tmp_path / "j.jsonl"))
    try:
        tune.tune(spec)
        jax_tune.tune(jspec)
        names = ("tune.pruned", "tune.derived", "tune.memo_hits")
        got = {k: v for k, v in obs.counters().items() if k in names}
        want = {k: v for k, v in jax_obs.counters().items() if k in names}
        assert got == want and got
    finally:
        obs.shutdown()
        jax_obs.shutdown()
    spans = [json.loads(l) for l in open(tmp_path / "t.jsonl")]
    assert any(r.get("name") == "tune.search" for r in spans)
    assert any(r.get("name") == "ri.derive" for r in spans)


@pytest.mark.parametrize("model", ["gemm", "mvt"])
def test_check_winner_on_the_cpu(model):
    spec = carried(model, 16)
    rep = tune.tune(spec, candidates=tune.space((1, 2, 4), (1, 4)))
    before = engine.DEVICE_DISPATCHES
    ok, detail, diags = tune.check_winner(spec, rep, device="cpu")
    assert ok, detail
    assert detail["histogram_identical"] and detail["mrc_exact"]
    assert diags == []
    assert engine.DEVICE_DISPATCHES == before + 1


def test_check_winner_refuses_a_refused_report(monkeypatch):
    monkeypatch.setenv("PLUSS_PREDICT_BUDGET", "16")
    rep = tune.tune(carried("lu", 16))
    assert rep.code == "PL903" and rep.winner is None
    with pytest.raises(ValueError, match="no winner"):
        tune.check_winner(carried("lu", 16), rep, device="cpu")
