"""The port's co-tenancy composition (``analysis.interference``) vs the
JAX package's, on the CPU.

- ``from_models`` + ``compose`` for gemm+syrk (and a three-way mix):
  verdicts, composed and merged histograms, solo and degraded curves,
  and the report document as JSON text;
- ``check_against_oracle``: the host stack-distance oracle's curves and
  the verdict document equal JAX's;
- refusals (PL803): a workload the predictor refuses under a small
  ``PLUSS_PREDICT_BUDGET``, and a non-positive access rate.
"""

import json

import numpy as np
import pytest

from pluss.analysis import interference as jax_itf
from pluss.config import SamplerConfig as JaxConfig
from pluss_torch.analysis import interference as itf
from pluss_torch.config import SamplerConfig

CFGS = [{}, {"thread_num": 2, "chunk_size": 2, "cache_kb": 4}]


def pair(names, cfg_kw, **kw):
    got = itf.analyze_models(names, SamplerConfig(**cfg_kw), 16, **kw)
    want = jax_itf.analyze_models(names, JaxConfig(**cfg_kw), 16, **kw)
    return got, want


def same_report(got, want):
    assert json.dumps(got.doc(), indent=1) == \
        json.dumps(want.doc(), indent=1)
    assert got.composed == want.composed and got.merged == want.merged
    for a, b in zip(got.solo_curves + got.degraded_curves,
                    want.solo_curves + want.degraded_curves,
                    strict=True):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("cfg_kw", CFGS)
@pytest.mark.parametrize("names", [["gemm", "syrk"],
                                   ["gemm", "mvt", "atax"]])
def test_compose_matches_jax(names, cfg_kw):
    got, want = pair(names, cfg_kw)
    assert not got.refused and len(got.verdicts) == len(names)
    same_report(got, want)


@pytest.mark.parametrize("cfg_kw", CFGS)
def test_check_against_oracle_matches_jax(cfg_kw):
    cfg, jcfg = SamplerConfig(**cfg_kw), JaxConfig(**cfg_kw)
    inputs, _ = itf.from_models(["gemm", "syrk"], cfg, 16)
    jinputs, _ = jax_itf.from_models(["gemm", "syrk"], jcfg, 16)
    for a, b in zip(itf.oracle_mrcs(inputs, cfg),
                    jax_itf.oracle_mrcs(jinputs, jcfg), strict=True):
        assert np.array_equal(a, b)
    ok, detail = itf.check_against_oracle(itf.compose(inputs, cfg),
                                          inputs, cfg)
    jok, jdetail = jax_itf.check_against_oracle(
        jax_itf.compose(jinputs, jcfg), jinputs, jcfg)
    assert ok == jok
    assert json.dumps(detail) == json.dumps(jdetail)


def test_refused_pair_pl803(monkeypatch):
    # gemm (16896 lattice cells) fits the budget; lu (30480) does not
    monkeypatch.setenv("PLUSS_PREDICT_BUDGET", "20000")
    got, want = pair(["gemm", "lu"], {})
    assert got.refused and got.verdicts == []
    assert [d.code for d in got.diagnostics] == ["PL803"]
    same_report(got, want)


def test_nonpositive_rate_pl803():
    got, want = pair(["gemm", "syrk"], {"thread_num": 2, "chunk_size": 2},
                     rates=[0.0, 1.0])
    assert got.refused and [d.code for d in got.diagnostics] == ["PL803"]
    same_report(got, want)
