"""The port's subset sampler vs ``pluss.sampling``, on the CPU.

``pluss_torch.sampling.sampled_run`` equals ``pluss.sampling.sampled_run``
for the same seed: the same windows (one numpy generator), the same
integer histograms and share counts, the same float64 scaling and
``sampled_fraction`` (compared to rtol 1e-12; they come out exact).
Uniform and prefix modes, context 0, 1 and auto, a bounded nest, two
seeds and the rate-1 exact case; ``mrc_error_table`` and its MRC L2
errors; the same errors for bad rates and modes; the budget guard.
"""

import numpy as np
import pytest

from pluss import engine as jax_engine
from pluss import models as jax_models
from pluss import sampling as jax_sampling
from pluss.config import SamplerConfig as JaxConfig
from pluss.spec_codec import spec_to_json as jax_spec_to_json
from pluss_torch import engine, sampling
from pluss_torch.config import SamplerConfig
from pluss_torch.spec_codec import spec_from_json


def carried(js):
    return spec_from_json(jax_spec_to_json(js))


def assert_same_estimate(got, want):
    assert got.max_iteration_count == want.max_iteration_count
    assert got.noshare_dense.dtype == np.float64
    np.testing.assert_allclose(got.noshare_dense, want.noshare_dense,
                               rtol=1e-12, atol=0)
    for a, b in zip(got.share_raw, want.share_raw):
        assert sorted(a) == sorted(b)
        np.testing.assert_allclose([a[k] for k in sorted(a)],
                                   [b[k] for k in sorted(b)], rtol=1e-12)
    np.testing.assert_allclose(got.sampled_fraction, want.sampled_fraction,
                               rtol=1e-12)


@pytest.mark.parametrize("model,n,kw,rk", [
    ("gemm", 32, {}, {"rate": 0.5, "window_accesses": 1 << 12}),
    ("gemm", 32, {}, {"rate": 0.25, "window_accesses": 1 << 12,
                      "context_windows": 0, "seed": 3}),
    ("gemm", 32, {}, {"rate": 0.25, "window_accesses": 1 << 12,
                      "context_windows": 1, "seed": 1}),
    ("gemm", 32, {"chunk_size": 2}, {"rate": 0.5, "window_accesses": 1,
                                     "context_windows": 3, "seed": 1}),
    ("gemm", 32, {"chunk_size": 2}, {"rate": 0.75, "window_accesses": 1,
                                     "seed": 2}),
    ("gemm", 32, {}, {"rate": 0.5, "window_accesses": 1 << 12,
                      "mode": "prefix"}),
    ("gemm", 32, {"cls": 8}, {"rate": 0.1, "window_accesses": 1 << 12,
                              "mode": "prefix"}),
    ("cholesky", 24, {}, {"rate": 0.5, "window_accesses": 1}),
    ("cholesky", 24, {}, {"rate": 0.4, "window_accesses": 1,
                          "mode": "prefix"}),
    ("mvt", 32, {"thread_num": 3}, {"rate": 0.5, "window_accesses": 1,
                                    "seed": 7}),
])
def test_sampled_run_matches_jax(model, n, kw, rk):
    js = jax_models.REGISTRY[model](n)
    want = jax_sampling.sampled_run(js, JaxConfig(**kw), **rk)
    got = sampling.sampled_run(carried(js), SamplerConfig(**kw),
                               device="cpu", **rk)
    assert_same_estimate(got, want)
    assert 0 < got.sampled_fraction


def test_rate_one_single_window_is_exact():
    """NW == 1: the sample is the whole stream, so the estimate is the
    full run's histogram."""
    js = jax_models.REGISTRY["gemm"](16)
    spec, cfg = carried(js), SamplerConfig(cls=8)
    full = engine.run(spec, cfg, device="cpu")
    est = sampling.sampled_run(spec, cfg, rate=1.0, device="cpu")
    np.testing.assert_array_equal(est.noshare_dense, full.noshare_dense)
    assert est.share_raw == full.share_raw
    assert est.sampled_fraction == full.sampled_fraction == 1.0
    assert_same_estimate(est, jax_sampling.sampled_run(js, JaxConfig(cls=8),
                                                       rate=1.0))


def test_full_rate_with_context_equals_the_full_run():
    js = jax_models.REGISTRY["gemm"](32)
    est = sampling.sampled_run(carried(js), rate=1.0,
                               window_accesses=1 << 12, context_windows=7,
                               device="cpu")
    np.testing.assert_allclose(est.noshare_dense,
                               jax_engine.run(js).noshare_dense.astype(float))


@pytest.mark.parametrize("mode,seed", [("uniform", 0), ("prefix", 3)])
def test_mrc_error_table_matches_jax(mode, seed):
    js = jax_models.REGISTRY["gemm"](32)
    kw = {"rates": (0.25, 0.5, 1.0), "seed": seed,
          "window_accesses": 1 << 12, "mode": mode}
    want = jax_sampling.mrc_error_table(js, JaxConfig(), **kw)
    got = sampling.mrc_error_table(carried(js), SamplerConfig(),
                                   device="cpu", **kw)
    assert [r for r, _, _ in got] == [r for r, _, _ in want]
    np.testing.assert_allclose([f for _, f, _ in got],
                               [f for _, f, _ in want], rtol=1e-12)
    np.testing.assert_allclose([e for _, _, e in got],
                               [e for _, _, e in want], rtol=1e-12,
                               atol=1e-15)
    if mode == "prefix":
        assert got[-1][2] == 0.0     # rate 1: the whole chain, exact


def test_mrc_l2_error():
    a = np.array([1.0, 0.5, 0.25])
    assert sampling.mrc_l2_error(a, a) == 0.0
    assert sampling.mrc_l2_error(a, np.array([1.0, 0.5])) == \
        jax_sampling.mrc_l2_error(a, np.array([1.0, 0.5]))


@pytest.mark.parametrize("kw", [{"rate": 0.0}, {"rate": 1.5},
                                {"rate": -0.1}, {"mode": "stratified"}])
def test_bad_arguments_raise_the_same_error(kw):
    with pytest.raises(ValueError) as want:
        jax_sampling.sampled_run(jax_models.REGISTRY["gemm"](16), **kw)
    with pytest.raises(ValueError) as got:
        sampling.sampled_run(carried(jax_models.REGISTRY["gemm"](16)),
                             device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_budget_guard(monkeypatch):
    spec = carried(jax_models.REGISTRY["gemm"](32))
    monkeypatch.setattr(sampling, "sort_budget", lambda dev: 1 << 10)
    with pytest.raises(RuntimeError, match="device budget"):
        sampling.sampled_run(spec, rate=0.5, window_accesses=1 << 12,
                             device="cpu")
    # prefix mode walks one chain, as in the JAX package: no fan-out guard
    sampling.sampled_run(spec, rate=0.5, window_accesses=1 << 12,
                         mode="prefix", device="cpu")


def test_context_walks_bin_nothing(monkeypatch):
    """A context walk only advances the carried table: the histogram
    function runs once per counted window."""
    calls = []
    real = sampling.event_histogram

    def counting(*args):
        calls.append(1)
        return real(*args)

    spec, cfg = carried(jax_models.REGISTRY["gemm"](32)), \
        SamplerConfig(chunk_size=2)
    est = sampling.sampled_run(spec, cfg, rate=0.5, window_accesses=1,
                               context_windows=2, seed=1, device="cpu",
                               _event_hist=counting)
    assert sampling._plan_cached(spec, cfg, 1).nests[0].n_windows == 4
    assert len(calls) == 2
    assert est.sampled_fraction > 0.5
