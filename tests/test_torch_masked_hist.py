"""The port's masked event histogram vs the JAX package's.

``masked_histogram_plain`` (the reference of the CUDA kernel in
``pluss_torch/csrc/masked_hist.cu``) must equal both JAX forms of
``reuse.event_histogram``'s epilogue: the Pallas kernel
(``pallas_events.fused_event_histogram``, run in interpret mode as
tests/test_pallas_events.py runs it) and the XLA path (the Pallas switch
off), with ``include_cold`` both ways.  int64 reuse, which the JAX package
always sends to XLA, is compared with the XLA path (x64 is on in
conftest).  Events come from the JAX package's own ``batch_events`` on
seeded streams, and from seeded random masks; counts are integers, so
every comparison is exact.
"""

import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pluss.ops import pallas_events
from pluss.ops import reuse as jr
from pluss_torch.ops import event_hist
from pluss_torch.ops.event_hist import (masked_histogram,
                                        masked_histogram_plain)


@pytest.fixture
def xla_only(monkeypatch):
    """The JAX package's XLA epilogue: the Pallas switch forced off."""
    monkeypatch.setenv("PLUSS_PALLAS_EVENTS", "0")
    pallas_events.reset_probe()
    yield
    pallas_events.reset_probe()


def trace_events(seed, n=6000, n_lines=400, pdt=np.int32):
    """The JAX ``batch_events`` of a seeded stream slice resolved against a
    carried table (some lines touched before, some never), as numpy."""
    rng = np.random.default_rng(seed)
    base = 50_000
    line = rng.integers(0, n_lines, n).astype(np.int32)
    pos = (base + np.arange(n)).astype(pdt)
    valid = pos < base + n - 123          # a ragged invalid tail
    last_pos = np.where(rng.random(n_lines) < 0.5, -1,
                        rng.integers(0, base, n_lines)).astype(pdt)
    ev, _ = jr.batch_events(jnp.asarray(line), jnp.asarray(pos),
                            jnp.asarray(valid), jnp.asarray(last_pos))
    return {k: np.array(ev[k]) for k in ("reuse", "is_evt", "share",
                                         "cold")}


def random_events(seed, n=5000, wide=False):
    """Seeded masks and reuses, including reuses <= 0 and (int64) reuses
    whose bins reach past NBINS and weigh nothing."""
    rng = np.random.default_rng(seed)
    e = rng.integers(0, 52 if wide else 31, n)
    reuse = (np.int64(1) << e) + rng.integers(-3, 1000, n)
    reuse = np.where(rng.random(n) < 0.02, -reuse, reuse)
    is_evt = rng.random(n) < 0.8
    return {"reuse": reuse.astype(np.int64 if wide else np.int32),
            "is_evt": is_evt, "share": rng.random(n) < 0.1,
            "cold": ~is_evt & (rng.random(n) < 0.5)}


def port(ev, include_cold):
    return masked_histogram_plain(
        *(torch.from_numpy(ev[k]) for k in ("reuse", "is_evt", "share",
                                            "cold")),
        include_cold=include_cold).numpy()


def jax_fused(ev, include_cold):
    jev = {k: jnp.asarray(v) for k, v in ev.items()}
    return np.asarray(pallas_events.fused_event_histogram(jev, include_cold))


def jax_xla(ev, include_cold):
    jev = {k: jnp.asarray(v) for k, v in ev.items()}
    return np.asarray(jr.event_histogram(jev, include_cold))


@pytest.mark.parametrize("include_cold", [True, False])
@pytest.mark.parametrize("source,seed", [("trace", 0), ("trace", 1),
                                         ("random", 2)])
def test_plain_matches_jax_fused_and_xla_int32(xla_only, source, seed,
                                               include_cold):
    ev = trace_events(seed) if source == "trace" else random_events(seed)
    got = port(ev, include_cold)
    assert got.dtype == np.int64 and got.shape == (49,)
    np.testing.assert_array_equal(got, jax_fused(ev, include_cold))
    np.testing.assert_array_equal(got, jax_xla(ev, include_cold))
    assert (got[0] > 0) == include_cold and got[1:].sum() > 0


@pytest.mark.parametrize("include_cold", [True, False])
@pytest.mark.parametrize("source", ["trace", "random"])
def test_plain_matches_jax_xla_int64(xla_only, source, include_cold):
    ev = trace_events(3, pdt=np.int64) if source == "trace" \
        else random_events(4, wide=True)
    if source == "trace":   # positions past the int32 range
        ev["reuse"] = np.where(ev["is_evt"], ev["reuse"] + (5 << 31), 0)
    got = port(ev, include_cold)
    np.testing.assert_array_equal(got, jax_xla(ev, include_cold))
    if source == "random":
        # bins past NBINS weigh nothing: fewer counted than weighted
        wgt = (ev["is_evt"] & ~ev["share"]) | (ev["cold"] & include_cold)
        assert got.sum() < wgt.sum()


def test_wrapper_takes_plain_version_on_cpu():
    ev = {k: torch.from_numpy(v) for k, v in random_events(5).items()}
    args = (ev["reuse"], ev["is_evt"], ev["share"], ev["cold"])
    before = masked_histogram.launches
    assert torch.equal(masked_histogram(*args),
                       masked_histogram_plain(*args))
    assert masked_histogram.launches == before   # no kernel launched


def test_wrapper_checks_its_inputs():
    ev = {k: torch.from_numpy(v) for k, v in random_events(6).items()}
    r, e, s, c = ev["reuse"], ev["is_evt"], ev["share"], ev["cold"]
    bad = [
        (r.to(torch.int16), e, s, c),          # reuse dtype
        (r, e.to(torch.int32), s, c),          # mask dtype
        (r, e, s[:-1], c),                     # shape
        (r.view(50, 100), e.view(50, 100), s.view(50, 100),
         c.view(50, 100)),                     # not 1-D
        (r[::2], e[::2], s[::2], c[::2]),      # strided
        (r[:0], e[:0], s[:0], c[:0]),          # empty
    ]
    for args in bad:
        with pytest.raises(ValueError):
            masked_histogram(*args)


def test_cuda_branch_never_reaches_plain_version(monkeypatch):
    """The plain version is called only under the CPU test of the wrapper;
    the kernel branch never names it, and a tensor on any other device is
    refused without falling back."""
    tree = ast.parse(inspect.getsource(event_hist.masked_histogram))
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", "") == "masked_histogram_plain"]
    assert len(calls) == 1
    cpu_if = [n for n in ast.walk(tree) if isinstance(n, ast.If)
              and "'cpu'" in ast.unparse(n.test)]
    assert len(cpu_if) == 1 and calls[0] in list(ast.walk(cpu_if[0]))
    assert "plain" not in inspect.getsource(event_hist._launch_masked)

    def refuse(*a, **k):
        raise AssertionError("plain version reached off the CPU")

    monkeypatch.setattr(event_hist, "masked_histogram_plain", refuse)
    monkeypatch.setattr(event_hist, "_launch_masked", refuse)
    ev = random_events(7)
    args = [torch.from_numpy(ev[k]).to("meta")
            for k in ("reuse", "is_evt", "share", "cold")]
    with pytest.raises(ValueError, match="no masked-histogram kernel"):
        masked_histogram(*args)


def test_empty_stream_is_refused_before_any_launch(monkeypatch):
    """An empty stream raises in the input check, ahead of the device
    dispatch, so no launch is counted for a kernel that would not run."""
    def refuse(*a, **k):
        raise AssertionError("an empty stream reached a histogram")

    monkeypatch.setattr(event_hist, "masked_histogram_plain", refuse)
    monkeypatch.setattr(event_hist, "_launch_masked", refuse)
    before = masked_histogram.launches
    for dev in ("cpu", "meta"):
        args = [torch.zeros(0, dtype=torch.int32, device=dev)] + [
            torch.zeros(0, dtype=torch.bool, device=dev)] * 3
        with pytest.raises(ValueError, match="empty event stream"):
            masked_histogram(*args)
    assert masked_histogram.launches == before
