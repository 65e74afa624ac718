"""The per-layer metrics that read the program's own spans, on the CPU at
tiny sizes: a traced run of each cell's mix reports every one of them
that lists the cell, and the sort window's device time holds the window
sort's.

The CPU has no device trace, so here each host operator's own time
stands in for the device time of what it launched (:func:`_cpu_device`):
that keeps the ranges and their nesting real, which is what the readers
depend on."""

import json
import math
import os

import pytest

from benchmark import devtrace, harness
from benchmark.reference import stream
from conftest import ROOT, tiny_config, tiny_serve_config, tiny_trace_config

#: the metrics that read the program's spans (seconds) or the device time
#: under its ranges
PROGRAM_SPAN_METRICS = {
    "plan_template_s", "template_window_s.host", "share_unique_s.host",
    "sort_window_ms", "sampled_run_s", "sampler_context_ms", "cri_s",
    "cri_s.host", "mrc_s", "mrc_s.host", "mrc_s.stream", "replay_s",
    "replay_s.stream", "feed_stall_s.stream", "trace_batch_ms",
    "trace_batch_ms.stream", "overlay_window_s.host",
    "overlay_window_ms.host", "serve_batch_s.serve", "demux_s.serve",
    "dispatch_s.serve", "cri_s.serve", "mrc_s.serve"}

#: the tiny stand-in of each configuration the benchmark runs
TINY = {"cholesky-2000": lambda: tiny_config("cholesky", 24),
        "gemm-1024": lambda: tiny_config("gemm", 32),
        "mvt-4000-trace": tiny_trace_config,
        "syrk-1024": lambda: tiny_config("syrk", 32),
        "serve-pool": tiny_serve_config}


def _bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _cpu_launched(events):
    """``devtrace.launched_under`` with each ``aten::`` operator's own
    host time as the device time it launched."""
    out = []
    for e in events:
        if not e.name.startswith("aten::"):
            continue
        names, h = set(), e
        while h is not None:
            names.add(h.name)
            h = h.cpu_parent
        out.append((e.name, e.self_cpu_time_total / 1e6, frozenset(names)))
    return out


def _cpu_ops(events):
    by: dict[str, list] = {}
    for name, s, _ in _cpu_launched(events):
        got = by.setdefault(name, [0.0, 0])
        got[0] += s
        got[1] += 1
    return sorted(((k, s, c) for k, (s, c) in by.items() if s > 0),
                  key=lambda o: -o[1])


@pytest.fixture
def _cpu_device(monkeypatch):
    monkeypatch.setattr(devtrace, "device_ops", _cpu_ops)
    monkeypatch.setattr(devtrace, "launched_under", _cpu_launched)


@pytest.fixture
def _small_windows(monkeypatch):
    """Windows of 512 accesses, in the program and the reference alike,
    so that a tiny sampled run draws among several windows and walks
    context before the later ones."""
    from pluss_torch import engine, sampling
    monkeypatch.setattr(engine, "WINDOW_TARGET", 512)
    monkeypatch.setattr(stream, "WINDOW_ACCESSES", 512)
    sampling._plan_cached.cache_clear()
    yield
    sampling._plan_cached.cache_clear()


def _run(root, cell, seconds):
    return harness.run(root.path, cell, 11, seconds, True, t_start=0.0,
                       device="cpu")


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_each_cell_reports_its_program_span_metrics(tiny_root, _cpu_device,
                                                    _small_windows,
                                                    small_batches, cell):
    bench = _bench()
    w = next(w for w in bench["workloads"] if w["name"] == cell)
    want = {m["name"] for m in bench["per_layer"]
            if m["name"] in PROGRAM_SPAN_METRICS and cell in m["workloads"]}
    assert want
    tiny = tiny_root.add(TINY[w["config"]](), w["traffic"])
    out = _run(tiny_root, tiny, 1.0)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for name in sorted(want):
        assert name in got, name
        assert math.isfinite(got[name]["value"]) and got[name]["value"] >= 0
    if w["traffic"] == "sampled":
        # the context walks are part of the sampler and of the sort windows
        assert got["sampler_context_ms"]["value"] \
            < got["sort_window_ms"]["value"]
        assert got["sampled_run_s"]["value"] \
            <= got["sampler_s"]["value"] * (1 + 1e-9)


def test_the_sort_window_holds_the_window_sort(tiny_root, _cpu_device):
    """The sort windows' operators run inside ``engine.sort_window``, so
    the range reads a time."""
    cell = tiny_root.add(tiny_config("cholesky", 24), "full")
    got = _run(tiny_root, cell, 0.5)["metrics"]
    assert got["sort_window_ms"]["value"] > 0


def test_the_parent_without_the_spans_reports_none(tiny_root, _cpu_device,
                                                   monkeypatch):
    """A program without these spans (the commit before them) leaves the
    metrics out of the line and raises nothing."""
    from pluss_torch import obs
    monkeypatch.setattr(obs, "span", lambda name, **attrs: obs.NOOP_SPAN)
    monkeypatch.setattr(obs, "tally_span", lambda name: obs.NOOP_SPAN)
    cell = tiny_root.add(tiny_config("gemm", 16), "full")
    out = _run(tiny_root, cell, 0.3)
    assert out["correct"]
    assert not set(out["metrics"]) & PROGRAM_SPAN_METRICS
