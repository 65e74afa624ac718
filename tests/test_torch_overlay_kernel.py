"""The overlay window's wrapper and kernel launcher, on the CPU.

``overlay.device_window`` checks its inputs, takes
``overlay.device_window_plain`` for CPU tensors and launches the CUDA
kernel (``csrc/overlay_window.cu`` through
``ops.overlay_window.overlay_window``) for CUDA tensors.  Here:

- on the CPU it hands every window of a real walk to the plain version
  with its arguments unchanged and returns the plain version's result,
  over the syrk grid of tests/test_torch_overlay.py (single-round windows,
  so later windows read carried state), syr2k's double overlay, int64
  positions and sliced thread rows: its input checks take every such
  window, and no kernel is launched;
- it refuses inputs of the wrong dtype, device, contiguity or shape;
- its CUDA branch never names the plain version, and a tensor on another
  device is refused; the launcher, its library replaced by a recorder,
  counts one launch a call (``overlay_window.launches`` and the telemetry
  counter ``kernel.launches.overlay_window``), passes the plan's geometry
  and hands back outputs shaped as the plain version's, and calls the
  library inside the profiler range ``pluss::overlay_window``, a child of
  the caller's range, which is what ties the kernel's device time to the
  engine's ``engine.overlay_window`` span in a device trace;
- ``engine._build_kernels`` loads the kernel for a plan with overlays on a
  CUDA device, and for no other.

The kernel itself is held to the plain version element for element on
the card (tests/test_torch_card.py).
"""

import ast
import copy
import dataclasses
import inspect
import types

import numpy as np
import pytest
import torch

from pluss_torch import engine, obs, overlay
from pluss_torch.config import NBINS, SamplerConfig
from pluss_torch.models import REGISTRY
from pluss_torch.ops import build
from pluss_torch.ops import overlay_window as ow_mod
from pluss_torch.ops.overlay_window import overlay_window

CPU = torch.device("cpu")

#: test_overlay_grid_matches_jax's (n, threads, chunk, line size) grid
GRID = [(16, 4, 4, 8), (24, 3, 4, 8), (32, 2, 8, 16), (48, 4, 2, 8),
        (64, 8, 2, 64), (40, 5, 4, 8)]


def dispatched_run(monkeypatch, run):
    """``run()`` with the plain version watched: every overlay window the
    engine hands the wrapper reaches it once, with the very arguments the
    engine passed, and its result is the wrapper's.  Returns the windows
    seen."""
    seen, plain = [], overlay.device_window_plain
    state = {}

    def watched_plain(*args):
        want = state.pop("args")
        assert len(args) == len(want)
        assert all(a is b for a, b in zip(args, want))   # the same objects
        state["out"] = plain(*args)
        return state["out"]

    def wrapper(*args):
        state["args"] = args
        out = overlay.device_window(*args)
        assert out is state.pop("out") and "args" not in state
        seen.append(args[2])
        return out

    monkeypatch.setattr(overlay, "device_window_plain", watched_plain)
    monkeypatch.setattr(engine, "device_window", wrapper)
    before = overlay_window.launches
    run()
    assert overlay_window.launches == before     # no kernel launched
    return seen


@pytest.mark.parametrize("n,T,CS,cls", GRID)
def test_wrapper_is_the_plain_version_on_the_syrk_grid(monkeypatch, n, T,
                                                       CS, cls):
    cfg = SamplerConfig(thread_num=T, chunk_size=CS, cls=cls)
    pl = engine.plan(REGISTRY["syrk"](n), cfg, window_accesses=1)
    seen = dispatched_run(monkeypatch, lambda: engine._execute(pl, CPU))
    assert len(seen) == pl.nests[0].ultra_windows().sum() > 0


@pytest.mark.parametrize("model,n,kw,tb,pdt", [
    ("syr2k", 32, {}, None, np.int32),
    ("syrk", 32, {"cls": 8}, None, np.int64),
    ("syr2k", 16, {"cls": 8}, None, np.int64),
    ("syrk", 64, {}, 1, np.int32),
    ("syrk", 48, {"thread_num": 4, "chunk_size": 2, "cls": 8}, 2, np.int32),
])
def test_wrapper_is_the_plain_version_on_other_walks(monkeypatch, model, n,
                                                     kw, tb, pdt):
    """syr2k's two overlays, int64 positions, and rows of 1 or 2 threads
    (``run_sliced``)."""
    spec, cfg = REGISTRY[model](n), SamplerConfig(**kw)
    if tb is None:
        pl = engine.plan(spec, cfg, window_accesses=1)
        pl = dataclasses.replace(pl, pos_dtype=np.dtype(pdt))
        seen = dispatched_run(monkeypatch,
                              lambda: engine._execute(pl, CPU))
    else:
        seen = dispatched_run(monkeypatch, lambda: engine.run_sliced(
            spec, cfg, device="cpu", thread_batch=tb, window_accesses=1))
    assert seen


@pytest.fixture
def window_inputs():
    """Valid inputs of syrk-16's overlay window 0, for all 4 rows."""
    cfg = SamplerConfig(cls=8)
    spec = REGISTRY["syrk"](16)
    pl = engine.plan(spec, cfg)
    dov = overlay.DeviceOverlay(pl.nests[0].overlays[0], CPU)
    T = cfg.thread_num
    last_pos = torch.full((T, spec.total_lines(cfg)), -1, dtype=torch.int32)
    tids = torch.arange(T, dtype=torch.int64)
    nb = torch.as_tensor(pl.nest_base[0])
    return dov, cfg, tids, nb, last_pos


def _with(dov, **tables):
    bad = copy.copy(dov)
    for k, v in tables.items():
        setattr(bad, k, v)
    return bad


BAD = {
    "last_pos 1-D": lambda d, t, n, lp: (d, t, n, lp[0]),
    "last_pos int16": lambda d, t, n, lp: (d, t, n, lp.to(torch.int16)),
    "last_pos short": lambda d, t, n, lp: (d, t, n, lp[:, :-1]),
    "last_pos strided": lambda d, t, n, lp: (
        d, t, n, lp.t().contiguous().t()),
    "tids int32": lambda d, t, n, lp: (d, t.to(torch.int32), n, lp),
    "tids shape": lambda d, t, n, lp: (d, t[:-1], n, lp),
    "nb int32": lambda d, t, n, lp: (d, t, n.to(torch.int32), lp),
    "nb strided": lambda d, t, n, lp: (
        d, t, torch.stack([n, n], 1)[:, 0], lp),
    "nb on meta": lambda d, t, n, lp: (d, t, n.to("meta"), lp),
    "static_hist dtype": lambda d, t, n, lp: (
        _with(d, static_hist=d.static_hist.to(torch.int32)), t, n, lp),
    "prefix shape": lambda d, t, n, lp: (
        _with(d, prefix=d.prefix[1:]), t, n, lp),
    "first0 on meta": lambda d, t, n, lp: (
        _with(d, first0=d.first0.to("meta")), t, n, lp),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_wrapper_checks_its_inputs(window_inputs, case):
    dov, cfg, tids, nb, last_pos = window_inputs
    # the valid inputs pass
    overlay.device_window(dov, cfg, 0, tids, nb, last_pos.clone())
    args = BAD[case](dov, tids, nb, last_pos)
    with pytest.raises(ValueError):
        overlay.device_window(args[0], cfg, 0, *args[1:])


def test_cuda_branch_never_reaches_plain_version(monkeypatch, window_inputs):
    """The plain version is called only under the CPU test of the wrapper;
    the launcher never names it, and a tensor on any other device is
    refused without falling back."""
    tree = ast.parse(inspect.getsource(overlay.device_window))
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", "") == "device_window_plain"]
    assert len(calls) == 1
    cpu_if = [n for n in ast.walk(tree) if isinstance(n, ast.If)
              and "'cpu'" in ast.unparse(n.test)]
    assert len(cpu_if) == 1 and calls[0] in list(ast.walk(cpu_if[0]))
    launch = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
              and getattr(n.func, "id", "") == "overlay_window"]
    assert len(launch) == 1 and launch[0] not in list(ast.walk(cpu_if[0]))
    assert "plain" not in inspect.getsource(ow_mod.overlay_window)

    def refuse(*a):
        raise AssertionError("plain version or kernel reached off the CPU")

    monkeypatch.setattr(overlay, "device_window_plain", refuse)
    monkeypatch.setattr(overlay, "overlay_window", refuse)
    dov, cfg, tids, nb, last_pos = window_inputs
    meta = overlay.DeviceOverlay(dov.ov, "meta")
    with pytest.raises(ValueError, match="no overlay-window kernel"):
        overlay.device_window(meta, cfg, 0, tids.to("meta"), nb.to("meta"),
                              last_pos.to("meta"))


class _Recorder:
    """Stands in for the kernel's library: records each entry point's
    calls, with the geometry read off the pointer it was handed."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

    def __getattr__(self, name):
        if not name.startswith("pluss_overlay_window_"):
            raise AttributeError(name)

        def fn(geom, Tb, *ptrs):
            g = ow_mod._Geom.from_address(geom)
            self.calls.append((name, {f: getattr(g, f) for f, _ in
                                      g._fields_}, Tb, ptrs))
            return self.err

        return fn


@pytest.mark.parametrize("pdt", [torch.int32, torch.int64])
def test_launcher_counts_one_launch_a_call(monkeypatch, tmp_path,
                                           window_inputs, pdt):
    dov, cfg, tids, nb, last_pos = window_inputs
    last_pos = last_pos.to(pdt)
    lib = _Recorder()
    monkeypatch.setattr(ow_mod, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=77))
    obs.configure(str(tmp_path / "t.jsonl"))
    try:
        before = overlay_window.launches
        for w in (1, 0):
            hist, plus, minus = overlay_window(dov, cfg, w, tids, nb,
                                               last_pos)
        assert overlay_window.launches == before + 2
        assert obs.counters()["kernel.launches.overlay_window"] == 2
    finally:
        obs.shutdown()
    want = overlay.device_window_plain(dov, cfg, 0, tids, nb,
                                       last_pos.clone())
    assert hist.shape == want[0].shape and hist.dtype == want[0].dtype
    for g, w in ((plus, want[1]), (minus, want[2])):
        assert [(x.shape, x.dtype) for x in g] == \
            [(x.shape, x.dtype) for x in w]
    name, geom, Tb, ptrs = lib.calls[-1]
    assert name.endswith("i32" if pdt == torch.int32 else "i64")
    ov = dov.ov
    assert Tb == cfg.thread_num and ptrs[-1] == 77
    assert ptrs[:8] == (tids.data_ptr(), nb.data_ptr(), last_pos.data_ptr(),
                        dov.static_hist.data_ptr(), dov.prefix.data_ptr(),
                        dov.first0.data_ptr(), dov.last0.data_ptr(),
                        plus[0].data_ptr())
    assert ptrs[8:12] == (plus[1].data_ptr(), minus[0].data_ptr(),
                          minus[1].data_ptr(), hist.data_ptr())
    assert geom == {
        "T": cfg.thread_num, "CS": cfg.chunk_size, "R": ov.R, "lpe": ov.lpe,
        "J": ov.J, "SL": ov.SL, "W": ov.W, "K": ov.s_ref.trips[-1],
        "n_lines": ov.n_lines, "line_base": ov.line_base,
        "row_len": last_pos.shape[1], "w": 0,
        "dpos": -ov.w0 * ov.pos_shift, "d_s0": ov.d_s0,
        "d_sj": ov.d_sj, "d_sk": ov.d_sk, "d_off": ov.d_off,
        "d_span": ov.d_span, "s_s0": ov.s_s0, "s_su": ov.s_su,
        "s_sk": ov.s_sk, "s_off": ov.s_off, "s_span": ov.s_span,
        "a_blocks": 0}
    assert hist.shape == (cfg.thread_num, NBINS)


def test_launch_sits_in_its_profiler_range(monkeypatch, window_inputs):
    """The library is called inside ``pluss::overlay_window``, a range of
    function scope (a ``record_function`` range is of user scope, and the
    profiler ties no device work to one), itself inside the caller's."""
    dov, cfg, tids, nb, last_pos = window_inputs

    class Marking(_Recorder):
        def __getattr__(self, name):
            fn = super().__getattr__(name)

            def marked(*a):
                torch.ones(1)                    # an operator at the call
                return fn(*a)

            return marked

    monkeypatch.setattr(ow_mod, "_library", lambda: Marking())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("engine.overlay_window"):
            overlay_window(dov, cfg, 0, tids, nb, last_pos)
    ev = prof.events()
    ranges = [e for e in ev if e.name == "pluss::overlay_window"]
    assert len(ranges) == 1
    assert ranges[0].cpu_parent.name == "engine.overlay_window"
    assert ranges[0].scope != next(
        e for e in ev if e.name == "engine.overlay_window").scope
    ones = [e for e in ev if e.name == "aten::ones"]
    assert len(ones) == 1 and ones[0].cpu_parent is ranges[0]


def test_launcher_raises_on_a_failed_launch(monkeypatch, window_inputs):
    dov, cfg, tids, nb, last_pos = window_inputs
    monkeypatch.setattr(ow_mod, "_library", lambda: _Recorder(err=700))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    before = overlay_window.launches
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        overlay_window(dov, cfg, 0, tids, nb, last_pos)
    assert overlay_window.launches == before


@pytest.mark.parametrize("model,device,want", [
    ("syrk", "cuda", True),
    ("syr2k", "cuda", True),
    ("gemm", "cuda", False),
    ("syrk", "cpu", False),
])
def test_build_kernels_loads_the_overlay_kernel(monkeypatch, model, device,
                                                want):
    loaded = []
    monkeypatch.setattr(build, "load", loaded.append)
    pl = engine.plan(REGISTRY[model](32), SamplerConfig())
    assert bool(any(np_.overlays for np_ in pl.nests)) == (model != "gemm")
    engine._build_kernels(pl, torch.device(device))
    assert ("overlay_window" in loaded) == want
    if device == "cpu":
        assert loaded == []
