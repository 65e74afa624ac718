"""The port's engine vs the JAX package's, on the CPU.

- spec carry-across: every model of the port's registry (all 29 of the
  JAX package's), built by the JAX package and carried through its codec
  JSON, decodes to the port's own spec;
- plan parity: the port's host plan equals ``pluss.engine.plan`` on
  rectangular nests (overlays field by field: tests/test_torch_overlay.py;
  bounded nests: tests/test_torch_triangular.py);
- end to end: ``pluss.engine.run`` vs ``pluss_torch.engine.run(device=
  "cpu")`` on JAX-built specs, then CRI and MRC.  Histograms, share dicts
  and access counts are integers and compared exactly; CRI and MRC floats
  to rtol 1e-12 (the same numpy code summing in the same order);
- guards: no jax or pluss import in the port, and no silent move to the
  CPU.
"""

import ast
import os
import re

import numpy as np
import pytest
import torch

from pluss import cri as jax_cri
from pluss import engine as jax_engine
from pluss import models as jax_models
from pluss import mrc as jax_mrc
from pluss.config import SamplerConfig as JaxConfig
from pluss.spec_codec import spec_to_json as jax_spec_to_json
from pluss_torch import cri, engine, mrc
from pluss_torch.config import SamplerConfig
from pluss_torch.models import REGISTRY
from pluss_torch.spec_codec import spec_from_json, spec_to_json

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def carried(model: str, n: int):
    """The JAX package's spec, carried into the port through the codec."""
    return spec_from_json(jax_spec_to_json(jax_models.REGISTRY[model](n)))


@pytest.mark.parametrize("model", sorted(REGISTRY))
def test_spec_carry_across(model):
    spec = carried(model, 16)
    assert spec == REGISTRY[model](16)
    assert spec_to_json(spec) == jax_spec_to_json(
        jax_models.REGISTRY[model](16))


PLAN_CASES = [
    ("gemm", 16, {}, None),
    ("gemm", 13, {}, None),        # partial chunks: sort windows
    ("gemm", 24, {}, 1),           # mixed ultra/sort segments
    ("mvt", 64, {}, None),         # template + sort (var refs)
    ("syrk", 16, {}, None),        # mixed-coefficient array: an overlay
    ("atax", 16, {"cls": 8}, None),
    ("bicg", 16, {"thread_num": 1}, None),
]


@pytest.mark.parametrize("model,n,kw,win", PLAN_CASES)
def test_plan_matches_jax(model, n, kw, win):
    jp = jax_engine.plan(jax_models.REGISTRY[model](n), JaxConfig(**kw),
                         window_accesses=win, build_rowpriv=False)
    tp = engine.plan(carried(model, n), SamplerConfig(**kw),
                     window_accesses=win)
    assert tp.pos_dtype == jp.pos_dtype
    assert tp.total_count == jp.total_count
    np.testing.assert_array_equal(tp.iters_per_thread, jp.iters_per_thread)
    np.testing.assert_array_equal(tp.nest_base, jp.nest_base)
    for a, b in zip(tp.nests, jp.nests):
        assert (a.window_rounds, a.n_windows, a.body) == \
            (b.window_rounds, b.n_windows, b.body)
        np.testing.assert_array_equal(a.owned, b.owned)
        assert (a.clean is None) == (b.clean is None)
        if a.clean is not None:
            np.testing.assert_array_equal(a.clean, b.clean)
        assert [f.ref.name for f in a.var_refs] == \
            [f.ref.name for f in b.var_refs]
        assert [f.ref.name for f in a.var_refs_novl] == \
            [f.ref.name for f in b.var_refs_novl]
        assert [ov.array for ov in a.overlays] == \
            [ov.array for ov in b.overlays]
        assert (a.tpl is None) == (b.tpl is None)
        if a.tpl is not None:
            for f in ("t0", "w0", "unit_w", "pos_shift"):
                assert getattr(a.tpl, f) == getattr(b.tpl, f), f
            for f in ("local_hist", "share_vals", "share_cnts", "head_line",
                      "head_pos", "head_span", "head_dline", "hs_idx",
                      "tail_line", "tail_pos", "tail_dline"):
                np.testing.assert_array_equal(getattr(a.tpl, f),
                                              getattr(b.tpl, f), err_msg=f)
        np.testing.assert_array_equal(a.ultra_windows(), b.ultra_windows())
    assert engine.plan_path(tp) == jax_engine.plan_path(jp)


def test_plan_cases_cover_both_window_paths():
    """The parity matrix reaches the template path, the sort path, and
    ultra windows that also sort their template-ineligible arrays."""
    def paths(model, n, kw, win):
        pl = engine.plan(carried(model, n), SamplerConfig(**kw),
                         window_accesses=win)
        return {(bool(u), bool(np_.var_refs))
                for np_ in pl.nests for u in np_.ultra_windows()}
    seen = set().union(*(paths(*c) for c in PLAN_CASES))
    assert {(True, False), (True, True), (False, True)} <= seen
    assert any(np_.overlays for m, n, kw, win in PLAN_CASES
               for np_ in engine.plan(carried(m, n), SamplerConfig(**kw),
                                      window_accesses=win).nests)


E2E_CASES = [
    ("gemm", 16, {}, None),
    ("gemm", 128, {}, None),
    ("gemm", 13, {}, None),
    ("gemm", 24, {}, 1),
    ("mvt", 64, {}, None),
    ("atax", 48, {}, None),
    ("bicg", 32, {}, None),
    ("gesummv", 32, {}, None),
    ("2mm", 16, {}, None),
    ("syrk", 16, {}, None),       # the overlay path
    ("gemm", 16, {"thread_num": 1}, None),
    ("atax", 16, {"cls": 8}, None),
]


@pytest.mark.parametrize("model,n,kw,win", E2E_CASES)
def test_run_matches_jax_end_to_end(model, n, kw, win):
    jcfg, tcfg = JaxConfig(**kw), SamplerConfig(**kw)
    want = jax_engine.run(jax_models.REGISTRY[model](n), jcfg,
                          window_accesses=win)
    got = engine.run(carried(model, n), tcfg, device="cpu",
                     window_accesses=win)
    assert got.max_iteration_count == want.max_iteration_count
    np.testing.assert_array_equal(got.noshare_dense, want.noshare_dense)
    assert got.share_raw == want.share_raw
    assert got.noshare_list() == want.noshare_list()
    assert got.share_list() == want.share_list()

    ri_t = cri.distribute(got.noshare_list(), got.share_list(),
                          tcfg.thread_num)
    ri_j = jax_cri.distribute(want.noshare_list(), want.share_list(),
                              jcfg.thread_num)
    assert sorted(ri_t) == sorted(ri_j)
    np.testing.assert_allclose([ri_t[k] for k in sorted(ri_t)],
                               [ri_j[k] for k in sorted(ri_j)], rtol=1e-12)
    np.testing.assert_allclose(mrc.aet_mrc(ri_t, tcfg),
                               jax_mrc.aet_mrc(ri_j, jcfg), rtol=1e-12)


def test_gemm128_goldens():
    """The analytical GEMM-128 goldens (tests/test_oracle.py)."""
    res = engine.run(REGISTRY["gemm"](128), device="cpu")
    assert res.max_iteration_count == 8421376
    assert cri.merge(res.noshare_list()) == {
        -1: 12288, 1: 2127872, 2: 2097152, 4: 1835008, 256: 260096,
        512: 1835008}
    assert cri.merge([g for d in res.share_list() for g in d.values()]) \
        == {62194: 253952}
    curve = mrc.aet_mrc(cri.distribute(res.noshare_list(), res.share_list(),
                                       4))
    assert curve[0] == 1.0 and (np.diff(curve) <= 0).all()


def test_run_without_device_raises_when_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.run(REGISTRY["gemm"](8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.resolve_device()
    assert engine.resolve_device("cpu") == torch.device("cpu")


def _port_sources():
    for root, dirs, files in os.walk(os.path.join(REPO, "pluss_torch")):
        # the kernel build directory holds outputs, not the port's sources
        dirs[:] = [d for d in dirs if d != "_build"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_package_root_exports_what_pluss_exports():
    """Every public name of the ``pluss`` package object (its submodules
    aside) is on ``pluss_torch`` too, as the port's own type, and the
    versions agree."""
    import types

    import pluss
    import pluss_torch

    names = {n for n, v in vars(pluss).items()
             if not n.startswith("_") and not isinstance(v, types.ModuleType)}
    assert names == {"SamplerConfig", "DEFAULT", "Loop", "LoopNestSpec",
                     "Ref", "ChunkSchedule"}
    for n in names:
        got = getattr(pluss_torch, n)
        kind = got if isinstance(got, type) else type(got)
        assert kind.__module__.startswith("pluss_torch."), n
    assert pluss_torch.__version__ == pluss.__version__ == "0.1.0"
    assert pluss_torch.DEFAULT == pluss_torch.SamplerConfig()
    assert vars(pluss_torch.DEFAULT) == vars(pluss.DEFAULT)
    spec = pluss_torch.LoopNestSpec(
        name="t", arrays=(("A", 4),),
        nests=(pluss_torch.Loop(trip=4, body=(pluss_torch.Ref(
            "A0", "A", addr_terms=((0, 1),)),)),))
    assert spec.nests[0].trip == 4
    assert pluss_torch.ChunkSchedule(2, 4, 0, 1, 2).n_chunks \
        == pluss.ChunkSchedule(2, 4, 0, 1, 2).n_chunks


def test_importing_the_package_loads_no_jax_and_no_pluss():
    """``import pluss_torch`` and its root names, in a fresh interpreter:
    no module of jax, jaxlib or ``pluss`` is loaded by it."""
    import subprocess
    import sys

    code = ("import sys; before = set(sys.modules); import pluss_torch; "
            "from pluss_torch import (SamplerConfig, DEFAULT, Loop, "
            "LoopNestSpec, Ref, ChunkSchedule, __version__); "
            "print(sorted(m for m in set(sys.modules) - before "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'pluss')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_port_imports_no_jax_and_no_pluss():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "pluss", "tests"):
                    bad.append(f"{os.path.relpath(path, REPO)}: {name}")
    assert not bad, bad
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    assert len(scanned) > 10
    assert {"pluss_torch/trace.py", "pluss_torch/tracegen.py",
            "pluss_torch/resilience/errors.py",
            "pluss_torch/ops/wirecodec.py",
            "pluss_torch/ops/decode.py", "pluss_torch/rowpriv.py",
            "pluss_torch/sweepgroup.py", "pluss_torch/models/solvers.py",
            "pluss_torch/models/stencils.py", "pluss_torch/overlay.py",
            "pluss_torch/sampling.py", "pluss_torch/residency.py",
            "pluss_torch/resilience/journal.py", "pluss_torch/native.py",
            "pluss_torch/tracebench.py", "pluss_torch/__init__.py",
            "pluss_torch/config.py", "pluss_torch/spec.py",
            "pluss_torch/sched.py",
            "pluss_torch/resilience/__init__.py",
            "pluss_torch/resilience/faults.py",
            "pluss_torch/resilience/ladder.py",
            "pluss_torch/obs/__init__.py", "pluss_torch/obs/telemetry.py",
            "pluss_torch/obs/stats.py", "pluss_torch/obs/xprof.py",
            "pluss_torch/utils/__init__.py",
            "pluss_torch/utils/envknob.py"} <= scanned
    # the static analysis and the cache model: all of the JAX package's
    # analysis, and its model package
    analysis = {f"pluss_torch/analysis/{m}.py" for m in (
        "__init__", "bounds", "contract", "deps", "depvec", "diagnostics",
        "falseshare", "footprint", "interference", "polycount", "ri",
        "sarif", "schedule", "sharespan", "transform", "tune", "walk")}
    model = {"pluss_torch/model/__init__.py",
             "pluss_torch/model/hierarchy.py"}
    # the authoring frontend, file for file the JAX package's
    frontend = {f"pluss_torch/frontend/{m}.py" for m in (
        "__init__", "cparse", "dsl", "emit", "ir", "lower", "polybench")}
    # the serving daemon, the autotuner and the sweep
    serve = {f"pluss_torch/serve/{m}.py" for m in (
        "__init__", "admission", "batcher", "journal", "placement",
        "protocol", "server")}
    assert analysis | model | frontend | serve | {
        "pluss_torch/iteration.py", "pluss_torch/models/__init__.py",
        "pluss_torch/cli.py", "pluss_torch/autotune.py",
        "pluss_torch/plancache.py", "pluss_torch/sweep.py",
        "pluss_torch/obs/tracectx.py", "pluss_torch/obs/slo.py",
        "pluss_torch/obs/flight.py",
        "pluss_torch/resilience/breaker.py", "pluss_torch/soak.py"} <= scanned
    assert {p for p in scanned if p.startswith(("pluss_torch/analysis/",
                                                "pluss_torch/model/",
                                                "pluss_torch/frontend/"))} \
        == analysis | model | frontend
    # the native runtime's C++ (pluss_torch/cpp): its own copy, which
    # includes only its own header and names no file of the JAX package
    cpp_dir = os.path.join(REPO, "pluss_torch", "cpp")
    cpp = sorted(os.listdir(cpp_dir))
    assert cpp == ["capi.cpp", "main.cpp", "pluss_rt.cpp", "pluss_rt.hpp"]
    for f in cpp:
        with open(os.path.join(cpp_dir, f)) as fh:
            for i, line in enumerate(fh, 1):
                where = f"pluss_torch/cpp/{f}:{i}"
                assert not re.search(r"(?<![\w.])pluss/", line), where
                m = re.match(r'\s*#\s*include\s*"([^"]+)"', line)
                if m:
                    assert m.group(1) in cpp, where
