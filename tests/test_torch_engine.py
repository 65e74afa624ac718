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
from pluss_torch import cri, engine, mrc, native
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


#: the window template's fields, each array with its dtype
TEMPLATE_FIELDS = ("local_hist", "share_vals", "share_cnts", "head_line",
                   "head_pos", "head_span", "head_dline", "hs_idx",
                   "tail_line", "tail_pos", "tail_dline")

#: (model, n, config, window accesses, threads the walk takes): every
#: thread count and chunk size, sort-path holes, an overlay array beside the
#: template, a line of 8 bytes, one thread; one-round windows of 1, 2 and 3
#: parallel iterations walked by as many threads, and the registry's other
#: rectangular nests
TEMPLATE_CASES = [("gemm", 48, {"thread_num": t, "chunk_size": c}, None, None)
                  for t in (1, 4, 8) for c in (1, 3, 16)] + [
    ("gemm", 48, {"thread_num": 4, "chunk_size": 3}, 1, 3),  # many windows
    ("mvt", 64, {}, None, None),     # sort-path holes in the template
    ("syrk", 16, {}, None, None),    # an overlay array beside the template
    ("atax", 16, {"cls": 8}, None, None),
    ("bicg", 16, {"thread_num": 1}, None, None),
    ("gemm", 48, {"thread_num": 1, "chunk_size": 1}, 1, 1),
    ("gemm", 48, {"thread_num": 1, "chunk_size": 2}, 1, 2),
    ("gemm", 48, {"thread_num": 2, "chunk_size": 3}, 1, 3),
    ("mvt", 64, {"thread_num": 2, "chunk_size": 3}, 1, None),
    ("2mm", 16, {"thread_num": 2, "chunk_size": 3}, 1, None),
    ("3mm", 16, {"thread_num": 1, "chunk_size": 2}, 1, None),
    ("conv2d", 16, {"thread_num": 4, "chunk_size": 1}, None, None),
    ("correlation", 16, {"thread_num": 2, "chunk_size": 3}, 1, None),
    ("doitgen", 16, {"thread_num": 4, "chunk_size": 1}, None, None),
    ("fdtd2d", 16, {"thread_num": 4, "chunk_size": 1}, None, None),
    ("heat3d", 16, {"thread_num": 1, "chunk_size": 2}, 1, None),
    ("jacobi2d", 16, {"thread_num": 2, "chunk_size": 3}, 1, None),
    ("seidel2d", 16, {"thread_num": 4, "chunk_size": 1}, None, None),
    ("stencil3d", 16, {"thread_num": 2, "chunk_size": 3}, 1, None),
    ("syr2k", 16, {"thread_num": 1, "chunk_size": 2}, 1, None),
]


def template_inputs(pkg, spec, cfg, win=None):
    """``pkg``'s arguments of ``_build_template`` for each nest with a
    template-eligible array, and whether sort-path arrays sit beside it."""
    out = []
    for sched, refs, body, _, owned, W, NW in pkg._nest_geometry(
            spec, cfg, None, None, win or pkg.WINDOW_TARGET):
        clean = pkg._clean_windows(owned, W, NW, cfg.chunk_size, sched.trip)
        tpl_refs, var = pkg._split_ref_groups(refs, sched, cfg)
        if tpl_refs:
            out.append(((tpl_refs, W, cfg, sched, owned, clean,
                         spec.line_bases(cfg), spec.array_index, body),
                        bool(var)))
    return out


def assert_same_template(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    for f in ("t0", "w0", "unit_w", "pos_shift"):
        assert getattr(a, f) == getattr(b, f), f
    for f in TEMPLATE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, (f, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f)


class SpanAttrs(dict):
    """What a build sets on its span."""

    def set(self, **attrs):
        self.update(attrs)


@pytest.mark.parametrize("model,n,kw,win,threads", TEMPLATE_CASES)
def test_template_matches_jax(model, n, kw, win, threads):
    """The native window walk builds JAX's template bit for bit, dtypes
    included, however many threads split its parallel iterations; its
    span counts the accesses walked and the threads that walked them."""
    mine = template_inputs(engine, carried(model, n), SamplerConfig(**kw),
                           win)
    theirs = template_inputs(jax_engine, jax_models.REGISTRY[model](n),
                             JaxConfig(**kw), win)
    assert len(mine) == len(theirs) > 0
    cores = min(native.TEMPLATE_THREADS, len(os.sched_getaffinity(0)))
    built = 0
    for (args, var), (jargs, _) in zip(mine, theirs):
        refs, W, cfg = args[:3]
        sp = SpanAttrs()
        tpl = engine._build_template(*args, sp)
        assert_same_template(tpl, jax_engine._build_template(*jargs))
        if tpl is None:
            continue
        built += 1
        assert sp["heads"] == len(tpl.head_line)
        assert sp["entries"] == W * cfg.chunk_size * sum(
            int(np.prod(fr.trips[1:])) for fr in refs)
        assert 1 <= sp["threads"] <= min(cores, W * cfg.chunk_size)
        if threads is not None:
            assert sp["threads"] == min(threads, cores)
        if model == "mvt":
            assert var
    assert built


def test_template_raises_on_a_position_written_twice():
    """Two accesses at one position break the walk's premise: the build
    raises and nothing falls back."""
    (args, _), = template_inputs(engine, carried("gemm", 16),
                                 SamplerConfig())
    refs = args[0]
    with pytest.raises(RuntimeError, match="written twice"):
        engine._build_template(refs + refs[-1:], *args[1:])


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


def _port_modules():
    """The port package's own modules (chip_smoke.py, a harness, aside)."""
    return [p for p in _port_sources()
            if os.path.relpath(p, REPO).startswith("pluss_torch" + os.sep)]


#: the engine's device-table internals: a window walker outside engine.py
#: reaches them through :class:`pluss_torch.engine.DeviceNest`
ENGINE_PRIVATE = {"_NestTensors", "_sort_window", "_ref_window",
                  "_array_ranges", "_DeviceTemplate", "_template_window"}


def test_device_tables_are_reached_through_device_nest():
    """No port module but engine.py names the engine's device-table
    internals, as a name, an attribute or an import (docstrings aside);
    the walkers that once did still reach DeviceNest."""
    bad, users = [], set()
    for path in _port_modules():
        rel = os.path.relpath(path, REPO)
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Name):
                names = [node.id]
            elif isinstance(node, ast.Attribute):
                names = [node.attr]
            elif isinstance(node, ast.ImportFrom):
                names = [a.name for a in node.names]
            else:
                continue
            if "DeviceNest" in names:
                users.add(rel)
            if rel != os.path.join("pluss_torch", "engine.py"):
                bad += [f"{rel}:{node.lineno}: {n}" for n in names
                        if n in ENGINE_PRIVATE]
    assert not bad, bad
    assert {os.path.join("pluss_torch", f) for f in (
        "engine.py", "sampling.py", os.path.join("parallel", "shard.py"))} \
        <= users


def test_auto_dispatch_switch_is_read_in_one_function():
    """``PLUSS_NO_AUTO_DISPATCH`` appears as a value (not in a docstring)
    in one function of the port: the dispatch decision every entry point
    asks."""
    readers = []
    for path in _port_modules():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                    any(isinstance(n, ast.Constant)
                        and n.value == "PLUSS_NO_AUTO_DISPATCH"
                        for n in ast.walk(fn)):
                readers.append((os.path.relpath(path, REPO), fn.name))
    assert readers == [(os.path.join("pluss_torch", "engine.py"),
                        "_dispatch")]
