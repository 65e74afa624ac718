"""The port's warm-start layer (``pluss_torch.plancache``) and its
concurrent-build safety, on the CPU.

- the runtime salt's shape (torch and CUDA versions, the device, NBINS);
- :class:`CompileRegistry` single-flight: one build, many waiters sharing
  the leader's result; a failure rejects every waiter with the leader's
  exception object (as tests/test_warmstart.py holds JAX's registry);
- ``engine._plan_cached`` and ``engine.precompile`` through the registry:
  threads racing a cold key plan once;
- ``ops.build.load`` from 8 threads with the compiler replaced by a fake
  one runs it once and loads one file; ``build`` from 8 threads too.
"""

import os
import re
import threading
import time

import pytest
import torch

from pluss import plancache as jax_plancache
from pluss_torch import engine, obs, plancache
from pluss_torch.config import SamplerConfig
from pluss_torch.models import gemm
from pluss_torch.ops import build


@pytest.fixture(autouse=True)
def _obs_off():
    obs.shutdown()
    yield
    obs.shutdown()


def test_runtime_salt_shape():
    salt = plancache.runtime_salt("cpu")
    assert salt == (f"torch={torch.__version__}/cuda={torch.version.cuda}/"
                    "cpu/nbins=49")
    assert re.fullmatch(r"torch=[^/]+/cuda=[^/]+/cpu/nbins=49", salt)
    # the same grid constant as the JAX package's salt
    assert jax_plancache.runtime_salt().endswith("/nbins=49")
    assert plancache.runtime_salt(torch.device("cpu")) == salt


def test_runtime_salt_names_the_card(monkeypatch):
    """On a CUDA device the salt carries the card's name and sm_XY (the
    card's answers are faked here; the chip run checks the real ones)."""
    plancache._cuda_salt.cache_clear()
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda i=0: (9, 0))
    try:
        assert plancache._cuda_salt(0) == (
            f"torch={torch.__version__}/cuda={torch.version.cuda}/"
            "NVIDIA H100 80GB HBM3/sm_90/nbins=49")
    finally:
        plancache._cuda_salt.cache_clear()


def test_runtime_salt_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plancache.runtime_salt()


def _fan_out(reg, key, fn, n):
    results, errors = [None] * n, [None] * n

    def call(i):
        try:
            results[i] = reg.do(key, fn)
        except BaseException as e:  # noqa: BLE001 — recorded
            errors[i] = e

    threads = [threading.Thread(target=call, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    return threads, results, errors


def _await_waiters(n, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if obs.counters().get("engine.compile_singleflight_waits", 0) >= n:
            return
        time.sleep(0.01)
    raise AssertionError("waiters never queued on the in-flight build")


def test_single_flight_one_build_many_waiters(tmp_path):
    obs.configure(str(tmp_path / "tel.jsonl"))
    reg = plancache.CompileRegistry(gauge="engine.compile_inflight")
    release = threading.Event()
    builds = []

    def slow_build():
        builds.append(threading.get_ident())
        release.wait(10)
        return object()

    threads, results, errors = _fan_out(reg, "k", slow_build, 6)
    _await_waiters(5)
    assert reg.inflight() == 1
    release.set()
    for t in threads:
        t.join(10)
    assert len(builds) == 1, "concurrent callers duplicated the build"
    assert errors == [None] * 6
    assert all(r is results[0] for r in results)
    assert reg.inflight() == 0
    assert obs.gauges().get("engine.compile_inflight") == 0.0


def test_single_flight_failure_rejects_all_waiters_typed(tmp_path):
    from pluss_torch.resilience.errors import CompileError

    obs.configure(str(tmp_path / "tel.jsonl"))
    reg = plancache.CompileRegistry()
    release = threading.Event()

    def doomed():
        release.wait(10)
        raise CompileError("injected build failure", site="test")

    threads, results, errors = _fan_out(reg, "k", doomed, 6)
    _await_waiters(5)
    release.set()
    for t in threads:
        t.join(10)
    assert results == [None] * 6
    assert all(isinstance(e, CompileError) for e in errors)
    assert all(e is errors[0] for e in errors), \
        "waiters must get the leader's exception object, not a retry"
    # failures are never cached: the next cold caller builds fresh
    assert reg.do("k", lambda: "recovered") == "recovered"


def test_plan_memo_single_flight(monkeypatch):
    """Eight threads asking for one cold plan plan it once and share the
    plan object; ``precompile`` racing itself warms once."""
    engine._plan_cached.cache_clear()
    calls = []
    real = engine.plan

    def counted(*a, **k):
        calls.append(1)
        time.sleep(0.2)
        return real(*a, **k)

    monkeypatch.setattr(engine, "plan", counted)
    spec, cfg = gemm(12), SamplerConfig(thread_num=2, chunk_size=2)
    out = [None] * 8

    def get(i):
        out[i] = engine._plan_cached(spec, cfg, None, None, None)

    threads = [threading.Thread(target=get, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert len(calls) == 1
    assert all(p is out[0] for p in out)
    engine._plan_cached.cache_clear()
    calls.clear()
    paths = [None] * 4

    def warm(i):
        paths[i] = engine.precompile(spec, cfg, device="cpu")

    threads = [threading.Thread(target=warm, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert len(calls) == 1 and paths == ["full"] * 4
    assert engine.is_warm(spec, cfg)
    assert engine.compile_inflight() == 0
    engine._plan_cached.cache_clear()


@pytest.fixture
def fake_compiler(tmp_path, monkeypatch):
    """``build`` with its compiler replaced: the fake "compiler" sleeps (so
    racing threads overlap it) and copies a loadable shared library to the
    output path; every run is recorded."""
    import shutil

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "fake_kernel.cpp").write_text("// fake source\n")
    monkeypatch.setattr(build, "CSRC", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    # any loadable shared library stands in for the built one: the
    # interpreter's own ctypes extension is always there
    import _ctypes

    real_lib = _ctypes.__file__
    runs = []
    script = tmp_path / "fakecc.py"
    script.write_text(
        "import shutil, sys, time\n"
        "time.sleep(0.3)\n"
        f"shutil.copy({real_lib!r}, sys.argv[1])\n")

    def command(name, out):
        runs.append(out)
        import sys

        return [sys.executable, str(script), out]

    monkeypatch.setattr(build, "_command", command)
    build.load.cache_clear()
    yield runs
    build.load.cache_clear()
    shutil.rmtree(tmp_path / "build", ignore_errors=True)


def test_load_from_eight_threads_builds_once(fake_compiler):
    libs, errors = [None] * 8, []

    def go(i):
        try:
            libs[i] = build.load("fake_kernel")
        except BaseException as e:  # noqa: BLE001 — recorded
            errors.append(e)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    assert len(fake_compiler) == 1, "the compiler ran more than once"
    # the temp name is per process and thread, never the bare pid
    assert re.search(r"\.tmp\d+-\d+$", fake_compiler[0])
    assert all(lib is libs[0] for lib in libs)
    built = os.listdir(build.BUILD_DIR)
    assert built == [os.path.basename(build.library_path("fake_kernel"))]


def test_build_from_eight_threads_compiles_once(fake_compiler):
    """``build`` itself (chip_smoke.py's parallel build, racing a first
    ``load``) compiles one source once: the other threads find the
    library built."""
    errors = []

    def go():
        try:
            build.build("fake_kernel")
        except BaseException as e:  # noqa: BLE001 — recorded
            errors.append(e)

    threads = [threading.Thread(target=go) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    assert len(fake_compiler) == 1
    assert len(set(fake_compiler)) == 1
    assert os.path.exists(build.library_path("fake_kernel"))
    assert not [f for f in os.listdir(build.BUILD_DIR) if ".tmp" in f]
