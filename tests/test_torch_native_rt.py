"""The port's native C++ runtime (``pluss_torch.native``, ``pluss_torch/cpp``)
against the JAX package's (``pluss.native``, ``pluss/cpp``) and the port's
engine on the CPU, and the gap fills of this slice against their JAX twins.

Both runtimes are built with the host ``c++`` inside the tests: the port's
by :func:`pluss_torch.native.build` into ``pluss_torch/_build/``, the JAX
package's by :func:`pluss.native.build` when its ``pluss/cpp/build/`` is
absent (as tests/test_native.py does).  Nothing here skips: a failed build
fails the test.  Tolerances: per-thread histograms, share histograms and
access counts are exact everywhere; the two runtimes agree exactly on
everything (they are the same C++ on the same tokens); against the port's
engine + ``cri.distribute`` + ``mrc.aet_mrc`` the CRI histogram's keys are
exact and its values within 1e-11 relative (the port's racetrack split is
vectorized and sums in another order; at most 7.05e-12 on the 29 families
at n=16), the MRC within ``mrc.l2_error`` 1e-12 and the native MRC within
rtol 1e-12 of the port's AET of the native CRI histogram (tests/test_native.py's
tolerances).
"""

import ctypes
import io
import math
import os
import subprocess

import numpy as np
import pytest

from pluss import cri as jax_cri
from pluss import io as jax_io
from pluss import models as jax_models
from pluss import native as jax_native
from pluss import sched as jax_sched
from pluss.config import AET_PRED_EPS as JAX_AET_PRED_EPS
from pluss.config import SamplerConfig as JaxConfig
from pluss_torch import config, cri, engine, io as tio, mrc, native, sched
from pluss_torch import trace
from pluss_torch.config import SamplerConfig
from pluss_torch.models import REGISTRY
from pluss_torch.ops import build
from pluss_torch.spec import SpecContractError

FAMILIES = sorted(REGISTRY)


@pytest.fixture(scope="module")
def built():
    """Both runtimes built (the port's always through its own build; the
    JAX package's only when its build directory lacks it)."""
    native.build()
    if not (os.path.exists(jax_native.LIB_PATH)
            and os.path.exists(jax_native.BIN_PATH)):
        jax_native.build()
    return native.BIN_PATH, jax_native.BIN_PATH


def _held_against_engine(nat, res, cfg) -> None:
    assert nat.noshare_list() == res.noshare_list()
    assert nat.share_list() == res.share_list()
    assert nat.max_iteration_count == res.max_iteration_count
    ri = cri.distribute(res.noshare_list(), res.share_list(), cfg.thread_num)
    nri = nat.rihist()
    assert set(nri) == set(ri)
    for k, v in ri.items():
        assert nri[k] == pytest.approx(v, rel=1e-11, abs=0.0), k
    curve, ncurve = mrc.aet_mrc(ri, cfg), nat.mrc()
    assert len(curve) == len(ncurve)
    assert mrc.l2_error(curve, ncurve) < 1e-12
    np.testing.assert_allclose(ncurve, mrc.aet_mrc(nri, cfg), rtol=1e-12,
                               atol=0)


def _held_against_jax(nat, jnat) -> None:
    assert nat.noshare_list() == jnat.noshare_list()
    assert nat.share_list() == jnat.share_list()
    assert nat.rihist() == jnat.rihist()
    assert nat.max_iteration_count == jnat.max_iteration_count
    np.testing.assert_array_equal(nat.mrc(), jnat.mrc())


@pytest.mark.parametrize("model", FAMILIES)
def test_native_run_matches_jax_native_and_the_engine(built, model):
    spec = REGISTRY[model](16)
    nat = native.run(spec)
    _held_against_jax(nat, jax_native.run(jax_models.REGISTRY[model](16)))
    _held_against_engine(nat, engine.run(spec, device="cpu"),
                         SamplerConfig())


def test_native_nondefault_config(built):
    cfg = SamplerConfig(thread_num=2, chunk_size=3, cls=32, cache_kb=64)
    jcfg = JaxConfig(thread_num=2, chunk_size=3, cls=32, cache_kb=64)
    spec = REGISTRY["gemm"](13)  # odd size: partial chunks
    nat = native.run(spec, cfg)
    assert nat.thread_num == 2 and len(nat.noshare_list()) == 2
    _held_against_jax(nat, jax_native.run(jax_models.REGISTRY["gemm"](13),
                                          jcfg))
    _held_against_engine(nat, engine.run(spec, cfg, device="cpu"), cfg)


@pytest.mark.parametrize("tokens", [[1, 7, 7], [1, 3, 0, 4, 1], [],
                                    [2, 0, 4, 0, 1, 0]])
def test_native_rejects_malformed_tokens(built, tokens):
    """A token stream ``pluss_rt.hpp`` cannot parse gives a null handle
    (a bad node tag, a loop with a bad tag, an empty stream, a missing
    second nest)."""
    lib = native._load()
    bad = np.asarray(tokens + [0], np.int64)
    elems = np.asarray([4], np.int64)
    h = lib.pluss_run(
        bad.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), len(tokens),
        elems.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), 1,
        4, 4, 8, 64, 2560)
    assert not h


def test_native_refuses_what_the_engine_refuses(built):
    """``spec_tokens`` runs the engine's structural checks: a bounded
    parallel loop is refused before any token is shipped."""
    import dataclasses

    spec = REGISTRY["trmm"](8)
    bad = dataclasses.replace(spec, nests=(dataclasses.replace(
        spec.nests[0], bound_coef=(1, 1)),) + tuple(spec.nests[1:]))
    with pytest.raises(SpecContractError):
        native.spec_tokens(bad)
    with pytest.raises(SpecContractError):
        native.run(bad)


@pytest.mark.parametrize("model", FAMILIES)
def test_spec_tokens_and_spec_file_match_jax(tmp_path, model):
    spec, jspec = REGISTRY[model](16), jax_models.REGISTRY[model](16)
    toks = native.spec_tokens(spec)
    assert toks.dtype == np.int64
    np.testing.assert_array_equal(toks, jax_native.spec_tokens(jspec))
    mine, theirs = tmp_path / "port.spec", tmp_path / "jax.spec"
    native.write_spec_file(spec, str(mine))
    jax_native.write_spec_file(jspec, str(theirs))
    assert mine.read_bytes() == theirs.read_bytes()
    assert native.SPEC_FILE_MAGIC == jax_native.SPEC_FILE_MAGIC


def _binaries(built, *argv, cwd=None):
    """stdout of the port's and the JAX package's ``pluss_cpp``."""
    return [subprocess.run([b, *argv], capture_output=True, text=True,
                           check=True, cwd=cwd).stdout for b in built]


def _below_banner(text: str) -> list[str]:
    return text.splitlines()[1:]


@pytest.mark.parametrize("n", [8, 16, 33])
def test_pluss_cpp_acc_matches_jax_binary(built, n):
    mine, theirs = _binaries(built, "acc", str(n))
    assert mine.startswith("NATIVE C++: ")
    assert _below_banner(mine) == _below_banner(theirs)


def test_pluss_cpp_acc_128_prints_the_goldens(built):
    out = _binaries(built, "acc", "128")[0]
    assert "max iteration traversed\n8421376\n" in out
    for line in ("-1,12288,", "1,2.12787e+06,", "512,1.83501e+06,",
                 "62194,253952,1"):
        assert line in out, line


def test_pluss_cpp_mrc_matches_jax_binary(built, tmp_path):
    outs = [subprocess.run([b, "mrc", "16", name], cwd=tmp_path,
                           capture_output=True, text=True, check=True).stdout
            for b, name in zip(built, ("p.csv", "j.csv"))]
    assert outs[0].startswith("wrote MRC over ")
    assert outs[0].replace("p.csv", "j.csv") == outs[1]
    port_csv = (tmp_path / "p.csv").read_bytes()
    assert port_csv == (tmp_path / "j.csv").read_bytes()
    lines = port_csv.decode().splitlines()
    nat = native.run(REGISTRY["gemm"](16))
    assert lines[0] == "miss ratio"
    assert lines[1:] == [f"{c}, {v:g}" for c, v in mrc.dedup_lines(nat.mrc())]


def test_pluss_cpp_trace_matches_jax_binary(built, tmp_path):
    rng = np.random.default_rng(5)
    addrs = (rng.integers(0, 1 << 14, 30000) * 8).astype("<u8")
    path = tmp_path / "t.bin"
    addrs.tofile(path)
    mine, theirs = _binaries(built, "trace", str(path), "m.csv",
                             cwd=tmp_path)
    assert mine.startswith("NATIVE TRACE: ")
    assert _below_banner(mine) == _below_banner(theirs)
    # the block's histogram is the port's replay's
    rep = trace.replay(addrs.astype(np.int64), device="cpu")
    buf = io.StringIO()
    tio.print_histogram(tio.RI_TITLE, rep.histogram(), buf)
    assert _below_banner(mine)[:-3] == buf.getvalue().splitlines()


def test_pluss_cpp_speed_mode(built):
    mine = _binaries(built, "speed", "16")[0].splitlines()
    assert len(mine) == 4 and mine[-1] == ""
    assert all(ln.startswith("NATIVE C++: ") for ln in mine[:3])


@pytest.mark.parametrize("model", FAMILIES)
def test_pluss_cpp_spec_matches_jax_binary_and_the_engine(built, tmp_path,
                                                          model):
    """``pluss_cpp acc --spec`` of the port's spec file prints the JAX
    binary's block on JAX's file, and the port's CLI block of the same
    model below the banner."""
    spec = REGISTRY[model](16)
    native.write_spec_file(spec, str(tmp_path / "p.spec"))
    jax_native.write_spec_file(jax_models.REGISTRY[model](16),
                               str(tmp_path / "j.spec"))
    mine = subprocess.run([built[0], "acc", "--spec", str(tmp_path / "p.spec")],
                          capture_output=True, text=True, check=True).stdout
    theirs = subprocess.run([built[1], "acc", "--spec",
                             str(tmp_path / "j.spec")],
                            capture_output=True, text=True, check=True).stdout
    assert _below_banner(mine) == _below_banner(theirs)
    res = engine.run(spec, device="cpu")
    ri = cri.distribute(res.noshare_list(), res.share_list(), 4)
    buf = io.StringIO()
    tio.acc_block("X", 0.0, res.noshare_list(), res.share_list(), ri,
                  res.max_iteration_count, buf)
    assert _below_banner(mine) == _below_banner(buf.getvalue())


def test_pluss_cpp_spec_mrc_mode_and_bad_files(built, tmp_path):
    native.write_spec_file(REGISTRY["trmm"](12), str(tmp_path / "p.spec"))
    mine, theirs = _binaries(built, "mrc", "--spec", str(tmp_path / "p.spec"),
                             "m.csv", cwd=tmp_path)
    assert mine == theirs
    (tmp_path / "bad.spec").write_bytes(b"\0" * 24)
    for b in built:
        p = subprocess.run([b, "acc", "--spec", str(tmp_path / "bad.spec")],
                           capture_output=True, text=True)
        assert p.returncode == 1 and "magic" in p.stderr


def test_native_replay_matches_trace_replay(built):
    rng = np.random.default_rng(11)
    addrs = rng.integers(0, 1 << 16, 20000).astype(np.int64) * 8
    nat = native.replay(addrs)
    rep = trace.replay(addrs, device="cpu")
    assert nat.rihist() == rep.histogram()
    assert nat.max_iteration_count == len(addrs)
    assert nat.rihist() == jax_native.replay(addrs).rihist()
    assert mrc.l2_error(mrc.aet_mrc(rep.histogram()), nat.mrc()) < 1e-12
    np.testing.assert_array_equal(nat.mrc(), jax_native.replay(addrs).mrc())


def test_runtime_builds_only_from_the_port_into_its_build_dir(built):
    """Both targets live in ``pluss_torch/_build/`` under a hash of every
    source, header and flag, with stable links; an edited header renames
    both."""
    assert os.path.dirname(native.LIB_PATH) == build.BUILD_DIR
    assert os.path.dirname(native.BIN_PATH) == build.BUILD_DIR
    assert native.CPP_DIR == os.path.join(os.path.dirname(build.BUILD_DIR),
                                          "cpp")
    for name, link in (("pluss_rt", native.LIB_PATH),
                       ("pluss_cpp", native.BIN_PATH)):
        assert os.path.realpath(link) == build.library_path(name)
        cmd = build._command(name, "out")
        assert "-fopenmp" in cmd
        assert all(not a.startswith(os.path.join(os.path.dirname(
            build.BUILD_DIR), "..", "pluss")) for a in cmd)
        srcs = [a for a in cmd if a.endswith(".cpp")]
        assert srcs and all(os.path.dirname(a) == build.CPP for a in srcs)
    assert native.available()


def test_header_edit_rebuilds_both_targets(tmp_path, monkeypatch):
    import shutil

    cpp = tmp_path / "cpp"
    shutil.copytree(build.CPP, cpp)
    monkeypatch.setattr(build, "CPP", str(cpp))
    names = ("pluss_rt", "pluss_cpp", "map_lines")
    before = {n: build.library_path(n) for n in names}
    with open(cpp / "pluss_rt.hpp", "a") as f:
        f.write("// edited\n")
    after = {n: build.library_path(n) for n in names}
    assert before["pluss_rt"] != after["pluss_rt"]
    assert before["pluss_cpp"] != after["pluss_cpp"]
    # a csrc library keys on its own source only
    assert before["map_lines"] == after["map_lines"]


def test_failed_runtime_build_raises(tmp_path, monkeypatch):
    cpp = tmp_path / "cpp"
    cpp.mkdir()
    for f in ("pluss_rt.hpp", "pluss_rt.cpp", "capi.cpp", "main.cpp"):
        (cpp / f).write_text("this is not C++\n")
    monkeypatch.setattr(build, "CPP", str(cpp))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="native build failed"):
        native.build()
    with pytest.raises(build.BuildError):
        native.available(autobuild=True)


# --- the gap fills, against their JAX twins --------------------------------


def test_aet_pred_eps_matches_jax():
    assert config.AET_PRED_EPS == JAX_AET_PRED_EPS
    assert SamplerConfig(cls=64, ds=8).lines_per_element_div \
        == JaxConfig(cls=64, ds=8).lines_per_element_div == 8


@pytest.fixture(scope="module")
def gemm16():
    res = engine.run(REGISTRY["gemm"](16), device="cpu")
    ri = cri.distribute(res.noshare_list(), res.share_list(), 4)
    return res, ri


def test_acc_block_with_pri_matches_jax(gemm16):
    res, ri = gemm16
    args = ("TORCH CPU", 0.0, res.noshare_list(), res.share_list(), ri,
            res.max_iteration_count)
    mine, theirs, plain = io.StringIO(), io.StringIO(), io.StringIO()
    tio.acc_block(*args, mine, with_pri=True)
    jax_io.acc_block(*args, theirs, with_pri=True)
    assert mine.getvalue() == theirs.getvalue()
    assert tio.PRI_TITLE == jax_io.PRI_TITLE and tio.PRI_TITLE in \
        mine.getvalue()
    pri = tio.merge_pri(res.noshare_list(), res.share_list())
    assert pri == jax_io.merge_pri(res.noshare_list(), res.share_list())
    assert sum(pri.values()) == sum(tio.merge_noshare(
        res.noshare_list()).values()) + sum(tio.merge_share(
            res.share_list()).values())
    # without with_pri the block is what it always was
    tio.acc_block(*args, plain)
    jplain = io.StringIO()
    jax_io.acc_block(*args, jplain)
    assert plain.getvalue() == jplain.getvalue()
    assert tio.PRI_TITLE not in plain.getvalue()


def test_merge_noshare_matches_jax(gemm16):
    res, _ = gemm16
    assert tio.merge_noshare(res.noshare_list()) \
        == jax_io.merge_noshare(res.noshare_list())
    assert -1 in tio.merge_noshare(res.noshare_list())


@pytest.mark.parametrize("ri,n", [(1, 3.0), (4, 3.0), (5, 1.0), (100, 3.0),
                                  (1000, 7.0), (65536, 3.0), (12345, 15.0)])
def test_racetrack_bins_matches_jax(ri, n):
    assert cri.racetrack_bins(ri, n) == jax_cri.racetrack_bins(ri, n)


def test_racetrack_bins_small_ri():
    assert cri.racetrack_bins(1, 3.0) == [(0, 1.0)]
    bins = dict(cri.racetrack_bins(4, 3.0))
    assert set(bins) == {1, 2}
    assert math.isclose(bins[1], 0.75**3 - 0.5**3)
    assert math.isclose(bins[2], 1 - 0.75**3)


def test_racetrack_bins_is_the_vectorized_split():
    """The scalar loop and ``_racetrack_emit`` put the same mass in the
    same bins (the emit sums across values in another order)."""
    ris = np.asarray([1, 2, 3, 4, 7, 100, 4096, 99999], np.float64)
    w = np.arange(1, len(ris) + 1, dtype=np.float64)
    got: dict = {}
    cri._racetrack_emit(ris, w, 3.0, got)
    want: dict = {}
    for r, wt in zip(ris, w):
        for k, p in cri.racetrack_bins(int(r), 3.0):
            want[k] = want.get(k, 0.0) + p * wt
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12)


SCHED_CASES = [(4, 128, 0, 1, 4), (4, 130, 0, 1, 4), (3, 7, 0, 1, 4),
               (5, 23, 2, 1, 4), (4, 16, 0, 2, 4), (7, 7, 0, 1, 2),
               (4, 3, 0, 1, 4), (2, 64, 0, 1, 8), (4, 10, 0, -1, 2),
               (3, 7, 5, -2, 2), (4, 0, 0, 1, 4)]


@pytest.mark.parametrize("cs,trip,start,step,T", SCHED_CASES)
def test_sched_grid_and_helpers_match_jax(cs, trip, start, step, T):
    s = sched.ChunkSchedule(cs, trip, start, step, T)
    j = jax_sched.ChunkSchedule(cs, trip, start, step, T)
    assert sched.chunks_check(trip, cs) == jax_sched.chunks_check(trip, cs)
    assert s.max_rounds() == j.max_rounds()
    assert s.dynamic_assignment() == j.dynamic_assignment()
    for tid in range(T):
        assert sched.iteration_value_grid(s, tid) \
            == jax_sched.iteration_value_grid(j, tid)
        assert s.n_chunks_of_thread(tid) == j.n_chunks_of_thread(tid)
        assert s.thread_iteration_indices(tid) \
            == j.thread_iteration_indices(tid)
        vals = s.thread_iteration_values(tid)
        assert vals == j.thread_iteration_values(tid)
        # the engine's grid formulas against the schedule's walk
        flat = [(v, rank) for row in sched.iteration_value_grid(s, tid)
                for g, v, rank, valid in row if valid]
        assert [v for v, _ in flat] == vals
        assert [r for _, r in flat] == list(range(len(vals)))
        for rank, v in enumerate(vals):
            assert s.local_rank(v) == j.local_rank(v) == rank


def test_dynamic_assignment_request_order_matches_jax():
    s = sched.ChunkSchedule(2, 9, 0, 1, 3)
    j = jax_sched.ChunkSchedule(2, 9, 0, 1, 3)
    order = [2, 2, 0, 1, 1, 0]
    assert s.dynamic_assignment(order) == j.dynamic_assignment(order)
    with pytest.raises(ValueError, match="shorter"):
        s.dynamic_assignment([0])


def test_journal_done_matches_jax(tmp_path):
    from pluss.resilience.journal import Journal as JaxJournal
    from pluss_torch.resilience.journal import Journal

    path = str(tmp_path / "j.jsonl")
    Journal(path).record({"a": 1}, v=2)
    assert Journal(path).done({"a": 1}) and JaxJournal(path).done({"a": 1})
    assert not Journal(path).done({"a": 2})
