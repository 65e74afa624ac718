"""The port's CLI vs the JAX package's: the same block below the banner.

``python -m pluss_torch.cli acc --cpu`` must print, line for line below the
timing banner, what ``python -m pluss.cli acc --cpu --backends vmap``
prints for the same model (the reference's differential ``acc`` test);
``trace --cpu`` must print what ``python -m pluss.cli trace --cpu`` prints
below its banner and write the same MRC CSV, byte for byte; ``sample
--cpu`` prints exactly what ``python -m pluss.cli sample --cpu`` prints.
``serve``, ``sweep`` and ``autotune`` run with jax and ``pluss`` blocked.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from pluss import cli as jax_cli
from pluss_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def body(text: str) -> list[str]:
    lines = text.splitlines()
    assert lines[0].split(":")[0] in ("TPU VMAP", "TORCH CPU", "TORCH CUDA",
                                      "TPU TRACE", "TORCH CPU TRACE",
                                      "TORCH CUDA TRACE")
    return lines[1:]


@pytest.mark.parametrize("model,n", [("gemm", 16), ("atax", 12),
                                     ("syrk", 8)])
def test_acc_block_matches_jax_cli(model, n, capsys):
    jax_cli.main(["acc", "--cpu", "--backends", "vmap", "--model", model,
                  "--n", str(n)])
    want = capsys.readouterr().out
    assert cli.main(["acc", "--cpu", "--backends", "vmap", "--model", model,
                     "--n", str(n)]) == 0
    got = capsys.readouterr().out
    assert got.startswith("TORCH CPU: ")
    assert body(got) == body(want)
    assert "max iteration traversed" in got


def test_profile_writes_a_chrome_trace_and_keeps_the_block(tmp_path,
                                                            capsys):
    """``--profile DIR`` writes one Chrome trace of the timed run into
    DIR; the block below the banner is the one printed without it."""
    argv = ["acc", "--cpu", "--backends", "vmap", "--model", "gemm",
            "--n", "16"]
    assert cli.main(argv) == 0
    want = capsys.readouterr().out
    prof = tmp_path / "prof"
    assert cli.main(argv + ["--profile", str(prof)]) == 0
    got = capsys.readouterr().out
    assert got.splitlines()[1:] == want.splitlines()[1:]
    assert got.startswith("TORCH CPU: ")
    traces = sorted(prof.iterdir())
    assert len(traces) == 1 and traces[0].suffix == ".json"
    doc = json.loads(traces[0].read_text())
    assert doc["traceEvents"]


def test_module_entry_runs_with_jax_and_pluss_blocked(capsys):
    """``python -m pluss_torch.cli`` in a fresh interpreter where importing
    jax or the pluss package fails: the port needs neither."""
    code = ("import runpy, sys; sys.modules['jax'] = None; "
            "sys.modules['pluss'] = None; "
            "sys.argv = ['pluss_torch.cli', 'acc', '--cpu', '--model', "
            "'gemm', '--n', '16']; "
            "runpy.run_module('pluss_torch.cli', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    # the default backends (vmap, shard, seq): three blocks, each the JAX
    # vmap block below its banner
    jax_cli.main(["acc", "--cpu", "--backends", "vmap", "--model", "gemm",
                  "--n", "16"])
    want = body(capsys.readouterr().out)
    blocks = out.stdout.split("TORCH CPU")[1:]
    assert [b.split(":")[0] for b in blocks] == ["", " SHARD", " SEQ"]
    for b in blocks:
        assert b.split("\n", 1)[1].splitlines() == want


def test_package_root_imports_with_jax_and_pluss_blocked():
    """``from pluss_torch import ...`` of every root name, in a fresh
    interpreter where importing jax or the pluss package fails."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['pluss'] = None; "
            "from pluss_torch import (SamplerConfig, DEFAULT, Loop, "
            "LoopNestSpec, Ref, ChunkSchedule, __version__); "
            "assert DEFAULT == SamplerConfig(); "
            "print(__version__, LoopNestSpec.__module__, "
            "ChunkSchedule.__module__)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0.1.0", "pluss_torch.spec",
                                  "pluss_torch.sched"]


@pytest.mark.parametrize("extra", [
    ["--n", "32", "--window", "1", "--rates", "0.5,1.0"],
    ["--n", "32", "--window", "1", "--rates", "0.5", "--sample-mode",
     "prefix"],
    ["--n", "32", "--window", "4096", "--context", "0", "--rates", "0.5"],
])
def test_sample_mode_matches_jax_cli(extra, capsys):
    jax_cli.main(["sample", "--cpu", "--model", "gemm", *extra])
    want = capsys.readouterr().out
    assert cli.main(["sample", "--cpu", "--model", "gemm", *extra]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert got.splitlines()[1] == "rate,walked_fraction,l2_error"


def test_sample_module_entry_runs_with_jax_and_pluss_blocked(capsys):
    code = ("import runpy, sys; sys.modules['jax'] = None; "
            "sys.modules['pluss'] = None; "
            "sys.argv = ['pluss_torch.cli', 'sample', '--cpu', '--model', "
            "'gemm', '--n', '16']; "
            "runpy.run_module('pluss_torch.cli', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    jax_cli.main(["sample", "--cpu", "--model", "gemm", "--n", "16"])
    assert out.stdout == capsys.readouterr().out


def test_start_point_matches_jax_cli(capsys):
    args = ["acc", "--cpu", "--model", "trmm", "--n", "16", "--start-point",
            "8", "--backends", "vmap"]
    jax_cli.main(args)
    want = capsys.readouterr().out
    assert cli.main(args) == 0
    assert body(capsys.readouterr().out) == body(want)


def test_speed_and_mrc_modes(tmp_path, capsys):
    assert cli.main(["speed", "--cpu", "--n", "16", "--reps", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len([l for l in lines if l.startswith("TORCH CPU: ")]) == 2
    mine, ref = tmp_path / "t.csv", tmp_path / "j.csv"
    cli.main(["mrc", "--cpu", "--n", "16", "--out", str(mine)])
    jax_cli.main(["mrc", "--cpu", "--backends", "vmap", "--n", "16",
                  "--out", str(ref)])
    assert mine.read_text() == ref.read_text()


def test_cli_without_cuda_or_cpu_flag_stops(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(["acc", "--n", "8"])
    assert e.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err


def write_trace(tmp_path, fmt):
    """A seeded two-region trace (hot/warm lines, then a far sweep)."""
    rng = np.random.default_rng(0)
    lines = np.concatenate([rng.integers(0, 1 << 12, 6000),
                            (1 << 30) + np.arange(3000) // 8])
    addrs = lines << 6
    if fmt == "u64":
        path = tmp_path / "t.bin"
        addrs.astype("<u8").tofile(path)
    else:
        path = tmp_path / "t.txt"
        path.write_text("\n".join(hex(int(a)) for a in addrs) + "\n")
    return str(path)


TRACE_GEO = ["--window", "2048", "--batch-windows", "2"]


@pytest.mark.parametrize("fmt,extra", [
    ("u64", []), ("u64", ["--wire", "d24v", "--feed-workers", "3"]),
    ("text", [])])
def test_trace_block_and_csv_match_jax_cli(tmp_path, capsys, fmt, extra):
    path = write_trace(tmp_path, fmt)
    out = str(tmp_path / "mrc.csv")
    args = ["trace", "--cpu", "--file", path, "--fmt", fmt, "--out", out,
            *TRACE_GEO]
    jax_cli.main(args + extra)
    want, want_csv = capsys.readouterr().out, open(out).read()
    os.unlink(out)
    assert cli.main(args + extra) == 0
    got = capsys.readouterr().out
    assert got.startswith("TORCH CPU TRACE: ")
    assert body(got) == body(want)
    assert body(got)[-1].startswith("9000 refs over ")
    assert open(out).read() == want_csv


def test_trace_journal_checkpoints_and_retires(tmp_path, capsys):
    path = write_trace(tmp_path, "u64")
    ckpt = str(tmp_path / "j.npz")
    assert cli.main(["trace", "--cpu", "--file", path, "--journal", ckpt,
                     "--resume", "--out", str(tmp_path / "m.csv"),
                     *TRACE_GEO]) == 0
    captured = capsys.readouterr()
    assert f"trace checkpoint at {ckpt} (resume on)" in captured.err
    assert "refs/s" in captured.err
    assert not os.path.exists(ckpt)   # the finished run retired it


class _Stop(Exception):
    pass


@pytest.mark.parametrize("cpu", [True, False])
def test_trace_on_the_card_never_takes_the_cpu_rung(tmp_path, monkeypatch,
                                                     cpu):
    """``cli trace`` replays through the trace ladder; on the card it stops
    before ``cpu_fallback``, so its banner and timing are the card's."""
    from pluss_torch import resilience

    seen = {}

    def fake(path, fmt, *, rungs, device, **kw):
        seen.update(rungs=rungs, device=device)
        raise _Stop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(resilience, "replay_file_resilient", fake)
    with pytest.raises(_Stop):
        cli.main(["trace", *(["--cpu"] if cpu else []), "--file",
                  write_trace(tmp_path, "u64")])
    assert seen["device"].type == ("cpu" if cpu else "cuda")
    want = resilience.ladder.TRACE_LADDER if cpu else ("serial_feed",
                                                "shrink_window")
    assert seen["rungs"] == want


def test_trace_without_file_stops(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["trace", "--cpu"])
    assert e.value.code == 2
    assert "requires --file" in capsys.readouterr().err


def test_trace_module_entry_runs_with_jax_and_pluss_blocked(tmp_path,
                                                            capsys):
    path = write_trace(tmp_path, "u64")
    out = str(tmp_path / "mrc.csv")
    argv = ["pluss_torch.cli", "trace", "--cpu", "--file", path, "--out",
            out, *TRACE_GEO]
    code = ("import runpy, sys; sys.modules['jax'] = None; "
            "sys.modules['pluss'] = None; "
            f"sys.argv = {argv!r}; "
            "runpy.run_module('pluss_torch.cli', run_name='__main__')")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    got_csv = open(out).read()
    jax_cli.main(["trace", "--cpu", "--file", path, "--out", out,
                  *TRACE_GEO])
    assert body(run.stdout) == body(capsys.readouterr().out)
    assert got_csv == open(out).read()


def test_stats_and_telemetry_run_with_jax_and_pluss_blocked(tmp_path):
    """``--telemetry`` writes a stream from a run with jax and pluss
    unimportable, and ``stats`` (check and render) reads it the same way:
    byte for byte what the JAX CLI prints on the same stream."""
    ev = str(tmp_path / "ev.jsonl")
    outs = []
    for argv in (["pluss_torch.cli", "acc", "--cpu", "--model", "gemm",
                  "--n", "16", "--telemetry", ev],
                 ["pluss_torch.cli", "stats", ev, "--check"],
                 ["pluss_torch.cli", "stats", ev]):
        code = ("import runpy, sys; sys.modules['jax'] = None; "
                "sys.modules['pluss'] = None; "
                f"sys.argv = {argv!r}; "
                "runpy.run_module('pluss_torch.cli', run_name='__main__')")
        run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=300)
        assert run.returncode == 0, run.stderr
        outs.append(run.stdout)
    assert "ok (" in outs[1]
    assert "engine.dispatch" in outs[2] and "engine.refs_processed" in outs[2]
    for argv, got in ((["stats", ev, "--check"], outs[1]),
                      (["stats", ev], outs[2])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert jax_cli.main(argv) == 0
        assert buf.getvalue() == got


# --- the static analysis modes ------------------------------------------------

def run_cli(main, argv):
    """(rc, stdout, stderr) of one in-process CLI call; a usage error is
    ``("exit", code)``."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = ("exit", e.code)
    return rc, out.getvalue(), err.getvalue()


ANALYSIS_CASES = [
    ["lint", "--all"],
    ["lint", "--all", "--json"],
    ["lint", "--model", "lu", "--n", "16"],
    *(["analyze", "--model", m, "--n", "16", *j]
      for m in ("gemm", "mvt", "syrk", "cholesky", "seidel2d")
      for j in ([], ["--json"])),
    ["analyze", "--model", "syrk", "--n", "16", "--cache-levels",
     "32:512:2560", "--assoc", "8", "--threads", "2"],
    ["predict", "--all", "--n", "16"],
    ["predict", "--all", "--n", "16", "--json"],
    ["predict", "gemm", "--n", "16", "--check", "--cpu"],
    ["predict", "mvt", "--n", "16", "--check", "--cpu", "--json"],
    ["cotenancy", "gemm+syrk", "--n", "16", "--check"],
    ["cotenancy", "gemm+syrk+mvt", "--n", "16", "--json",
     "--cache-kb", "16"],
    ["tune", "gemm", "--n", "16", "--check", "--cpu"],
    ["tune", "mvt", "--n", "16", "--json", "--window", "64"],
    ["tune", "syrk", "--n", "16", "--sweep-threads", "2,4",
     "--sweep-chunks", "2,8"],
    ["spec", "dump", "gemm"],
    ["spec", "dump", "cholesky", "--n", "16"],
]


@pytest.mark.parametrize("argv", ANALYSIS_CASES, ids=" ".join)
def test_analysis_modes_match_jax_cli(argv):
    want = run_cli(jax_cli.main, argv)
    got = run_cli(cli.main, argv)
    assert got[:2] == want[:2]
    assert got[1]


@pytest.mark.parametrize("mode", [["predict", "--all", "--n", "16"],
                                  ["lint", "--all"],
                                  ["analyze", "--model", "lu", "--n", "16"],
                                  ["tune", "gemm", "--n", "16"],
                                  ["cotenancy", "gemm+syrk", "--n", "16"]])
def test_sarif_logs_match_jax_cli(mode, tmp_path):
    from pluss_torch.analysis import sarif

    mine, ref = tmp_path / "t.sarif", tmp_path / "j.sarif"
    run_cli(jax_cli.main, mode + ["--sarif", str(ref)])
    rc, _, err = run_cli(cli.main, mode + ["--sarif", str(mine)])
    assert rc == 0 and "SARIF log at" in err
    assert mine.read_text() == ref.read_text()
    assert sarif.validate(json.loads(mine.read_text())) == []


def test_cotenancy_refusal_matches_jax_cli(monkeypatch):
    monkeypatch.setenv("PLUSS_PREDICT_BUDGET", "20000")
    argv = ["cotenancy", "gemm+lu", "--n", "16", "--check"]
    want = run_cli(jax_cli.main, argv)
    got = run_cli(cli.main, argv)
    assert got[:2] == want[:2]
    assert got[0] == 1 and "PL803" in got[1]


def test_spec_load_matches_jax_cli(tmp_path):
    path = tmp_path / "gemm.json"
    rc, text, _ = run_cli(cli.main, ["spec", "dump", "gemm", "--n", "16"])
    path.write_text(text)
    argv = ["spec", "load", str(path)]
    assert run_cli(cli.main, argv)[:2] == run_cli(jax_cli.main, argv)[:2]
    want = run_cli(jax_cli.main, argv + ["--run", "--cpu"])
    got = run_cli(cli.main, argv + ["--run", "--cpu"])
    assert got[0] == want[0] == 0
    assert got[1].startswith("TORCH CPU IMPORT gemm16: ")
    assert want[1].startswith("TPU IMPORT gemm16: ")
    assert got[1].splitlines()[1:] == want[1].splitlines()[1:]
    # and the loaded spec's block is the acc block of the same model
    acc = run_cli(cli.main, ["acc", "--cpu", "--backends", "vmap", "--model",
                             "gemm", "--n", "16"])
    assert got[1].splitlines()[1:] == acc[1].splitlines()[1:]


@pytest.mark.parametrize("text", ["{not json", '{"name": "x"}'])
def test_spec_load_refusal_matches_jax_cli(text, tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(text)
    for argv in (["spec", "load", str(path)],
                 ["spec", "load", str(tmp_path / "missing.json")]):
        want = run_cli(jax_cli.main, argv)
        got = run_cli(cli.main, argv)
        assert got[0] == want[0] == 1 and got[1] == want[1] == ""
        assert got[2].split(": ", 1)[1] == want[2].split(": ", 1)[1]


@pytest.mark.parametrize("mode", ["acc", "mrc", "sample"])
def test_verify_matches_jax_cli(mode, tmp_path):
    extra = {"acc": [], "mrc": ["--out", str(tmp_path / "m.csv")],
             "sample": ["--rates", "1.0"]}[mode]
    argv = [mode, "--cpu", "--verify", "--model", "trmm", "--n", "16",
            *extra]
    want = run_cli(jax_cli.main, argv + ["--backends", "vmap"])
    got = run_cli(cli.main, argv + ["--backends", "vmap"])
    assert got[0] == want[0] == 0
    if mode == "acc":
        assert body(got[1]) == body(want[1])
    else:
        assert got[1] == want[1]
    # the analyzer's findings go to stderr, as in the JAX CLI
    findings = [l for l in want[2].splitlines() if "[PL" in l]
    assert findings and [l for l in got[2].splitlines()
                         if "[PL" in l] == findings


def test_verify_refuses_a_spec_with_errors(monkeypatch):
    from pluss_torch import analysis
    from pluss_torch.analysis.diagnostics import Diagnostic, Severity

    def broken(spec, cfg):
        return [Diagnostic("PL101", Severity.ERROR, "out of bounds")], None

    monkeypatch.setattr(analysis, "analyze_spec", broken)
    monkeypatch.setattr(cli.engine, "run", lambda *a, **k: pytest.fail(
        "--verify let a refused spec run"))
    rc, out, err = run_cli(cli.main, ["acc", "--cpu", "--verify", "--n",
                                      "8"])
    assert rc == 2 and out == ""
    assert "refusing to run" in err and "PL101" in err


@pytest.mark.parametrize("argv", [
    ["lint", "gemm"], ["analyze", "gemm"], ["acc", "gemm"],
    ["trace", "t.bin"], ["lint", "--all", "x", "y"],
    ["predict", "nosuch"], ["predict", "gemm", "--all"],
    ["tune", "nosuch"], ["tune", "gemm", "--sweep-threads", "a"],
    ["cotenancy"], ["cotenancy", "gemm"], ["cotenancy", "gemm+"],
    ["cotenancy", "gemm+nosuch"],
    ["cotenancy", "gemm+syrk", "--cache-kb", "64", "--cache-levels", "32"],
    ["spec"], ["spec", "show"], ["spec", "dump"], ["spec", "dump", "nosuch"],
    ["spec", "load"],
    ["import"], ["import", "x.c", "--check-model", "nosuch"],
    ["transform"], ["transform", "nosuch", "--interchange", "0,1"],
    ["transform", "gemm", "--n", "16"],
    ["transform", "gemm", "--interchange", "0,1", "--tile", "0:4"],
    ["transform", "gemm", "--interchange", "0"],
    ["transform", "gemm", "--tile", "0-4"], ["transform", "gemm", "--fuse",
                                             "0"],
    ["tune", "--all", "--transforms", "--n", "16"],
])
def test_usage_errors_match_jax_cli(argv):
    want = run_cli(jax_cli.main, argv)
    got = run_cli(cli.main, argv)
    assert got[0] == want[0] == ("exit", 2)
    want_err = want[2].splitlines()[-1].split(": error: ", 1)[1]
    got_err = got[2].splitlines()[-1].split(": error: ", 1)[1]
    assert got_err == want_err


def test_host_modes_need_no_card(monkeypatch, tmp_path):
    """The analysis modes run with no card and no --cpu; the engine runs
    of ``--check`` and ``spec load --run`` stop instead of moving to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(cli.engine, "run", lambda *a, **k: pytest.fail(
        "a host mode ran the engine"))
    path = tmp_path / "s.json"
    for argv in (["lint", "--all"], ["analyze", "--n", "16"],
                 ["predict", "gemm", "--n", "16"],
                 ["cotenancy", "gemm+syrk", "--n", "16", "--check"],
                 ["tune", "gemm", "--n", "16"],
                 ["spec", "dump", "gemm", "--n", "16"],
                 ["spec", "load", str(path)]):
        rc, out, _ = run_cli(cli.main, argv)
        assert rc == 0, argv
        if argv[:2] == ["spec", "dump"]:
            path.write_text(out)
    for argv in (["predict", "gemm", "--n", "16", "--check"],
                 ["tune", "gemm", "--n", "16", "--check"],
                 ["spec", "load", str(path), "--run"]):
        rc, out, err = run_cli(cli.main, argv)
        assert rc == ("exit", 2) and out == "", argv
        assert "no CUDA device" in err


def test_analysis_modes_run_with_jax_and_pluss_blocked(capsys):
    for argv in (["predict", "--all", "--n", "16"], ["lint", "--all"]):
        code = ("import runpy, sys; sys.modules['jax'] = None; "
                "sys.modules['pluss'] = None; "
                f"sys.argv = {['pluss_torch.cli', *argv]!r}; "
                "runpy.run_module('pluss_torch.cli', run_name='__main__')")
        run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=300)
        assert run.returncode == 0, run.stderr
        assert jax_cli.main(argv) == 0
        assert run.stdout == capsys.readouterr().out


# --- the authoring and transform modes ----------------------------------------

def gemm_c(tmp_path, n=16, stem=None):
    from pluss_torch.frontend import polybench

    src = open(polybench.gemm_source_path()).read()
    path = tmp_path / f"{stem or f'gemm{n}'}.c"
    path.write_text(src.replace("#define N 128", f"#define N {n}"))
    return str(path)


DSL_NEST = (
    "from pluss import frontend\n"
    "with frontend.kernel('tiny'):\n"
    "    A = frontend.array('A', 16)\n"
    "    B = frontend.array('B', (4, 4), dtype='f32')\n"
    "    with frontend.loop('i', 0, 16, parallel=True) as i:\n"
    "        frontend.read(A, i)\n"
    "        frontend.write(A, i)\n"
    "    with frontend.loop('i', 0, 4, parallel=True) as i:\n"
    "        with frontend.loop('j', 0, i + 1) as j:\n"
    "            frontend.read(B, i, j)\n"
    "with frontend.kernel('second'):\n"
    "    C = frontend.array('C', 8)\n"
    "    with frontend.loop('i', 0, 8, parallel=True) as i:\n"
    "        frontend.write(C, i)\n")


def source(tmp_path, kind):
    if kind == "c":
        return gemm_c(tmp_path)
    path = tmp_path / "nest.py"
    path.write_text(DSL_NEST)
    return str(path)


@pytest.mark.parametrize("extra", [["--json"], ["--predict"],
                                   ["--json", "--predict", "--verify"]])
@pytest.mark.parametrize("kind", ["c", "py"])
def test_import_matches_jax_cli(tmp_path, kind, extra):
    argv = ["import", source(tmp_path, kind), *extra]
    want = run_cli(jax_cli.main, argv)
    got = run_cli(cli.main, argv)
    assert got[:2] == want[:2] and got[0] == 0
    # stderr: the same lines below the mode's own prefix
    assert [l.split(": ", 1)[1] for l in got[2].splitlines()] == \
        [l.split(": ", 1)[1] for l in want[2].splitlines()]


@pytest.mark.parametrize("check", [[], ["--check-model", "gemm"]])
def test_import_run_matches_jax_cli(tmp_path, check):
    argv = ["import", gemm_c(tmp_path), "--run", "--cpu", "--n", "16",
            *check]
    want = run_cli(jax_cli.main, argv)
    got = run_cli(cli.main, argv)
    assert got[0] == want[0] == 0
    assert got[1].startswith("TORCH CPU IMPORT gemm16: ")
    assert got[1].splitlines()[1:] == want[1].splitlines()[1:]
    if check:
        assert "byte-identical to registry gemm(16)" in got[2]


def test_import_check_model_divergence_matches_jax_cli(tmp_path):
    argv = ["import", gemm_c(tmp_path), "--run", "--cpu", "--n", "12",
            "--check-model", "gemm"]
    want = run_cli(jax_cli.main, argv)
    got = run_cli(cli.main, argv)
    assert got[0] == want[0] == 1
    assert got[1].splitlines()[1:] == want[1].splitlines()[1:]
    assert "DIVERGES from registry gemm(12) (histograms !=, MRC !=)" \
        in got[2]


def test_import_register_matches_jax_cli(tmp_path):
    src = source(tmp_path, "py")
    mine, theirs = tmp_path / "t", tmp_path / "j"
    want = run_cli(jax_cli.main, ["import", src, "--register",
                                  "--registry-dir", str(theirs)])
    got = run_cli(cli.main, ["import", src, "--register",
                             "--registry-dir", str(mine)])
    assert got[:2] == want[:2] == (0, "")
    assert "registered tiny ->" in got[2]
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs)) == \
        ["second.json", "tiny.json"]
    for fn in os.listdir(mine):
        assert (mine / fn).read_text() == (theirs / fn).read_text()


@pytest.mark.parametrize("text", [
    "#define N 8\ndouble A[N];\n#pragma pluss parallel\n"
    "for (i = 0; i < N; i++) A[i * i] = 1.0;\n",
    "#define N 8\ndouble A[N];\n#pragma pluss parallel\n"
    "for (i = 0; i < N; i++) A[i + 4] = 1.0;\n",
])
def test_import_rejection_matches_jax_cli(tmp_path, text):
    path = tmp_path / "bad.c"
    path.write_text(text)
    argv = ["import", str(path), "--run", "--cpu"]
    want = run_cli(jax_cli.main, argv)
    got = run_cli(cli.main, argv)
    assert got[:2] == want[:2] == (1, "")
    assert got[2].splitlines()[:-1] == want[2].splitlines()[:-1]
    assert got[2].splitlines()[-1].split(": ", 1)[1] == \
        want[2].splitlines()[-1].split(": ", 1)[1]


TRANSFORM_CASES = [
    ["transform", "gemm", "--n", "16", "--interchange", "0,2"],
    ["transform", "gemm", "--n", "16", "--interchange", "0,2", "--json"],
    ["transform", "gemm", "--n", "16", "--tile", "0:4,1:4,2:4", "--json"],
    ["transform", "gemm", "--n", "16", "--tile", "2:4"],
    ["transform", "syrk", "--n", "16", "--interchange", "0,1", "--json"],
    ["transform", "2mm", "--n", "16", "--fuse", "0+1"],
    ["transform", "mvt", "--n", "16", "--fuse", "0+1", "--json"],
    ["transform", "seidel2d", "--n", "8", "--interchange", "0,1"],
    ["transform", "seidel2d", "--n", "16", "--interchange", "0,1",
     "--json", "--check"],
    ["transform", "trmm", "--n", "8", "--interchange", "0,1"],
    ["transform", "3mm", "--n", "16", "--fuse", "1+2", "--json"],
    ["transform", "gemm", "--n", "16", "--interchange", "0,2", "--check",
     "--cpu"],
    ["transform", "gemm", "--n", "16", "--tile", "0:4,1:4,2:4", "--check",
     "--cpu", "--json"],
    ["tune", "gemm", "--transforms", "--n", "16", "--sweep-threads", "1,2",
     "--sweep-chunks", "1"],
    ["tune", "gemm", "--transforms", "--n", "16", "--json"],
    ["tune", "mvt", "--transforms", "--n", "16", "--check", "--cpu"],
]


@pytest.mark.parametrize("argv", TRANSFORM_CASES, ids=" ".join)
def test_transform_modes_match_jax_cli(argv):
    want = run_cli(jax_cli.main, argv)
    got = run_cli(cli.main, argv)
    assert got[:2] == want[:2]
    assert got[1]
    assert [l.split(": ", 1)[1] for l in got[2].splitlines()] == \
        [l.split(": ", 1)[1] for l in want[2].splitlines()]


def test_tune_transforms_check_runs_the_transformed_winner(monkeypatch):
    """At a 1 KB LLC a tiled gemm-64 schedule wins; ``--check`` runs it
    once on the engine, as JAX's does."""
    argv = ["tune", "gemm", "--transforms", "--n", "64", "--cache-kb", "1",
            "--sweep-threads", "1,2,4", "--sweep-chunks", "1,4", "--check",
            "--cpu", "--json"]
    want = run_cli(jax_cli.main, argv)
    got = run_cli(cli.main, argv)
    assert got[:2] == want[:2] and got[0] == 0
    assert json.loads(got[1])["best_transform"].startswith("tile(")
    assert "transformed winner tile(" in got[2] and "verified" in got[2]


@pytest.mark.parametrize("argv", [
    ["transform", "gemm", "--n", "16", "--interchange", "0,2"],
    ["transform", "seidel2d", "--n", "8", "--interchange", "0,1"],
    ["tune", "gemm", "--transforms", "--n", "16"],
])
def test_transform_sarif_matches_jax_cli(argv, tmp_path):
    from pluss_torch.analysis import sarif

    mine, ref = tmp_path / "t.sarif", tmp_path / "j.sarif"
    run_cli(jax_cli.main, argv + ["--sarif", str(ref)])
    _, _, err = run_cli(cli.main, argv + ["--sarif", str(mine)])
    assert "SARIF log at" in err
    assert mine.read_text() == ref.read_text()
    assert sarif.validate(json.loads(mine.read_text())) == []


def test_transform_register_matches_jax_cli(tmp_path):
    argv = ["transform", "gemm", "--n", "32", "--tile", "0:8,1:8,2:8",
            "--register", "--registry-dir"]
    want = run_cli(jax_cli.main, argv + [str(tmp_path / "j")])
    got = run_cli(cli.main, argv + [str(tmp_path / "t")])
    assert got[:2] == want[:2] and got[0] == 0
    assert "registered gemm32_tile0x8_1x8_2x8" in got[2]
    fn = "gemm32_tile0x8_1x8_2x8.json"
    assert (tmp_path / "t" / fn).read_text() == \
        (tmp_path / "j" / fn).read_text()


def test_authoring_modes_need_no_card(monkeypatch, tmp_path):
    """``import`` and ``transform`` are host work with no card and no
    --cpu; their engine runs stop instead of moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = gemm_c(tmp_path)
    for argv in (["import", src, "--json", "--predict"],
                 ["import", src, "--register", "--registry-dir",
                  str(tmp_path / "r")],
                 ["transform", "gemm", "--n", "16", "--interchange", "0,2"],
                 ["tune", "gemm", "--transforms", "--n", "16"]):
        rc, out, _ = run_cli(cli.main, argv)
        assert rc == 0 and bool(out) != ("--register" in argv), argv
    assert os.listdir(tmp_path / "r") == ["gemm16.json"]
    monkeypatch.setattr(cli.engine, "run", lambda *a, **k: pytest.fail(
        "an engine run without a card"))
    for argv in (["import", src, "--run"],
                 ["import", src, "--check-model", "gemm", "--n", "16"],
                 ["transform", "gemm", "--n", "16", "--interchange", "0,2",
                  "--check"],
                 ["tune", "gemm", "--transforms", "--n", "64", "--cache-kb",
                  "1", "--sweep-threads", "1,2,4", "--sweep-chunks", "1,4",
                  "--check"]):
        rc, _, err = run_cli(cli.main, argv)
        assert rc == ("exit", 2), argv
        assert "no CUDA device" in err


def test_import_and_spec_dir_run_with_jax_and_pluss_blocked(tmp_path,
                                                           capsys):
    """With jax and pluss unimportable: ``import`` of a DSL file that says
    ``from pluss import frontend``, ``--register`` into a directory, and
    that directory as ``PLUSS_SPEC_DIR`` read at import, so ``--model``
    takes the registered name."""
    src = source(tmp_path, "py")
    reg = str(tmp_path / "reg")

    def blocked(argv, env=None):
        code = ("import runpy, sys; sys.modules['jax'] = None; "
                "sys.modules['pluss'] = None; "
                f"sys.argv = {['pluss_torch.cli', *argv]!r}; "
                "runpy.run_module('pluss_torch.cli', run_name='__main__')")
        run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=300,
                             env={**os.environ, **(env or {})})
        assert run.returncode == 0, run.stderr
        return run

    run = blocked(["import", src, "--json", "--register", "--registry-dir",
                   reg])
    assert jax_cli.main(["import", src, "--json"]) == 0
    assert run.stdout == capsys.readouterr().out
    run = blocked(["acc", "--cpu", "--backends", "vmap", "--model", "tiny",
                   "--n", "16"], env={"PLUSS_SPEC_DIR": reg})
    assert "ignoring n=16" in run.stderr
    assert jax_cli.main(["import", src, "--run", "--cpu"]) == 0
    want = capsys.readouterr().out.split("TPU IMPORT second")[0]
    assert run.stdout.startswith("TORCH CPU: ")
    assert run.stdout.splitlines()[1:] == want.splitlines()[1:]
    # without the env the name is no model
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['pluss'] = None; "
            "from pluss_torch.models import REGISTRY; "
            "print('tiny' in REGISTRY, 'second' in REGISTRY)")
    for env, want in ((None, "False False"), (reg, "True True")):
        run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=300,
                             env={**{k: v for k, v in os.environ.items()
                                     if k != "PLUSS_SPEC_DIR"},
                                  **({"PLUSS_SPEC_DIR": env} if env
                                     else {})})
        assert run.stdout.strip() == want, run.stderr


# --- the serving daemon, the sweep and the autotuner -------------------------

BLOCKED = ("import runpy, sys; sys.modules['jax'] = None; "
           "sys.modules['pluss'] = None; sys.argv = {argv!r}; "
           "runpy.run_module('pluss_torch.cli', run_name='__main__')")


def test_serve_runs_with_jax_and_pluss_blocked(tmp_path):
    """``serve --cpu --socket`` in a fresh interpreter where importing jax
    or the pluss package fails: it answers a request equal to the port's
    solo run, and a shutdown line drains it to exit 0."""
    from pluss_torch import cri, engine
    from pluss_torch.config import SamplerConfig
    from pluss_torch.models import gemm
    from pluss_torch.serve import Client

    sock = str(tmp_path / "p.sock")
    code = BLOCKED.format(argv=["pluss_torch.cli", "serve", "--cpu",
                                "--socket", sock])
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(sock):
            assert proc.poll() is None, proc.communicate()[1]
            assert time.monotonic() < deadline, "daemon never listened"
            time.sleep(0.1)
        with Client(sock) as c:
            r = c.request({"model": "gemm", "n": 12, "threads": 2,
                           "chunk": 2, "output": "histogram"})
            assert c.request({"op": "shutdown"})["draining"]
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "listening on" in err and "drained and stopped" in err
    cfg = SamplerConfig(thread_num=2, chunk_size=2)
    res = engine.run(gemm(12), cfg, device="cpu")
    ri = cri.distribute(res.noshare_list(), res.share_list(), 2)
    assert r["ok"] and r["histogram"] == {str(int(k)): float(v)
                                          for k, v in sorted(ri.items())}


@pytest.mark.parametrize("argv", [
    ["sweep", "--cpu", "--model", "gemm", "--n", "12",
     "--sweep-threads", "1,2", "--sweep-chunks", "4"],
    ["autotune", "--dry-run", "--cpu"],
])
def test_sweep_and_autotune_run_with_jax_and_pluss_blocked(argv, capsys):
    run = subprocess.run(
        [sys.executable, "-c",
         BLOCKED.format(argv=["pluss_torch.cli", *argv])],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert cli.main(argv) == 0
    assert run.stdout == capsys.readouterr().out


@pytest.mark.parametrize("argv", [["serve", "--socket", "/tmp/x.sock"],
                                  ["sweep", "--n", "8"],
                                  ["autotune", "--dry-run"]])
def test_serve_sweep_autotune_need_a_card_or_cpu(argv, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit):
        cli.main(argv)
    assert "no CUDA device" in capsys.readouterr().err


def test_serve_usage_errors(capsys, tmp_path):
    with pytest.raises(SystemExit):
        cli.main(["serve", "--cpu"])
    assert "exactly one of --socket/--port" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(["serve", "--cpu", "--socket", str(tmp_path / "h.sock"),
                  "--port", "0", "--heartbeat-dir", str(tmp_path)])
    assert "exactly one of --socket/--port" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(["autotune", "--cpu", "--force", "--dry-run"])
