"""The port's soak harness (``python -m pluss_torch.soak``) on the CPU.

Each mode runs with ``--cpu`` at a small count in a subprocess (the modes
point the plan cache, the telemetry session and the fault injector at
their own temp dirs, which must not leak into this test process) and must
exit 0: the property soak, the chaos soak with its sweep-kill recovery,
and the serve soak, whose phases (shed burst, mixed requests, repeated
trace, crash/recover, placement on and off, observability) each print
their line in the JAX soak's order and whose telemetry stream then
passes ``cli stats --check``.  Without ``--cpu`` and without a card
every mode raises before any run; the chaos soak also runs with ``jax``,
``pluss`` and ``tests`` blocked.
"""

import os
import re
import shutil
import subprocess
import sys
import tempfile

import pytest
import torch

from pluss_torch import engine, soak

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def soak_tmp():
    """A temp dir for a soak's own temp files, short enough for the serve
    soak's unix socket path (at most 107 bytes; pytest's per-test dirs
    under several workers are longer)."""
    d = tempfile.mkdtemp(prefix="soak")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def run_soak(tmp, *args, code=None):
    """``python -m pluss_torch.soak ARGS`` (or ``python -c CODE``) with
    its temp files under ``tmp``."""
    env = {**os.environ, "TMPDIR": str(tmp)}
    cmd = [sys.executable, "-c", code] if code else \
        [sys.executable, "-m", "pluss_torch.soak", *args]
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=400)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def test_property_soak_on_the_cpu(soak_tmp):
    out = run_soak(soak_tmp, "6", "11", "--cpu")
    assert "soak seed 11" in out
    for name in ("specs", "schedules", "shard"):
        assert re.search(rf"^soak {name}: \d+ examples OK", out, re.M), out
    assert re.search(r"^property soak: 6 examples on cpu, \d+ refused "
                     r"alike, .* seed 11; launches \{", out, re.M), out


def test_chaos_soak_and_sweep_kill_on_the_cpu(soak_tmp):
    out = run_soak(soak_tmp, "--chaos", "4", "14", "--cpu")
    rounds = re.findall(r"^chaos\[(\d)\] \w+ plan=\S*: (bit-exact|classified"
                        r" \w+)", out, re.M)
    assert [int(i) for i, _ in rounds] == [0, 1, 2, 3], out
    m = re.search(r"^chaos sweep-kill: (\d+) point\(s\) journaled before "
                  r"the kill; resumed sweep restored (\d+), recomputed (\d+)"
                  r" .* curves bit-identical vs clean serial$", out, re.M)
    assert m, out
    journaled, restored, recomputed = map(int, m.groups())
    assert restored == journaled and recomputed == 8 - journaled
    assert re.search(r"^chaos telemetry: \d+ fault\(s\) fired", out, re.M)
    assert re.search(r"^chaos soak: 4 rounds, 0 failure\(s\), seed 14 on "
                     r"cpu", out, re.M), out


def test_serve_soak_and_its_stream_on_the_cpu(soak_tmp, tmp_path):
    tel = str(tmp_path / "serve.jsonl")
    out = run_soak(soak_tmp, "--serve", "6", "5", "--telemetry", tel,
                   "--cpu")
    assert re.search(r"shed burst -> [1-9]\d* Overloaded", out), out
    assert re.search(r"^serve soak: 6 mixed requests .* 6 ok, [1-9]\d* "
                     r"degraded via the ladder, 0 divergence", out, re.M), out
    # the later phases, in the JAX soak's order
    m = re.search(r"^serve soak: repeated trace cold ([\d.]+) ms -> warm "
                  r"([\d.]+) ms \(([\d.]+)x\)$", out, re.M)
    assert m, out
    cold, warm, _ = map(float, m.groups())
    assert cold >= 5.0 * max(warm, 50.0), out
    assert re.search(r"^serve soak: crash/recover -> 3 entries replayed \(3 "
                     r"counted\), [0-2] device dispatch\(es\), recovered "
                     r"responses bit-identical to solo$", out, re.M), out
    choices = dict(re.findall(
        r"^serve soak: placement=(on|off) -> 9 adversarial-mix responses "
        r"bit-identical to solo, (\d+) placement choice\(s\) "
        r"\(gemm16,mvt16,syrk12; interference advisory on\)$", out, re.M))
    assert int(choices["on"]) >= 1 and int(choices["off"]) == 0, out
    assert re.search(r"^serve soak: obs phase -> breaker flight dump "
                     r"checked, 4 of 4 traced rids resolved to span trees, "
                     r"/metrics == rollup, 0 browned out$", out, re.M), out
    order = [out.index(s) for s in (
        "mixed requests", "repeated trace", "crash/recover", "placement=on",
        "placement=off", "obs phase", "0 failure(s)")]
    assert order == sorted(order), out
    assert "FAIL" not in out, out
    assert re.search(r"^serve soak: 0 failure\(s\), seed 5 on cpu", out,
                     re.M), out
    # one summary line with the launches, which chip_smoke.py reads
    assert len([ln for ln in out.splitlines()
                if re.search(r"launches \{", ln)]) == 1, out
    check = subprocess.run(
        [sys.executable, "-m", "pluss_torch.cli", "stats", tel, "--check"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert check.returncode == 0, check.stderr
    assert check.stdout.startswith(f"pluss stats: {tel}: ok")


@pytest.mark.parametrize("argv", [["1", "0"], ["--chaos", "1", "0"],
                                  ["--serve", "1", "0"]],
                         ids=["property", "chaos", "serve"])
def test_a_mode_without_cpu_needs_the_card(argv, monkeypatch):
    """No card and no ``--cpu``: the mode raises before any run, and
    nothing falls back to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def ran(*a, **k):
        raise AssertionError("a soak ran without a device")

    monkeypatch.setattr(engine, "run", ran)
    env = dict(os.environ)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        soak.main(argv)
    assert dict(os.environ) == env


def test_chaos_soak_runs_with_jax_pluss_and_tests_blocked(soak_tmp):
    code = ("import runpy, sys; sys.modules['jax'] = None; "
            "sys.modules['pluss'] = None; sys.modules['tests'] = None; "
            "sys.argv = ['pluss_torch.soak', '--chaos', '1', '0', '--cpu']; "
            "runpy.run_module('pluss_torch.soak', run_name='__main__')")
    out = run_soak(soak_tmp, code=code)
    assert re.search(r"^chaos soak: 1 rounds, 0 failure\(s\), seed 0 on cpu",
                     out, re.M), out
