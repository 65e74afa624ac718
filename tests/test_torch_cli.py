"""The port's CLI vs the JAX package's: the same block below the banner.

``python -m pluss_torch.cli acc --cpu`` must print, line for line below the
timing banner, what ``python -m pluss.cli acc --cpu --backends vmap``
prints for the same model (the reference's differential ``acc`` test).
"""

import os
import subprocess
import sys

import pytest
import torch

from pluss import cli as jax_cli
from pluss_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def body(text: str) -> list[str]:
    lines = text.splitlines()
    assert lines[0].split(":")[0] in ("TPU VMAP", "TORCH CPU", "TORCH CUDA")
    return lines[1:]


@pytest.mark.parametrize("model,n", [("gemm", 16), ("atax", 12),
                                     ("syrk", 8)])
def test_acc_block_matches_jax_cli(model, n, capsys):
    jax_cli.main(["acc", "--cpu", "--backends", "vmap", "--model", model,
                  "--n", str(n)])
    want = capsys.readouterr().out
    assert cli.main(["acc", "--cpu", "--model", model, "--n", str(n)]) == 0
    got = capsys.readouterr().out
    assert got.startswith("TORCH CPU: ")
    assert body(got) == body(want)
    assert "max iteration traversed" in got


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
    jax_cli.main(["acc", "--cpu", "--backends", "vmap", "--model", "gemm",
                  "--n", "16"])
    assert body(out.stdout) == body(capsys.readouterr().out)


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
