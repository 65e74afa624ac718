"""The harness end to end on the CPU at tiny sizes: every cell, mix and
metric is found by name from data, a throwaway configuration, mix and
metric need no edit of a file that is there, and ``correct`` falls when
the timed path is broken underneath."""

import functools
import json
import os
import sys

import pytest
import torch

from benchmark import harness, traffic
from conftest import ROOT, tiny_config


def run_cell(root, cell, seed=7, seconds=0.3, trace=False):
    return harness.run(root.path, cell, seed, seconds, trace,
                       t_start=0.0, device="cpu")


@pytest.mark.parametrize("traffic", ["full", "sampled", "sweep"])
def test_each_mix_runs_correct_on_the_cpu(tiny_root, traffic):
    cell = tiny_root.add(tiny_config("gemm", 32), traffic)
    out = run_cell(tiny_root, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) >= {"setup_s", "pred_s", "peak_gib"}
    assert list(out)[-1] == "checks"
    assert out["checks"]["counts_off"] == {"value": 0, "limit": 0}


def test_a_bounded_nest_runs_correct(tiny_root):
    cell = tiny_root.add(tiny_config("cholesky", 24), "full")
    assert run_cell(tiny_root, cell)["correct"]


def test_throwaway_config_mix_and_metric_need_no_edit(tiny_root):
    """A later cell is files and entries only: a new configuration, a new
    mix and a new metric reader, found by name."""
    mix = {"run": "sampled", "rate": 0.5, "check": 2,
           "plan_cache": False}
    cell = tiny_root.add(tiny_config("mvt", 24, T=2, CS=3), "halfsample",
                         mix)
    metric = os.path.join(tiny_root.path, "benchmark", "metrics",
                          "preds_seen.py")
    with open(metric, "w") as f:
        f.write("def read(run):\n    return float(run.n_preds)\n")
    tiny_root.doc["per_layer"].append({
        "name": "preds_seen", "unit": "1", "better": "higher",
        "source": "program_counter", "layer": "test", "moves": "pred_s",
        "workloads": [cell]})
    tiny_root.save()
    out = run_cell(tiny_root, cell, trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["preds_seen"]["value"] >= 1
    assert out["metrics"]["post_s"]["value"] > 0
    assert out["metrics"]["sampler_s"]["value"] > 0
    assert "device_idle" not in out["metrics"]   # no device on the CPU


def test_traced_full_run_reads_the_program_spans(tiny_root):
    cell = tiny_root.add(tiny_config("gemm", 16), "full")
    out = run_cell(tiny_root, cell, trace=True)
    assert out["correct"]
    assert out["metrics"]["dispatch_s"]["value"] > 0
    assert "plan_s" not in out["metrics"]   # the plan is memoized
    sweep = tiny_root.add(tiny_config("gemm", 16), "sweep")
    out = run_cell(tiny_root, sweep, trace=True)
    assert out["metrics"]["plan_s"]["value"] > 0


def _add_metric(root, cell, name, body):
    with open(os.path.join(root.path, "benchmark", "metrics", name + ".py"),
              "w") as f:
        f.write(body)
    root.doc["per_layer"].append({
        "name": name, "unit": "1", "better": "higher",
        "source": "program_counter", "layer": "test", "moves": "pred_s",
        "workloads": [cell]})
    root.save()


def test_a_dotted_name_reports_its_quantity(tiny_root):
    """``pred_s.mine`` is ``pred_s`` under a bound of its own, and
    ``post_s.mine`` reads with ``post_s``'s reader."""
    cell = tiny_root.add(tiny_config("gemm", 16), "full")
    tiny_root.doc["end_to_end"].append({
        "name": "pred_s.mine", "unit": "s", "better": "lower",
        "bound": 0.05, "source": "host_clock", "workloads": [cell]})
    tiny_root.doc["per_layer"].append({
        "name": "post_s.mine", "unit": "s", "better": "lower",
        "source": "program_span", "layer": "test", "moves": "pred_s.mine",
        "workloads": [cell]})
    tiny_root.save()
    out = run_cell(tiny_root, cell)
    assert out["metrics"]["pred_s.mine"] == out["metrics"]["pred_s"]
    assert run_cell(tiny_root, cell, trace=True)["metrics"][
        "post_s.mine"]["value"] > 0


def test_a_wrapped_sweep_still_plans_every_prediction(tiny_root):
    """Without the plan cache every prediction pays the plan, also once
    the schedule list wraps and the process's memo would hold it."""
    mix = {"run": "full", "schedules": [[2, 2], [1, 4]],
           "plan_cache": False, "check": 1}
    cell = tiny_root.add(tiny_config("gemm", 16), "twosched", mix)
    _add_metric(tiny_root, cell, "plans_per_pred",
                "def read(run):\n    return sum(n == 'engine.plan' for n, "
                "_ in run.spans) / run.n_preds\n")
    out = run_cell(tiny_root, cell, seconds=1.0, trace=True)
    assert out["correct"] and out["attempted"] > 2
    assert out["metrics"]["plans_per_pred"]["value"] == 1.0


def test_a_forbidden_module_after_the_window_means_no_result(
        tiny_root, monkeypatch, capsys):
    """The scan for jax and the JAX package runs after everything that
    follows the window, the metric readers included."""
    cell = tiny_root.add(tiny_config("gemm", 16), "full")
    _add_metric(tiny_root, cell, "loads_jax",
                "import sys, types\n\ndef read(run):\n"
                "    sys.modules.setdefault('jax', types.ModuleType('jax'))"
                "\n    return 1.0\n")
    monkeypatch.setattr(harness, "HERE",
                        os.path.join(tiny_root.path, "benchmark"))
    monkeypatch.setattr(harness, "cards", lambda: 1)
    monkeypatch.setattr(harness, "run",
                        functools.partial(harness.run, device="cpu"))
    had = "jax" in sys.modules
    try:
        with pytest.raises(SystemExit) as e:
            harness.main(["--workload", cell, "--seed", "3", "--seconds",
                          "0.2", "--trace", "1"], t_start=0.0)
    finally:
        if not had:
            sys.modules.pop("jax", None)
    assert "jax" in str(e.value)
    assert capsys.readouterr().out == ""


def test_a_mix_key_the_generator_does_not_know_is_refused():
    with pytest.raises(ValueError, match="mode"):
        traffic.check_mix({"run": "sampled", "rate": 0.1,
                           "mode": "prefix"}, tiny_config("gemm", 16))


def _break(monkeypatch, fault):
    """Plant one fault in the timed path (the program's code, as loaded
    in this process)."""
    from pluss_torch import engine, sampling
    if fault == "answer_altered":
        real = engine._finalize

        def finalize(pl, hist, plus, minus):
            hist = hist.copy()
            hist[0, 3] += 1
            return real(pl, hist, plus, minus)
        monkeypatch.setattr(engine, "_finalize", finalize)
    elif fault == "state_unchanged":
        monkeypatch.setattr(engine._Walk, "window",
                            lambda self, ni, si, w, rows: None)
    elif fault == "half_left_out":
        real = engine._Walk.window

        def window(self, ni, si, w, rows):
            # the thread rows' second half never walks
            half = rows.start + max(1, (rows.stop - rows.start) // 2)
            real(self, ni, si, w, slice(rows.start, half))
        monkeypatch.setattr(engine._Walk, "window", window)
    elif fault == "sample_altered":
        real = sampling.sampled_run

        def sampled_run(*a, **k):
            res = real(*a, **k)
            res.noshare_dense[1, 2] *= 1.5
            return res
        monkeypatch.setattr(sampling, "sampled_run", sampled_run)


@pytest.mark.parametrize("fault,traffic", [
    ("answer_altered", "full"), ("state_unchanged", "full"),
    ("half_left_out", "full"), ("half_left_out", "sweep"),
    ("sample_altered", "sampled")])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault,
                                            traffic):
    cell = tiny_root.add(tiny_config("gemm", 32), traffic)
    _break(monkeypatch, fault)
    out = run_cell(tiny_root, cell)
    assert not out["correct"], out["checks"]


def test_bench_json_names_files_that_exist():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        doc = json.load(f)
    for c in doc["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in doc["workloads"]:
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "traffic",
                                           w["traffic"] + ".json"))
    for m in doc["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "metrics",
                                           harness.quantity(m["name"])
                                           + ".py"))


def test_no_card_means_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "gemm-1024.full", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
