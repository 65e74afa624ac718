"""The configuration ``syrk-1024`` and its cell ``syrk-1024.full``, on the
CPU at small sizes: the frozen spec is the registry's, the reference
equals the port where the interleave overlay does ``A``'s work, a tiny
``full`` cell of syrk runs ``correct`` through the harness and its traced
run reads the overlay window's two metrics, a program without the overlay
span reads neither, and the float32 control fails."""

import json
import math
import os

import numpy as np
import pytest

from benchmark import compare, harness
from conftest import ROOT, tiny_config
from test_bench_program_spans import _cpu_device  # noqa: F401 (a fixture)
from test_bench_reference import _ref

CELL = "syrk-1024.full"
OVERLAY_METRICS = {"overlay_window_s.host", "overlay_window_ms.host"}


def _bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _config() -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "syrk-1024.json")) as f:
        return json.load(f)


def test_the_configuration_is_polybench_syrk_1024():
    from pluss_torch import engine
    from pluss_torch.config import SamplerConfig
    from pluss_torch.models import REGISTRY
    from pluss_torch.spec_codec import spec_to_json
    conf = _config()
    assert conf["model"] == "syrk" and conf["n"] == 1024
    assert conf["reduced"] == [] and "statement_order" in conf["assumed"]
    spec = REGISTRY["syrk"](1024)
    assert conf["spec"] == spec_to_json(spec)
    cfg = SamplerConfig(thread_num=conf["thread_num"],
                        chunk_size=conf["chunk_size"], ds=conf["ds"],
                        cls=conf["cls"], cache_kb=conf["cache_kb"])
    pl = engine.plan(spec, cfg, build_templates=False)
    assert conf["accesses"] == pl.total_count == 2 * 1024**2 + 4 * 1024**3
    bench = _bench()
    entry = next(c for c in bench["configs"] if c["name"] == conf["name"])
    assert entry["reduced"] == conf["reduced"]
    assert entry["file"] == "benchmark/configs/syrk-1024.json"
    (cell,) = [w for w in bench["workloads"] if w["config"] == conf["name"]]
    assert (cell["name"], cell["traffic"], cell["chips"]) == \
        (CELL, "full", 1)
    for m in bench["per_layer"]:
        if m["name"] in OVERLAY_METRICS:
            assert m["workloads"] == [CELL]


def _port(n, T, CS, window_accesses):
    from pluss_torch import cri, engine, mrc
    from pluss_torch.config import SamplerConfig
    from pluss_torch.models import REGISTRY
    spec, cfg = REGISTRY["syrk"](n), SamplerConfig(thread_num=T,
                                                   chunk_size=CS)
    pl = engine.plan(spec, cfg, window_accesses=window_accesses)
    assert engine.plan_path(pl) == "template+overlay"
    res = engine.run(spec, cfg, device="cpu",
                     window_accesses=window_accesses)
    rih = cri.distribute(res.noshare_list(), res.share_list(), T)
    return spec, res, rih, mrc.aet_mrc(rih, cfg)


@pytest.mark.parametrize("n,T,CS,wa", [
    (64, 4, 4, None), (128, 4, 4, None), (128, 2, 8, None),
    (128, 4, 4, 1 << 14)])
def test_reference_equals_the_port_through_the_overlay(n, T, CS, wa):
    spec, res, rih, crv = _port(n, T, CS, wa)
    h, rrih, rcrv = _ref(spec, T, CS)
    share = [{int(v): float(c) for v, c in d.items()} for d in res.share_raw]
    assert compare.counts_off(res.noshare_list(), share,
                              res.max_iteration_count, h) == 0
    assert compare.cri_gap(rih, rrih) <= compare.LIMITS["cri_gap"]
    assert compare.mrc_gap(crv, rcrv) <= compare.LIMITS["mrc_gap"]


def _syrk_cell(root):
    """A tiny syrk ``full`` cell that reports what ``syrk-1024.full``
    reports."""
    cell = root.add(tiny_config("syrk", 32), "full")
    for m in root.doc["end_to_end"] + root.doc["per_layer"]:
        if "workloads" in m and CELL not in m["workloads"]:
            m["workloads"].remove(cell)
    root.save()
    return cell


def _run(root, cell, trace):
    return harness.run(root.path, cell, 2**31 + 19, 0.5, trace,
                       t_start=0.0, device="cpu")


def test_a_tiny_syrk_cell_runs_correct_and_reads_the_overlay(tiny_root,
                                                             _cpu_device):
    cell = _syrk_cell(tiny_root)
    out = _run(tiny_root, cell, False)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"setup_s", "pred_s.host",
                                   "pred_p90_s.host", "peak_gib"}
    out = _run(tiny_root, cell, True)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert OVERLAY_METRICS <= set(got)
    for name in OVERLAY_METRICS:
        assert math.isfinite(got[name]["value"]) and got[name]["value"] > 0
    # the overlay windows are part of the window loop
    assert got["overlay_window_s.host"]["value"] \
        < got["dispatch_s.host"]["value"]


def test_a_program_without_the_overlay_span_reads_none(tiny_root,
                                                       _cpu_device,
                                                       monkeypatch):
    """The commit before the span: the two metrics leave the line, nothing
    raises, and the run stays correct."""
    from pluss_torch import obs
    tally = obs.tally_span
    monkeypatch.setattr(obs, "tally_span", lambda name: obs.NOOP_SPAN
                        if name == "engine.overlay_window" else tally(name))
    cell = _syrk_cell(tiny_root)
    out = _run(tiny_root, cell, True)
    assert out["correct"], out["checks"]
    assert not set(out["metrics"]) & OVERLAY_METRICS
    assert "template_window_s.host" in out["metrics"]


def test_float32_control_fails_at_syrk_128():
    """The reference put in the program's place at float32 is not
    correct at syrk-128."""
    from pluss_torch.models import REGISTRY
    spec = REGISTRY["syrk"](128)
    _, rrih, rcrv = _ref(spec, 4, 4)
    _, crih, ccrv = _ref(spec, 4, 4, dtype=np.float32)
    nums = {"counts_off": 0, "cri_gap": compare.cri_gap(crih, rrih),
            "mrc_gap": compare.mrc_gap(ccrv, rcrv)}
    assert not compare.judge(nums), nums
