"""Trace configurations on the CPU at a test's size: the writer against
PolyBench's mvt enumerated by hand and the loop-nest reference at one
thread, the reference against the port and hand-worked answers, both
replay mixes through the whole harness, ``correct`` falling when the
replay is broken underneath or computed in float32, the counters a reader
sees, the trace file's lifetime, and the cells of the loop nests printing
what they printed before the harness learned traces."""

import glob
import json
import os
import tempfile

import numpy as np
import pytest

from benchmark import compare, control, harness, kernels, tracedata, traffic
from benchmark.reference import trace as ref_trace
from conftest import ROOT, tiny_config, tiny_trace_config

MIXES = {"replay": "mvt-4000-trace.streamed",
         "replay_resident": "mvt-4000-trace.resident"}


def _bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _add_trace_cell(root, mix):
    """A tiny trace cell that reports what the real cell of ``mix``
    reports."""
    cell = root.add(tiny_trace_config(), mix)
    real = MIXES[mix]
    for m in root.doc["end_to_end"] + root.doc["per_layer"]:
        if "workloads" in m and real not in m["workloads"]:
            m["workloads"].remove(cell)
    root.save()
    return cell


def _add_metric(root, cell, name, body):
    with open(os.path.join(root.path, "benchmark", "metrics", name + ".py"),
              "w") as f:
        f.write(body)
    root.doc["per_layer"].append({
        "name": name, "unit": "1", "better": "higher",
        "source": "program_counter", "layer": "test", "moves": "pred_s",
        "workloads": [cell]})
    root.save()


def _run(root, cell, seed=2**31 + 7, seconds=0.5, trace=False):
    return harness.run(root.path, cell, seed, seconds, trace, t_start=0.0,
                       device="cpu")


def _write(path, layout, seed):
    with open(path, "wb") as f:
        tracedata.write(f, layout, traffic.trace_rng(seed), "cpu")


def test_the_configuration_is_mvt_4000():
    from pluss_torch.models import REGISTRY
    from pluss_torch.spec_codec import spec_to_json
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "mvt-4000-trace.json")) as f:
        conf = json.load(f)
    assert conf["kind"] == "trace" and conf["reduced"] == []
    assert conf["spec"] == spec_to_json(REGISTRY["mvt"](4000))
    assert tracedata.refs(conf) == conf["refs"] == 2 * 4000 * 4000 * 4
    entry = next(c for c in _bench()["configs"] if c["name"] == conf["name"])
    assert entry["reduced"] == conf["reduced"]
    assert kernels.masked_hist_replay_bytes(conf["refs"]) == \
        conf["refs"] * 7 + 49 * 8


def _mvt_by_hand(n: int, base: dict) -> np.ndarray:
    """PolyBench's mvt, one statement at a time: ``x1[i] = x1[i] +
    A[i][j] * y1[j]``, then ``x2[i] = x2[i] + A[j][i] * y2[j]``, each
    statement's refs in the registry's order (A, y, x read, x write)."""
    out = []
    for x, y, a in (("x1", "y1", lambda i, j: i * n + j),
                    ("x2", "y2", lambda i, j: j * n + i)):
        for i in range(n):
            for j in range(n):
                out += [base["A"] + 8 * a(i, j), base[y] + 8 * j,
                        base[x] + 8 * i, base[x] + 8 * i]
    return np.array(out, "<u8")


def test_the_writer_is_the_programs_references_in_order(tmp_path):
    layout = tiny_trace_config(7)
    rng = np.random.default_rng(11)
    base = tracedata.bases(layout, rng)
    path = tmp_path / "t.u64"
    with open(path, "wb") as f:
        tracedata.write(f, layout, np.random.default_rng(11))
    assert path.read_bytes() == _mvt_by_hand(7, base).tobytes()
    assert os.path.getsize(path) == 8 * tracedata.refs(layout)


def test_the_bases_are_pages_apart_and_the_seeds_own(tmp_path):
    """Page-aligned, no two arrays' pages shared, inside the drawn range;
    another seed moves them, and the histogram stays."""
    layout = tiny_trace_config(1000)   # A spans 1954 pages
    pages = {a: -(-n * 8 // tracedata.PAGE) for a, n in
             layout["spec"]["arrays"]}
    got = set()
    for seed in range(20):
        base = tracedata.bases(layout, traffic.trace_rng(seed))
        got.add(tuple(base.values()))
        span = sorted((b, b + pages[a] * tracedata.PAGE)
                      for a, b in base.items())
        assert all(b % tracedata.PAGE == 0 for b in base.values())
        assert all(e <= s for (_, e), (s, _) in zip(span, span[1:]))
        assert tracedata.LOW <= span[0][0] and span[-1][1] <= tracedata.HIGH
    assert len(got) == 20
    small = tiny_trace_config(24)
    hists = []
    for seed in (1, 2**31 + 5):
        _write(tmp_path / "s.u64", small, seed)
        hists.append(ref_trace.replay(str(tmp_path / "s.u64"), 64, "cpu"))
    assert np.array_equal(hists[0].hist, hists[1].hist)


def test_the_trace_counts_what_one_thread_of_the_nest_counts(tmp_path):
    """The reference's histogram of the trace is the loop-nest
    reference's at one thread, its share reuses binned as the rest."""
    from benchmark.reference import stream
    layout = tiny_trace_config(40)
    path = str(tmp_path / "t.u64")
    _write(path, layout, 2**31 + 1)
    got = ref_trace.replay(path, 64, "cpu")
    h = stream.full(layout["spec"], stream.Schedule(1, 1, 8, 64), "cpu")
    want = np.zeros(ref_trace.NBINS, np.int64)
    for k, c in list(h.noshare[0].items()) + list(h.share[0].items()):
        want[0 if k == -1 else int(k).bit_length()] += int(c)
    assert np.array_equal(got.hist, want)
    assert got.total_count == h.accesses == layout["refs"]


def test_the_sweeps_alone_read_the_hand_worked_histogram(tmp_path):
    from pluss_torch import tracegen
    path = tmp_path / "b.u64"
    with open(path, "wb") as f:
        tracegen.sweeps(f, 8, 1 << 10, tracegen.SWEEP_BASE_LINE)
    got = ref_trace.replay(str(path), 64, "cpu")
    want = tracegen.sweep_histogram(8, 1 << 10)
    assert np.array_equal(got.hist, want)
    assert got.n_lines == 1 << 10
    assert got.total_count == 8 * 8 * (1 << 10)


@pytest.mark.parametrize("seed,window,bw", [(3, 1 << 10, 4), (2**31 + 9,
                                                              1 << 9, 2)])
def test_the_reference_equals_the_port_on_the_cpu(tmp_path, seed, window,
                                                  bw):
    from pluss_torch import mrc, trace
    from pluss_torch.config import SamplerConfig
    from benchmark.reference import curve
    path = str(tmp_path / "t.u64")
    _write(path, tiny_trace_config(), seed)
    rep = trace.replay_file(path, window=window, batch_windows=bw,
                            device="cpu")
    ref = ref_trace.replay(path, 64, "cpu")
    assert compare.trace_counts_off(rep.hist, rep.total_count, rep.n_lines,
                                    ref) == 0
    assert rep.hist[0] == ref.n_lines < rep.n_lines   # the table has slack
    rih = ref_trace.histogram(ref)
    assert rih == rep.histogram()
    assert compare.mrc_gap(mrc.aet_mrc(rep.histogram(), SamplerConfig()),
                           curve.aet_mrc(rih, 2560)) == 0.0


def test_bit_length_is_exact_at_every_power_of_two():
    import torch
    e = torch.arange(1, 62, dtype=torch.int64)
    p = torch.bitwise_left_shift(torch.ones_like(e), e)
    r = torch.cat([p - 1, p, p + 1])
    want = torch.tensor([int(v).bit_length() - 1 for v in r.tolist()])
    assert torch.equal(ref_trace.bit_length(r), want)


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_each_replay_mix_runs_correct_on_the_cpu(tiny_root, small_batches,
                                                 mix):
    cell = _add_trace_cell(tiny_root, mix)
    out = _run(tiny_root, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert out["checks"]["counts_off"] == {"value": 0, "limit": 0}
    e2e = {m["name"] for m in _bench()["end_to_end"]
           if MIXES[mix] in m.get("workloads", [MIXES[mix]])}
    assert set(out["metrics"]) == e2e
    assert list(out)[-1] == "checks"


def test_every_resident_window_prediction_is_a_hit(tiny_root,
                                                   small_batches):
    """Set-up stages the trace; the window replays the resident copy and
    opens no streamed replay."""
    cell = _add_trace_cell(tiny_root, "replay_resident")
    _add_metric(tiny_root, cell, "hits_per_pred",
                "def read(run):\n    return (run.span_s('trace.replay_file')"
                " is None) * sum(n == 'trace.replay_staged' for n, _ in "
                "run.spans) / run.n_preds\n")
    out = _run(tiny_root, cell, trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["hits_per_pred"]["value"] == 1.0
    assert out["metrics"]["replay_s"]["value"] > 0


def test_the_counters_are_their_increase_over_the_window(tiny_root,
                                                         small_batches):
    """The streamed warm-up replayed the trace once before the window:
    the readers see only the window's replays."""
    cell = _add_trace_cell(tiny_root, "replay")
    _add_metric(tiny_root, cell, "refs_per_pred",
                "def read(run):\n    return run.counter("
                "'trace.refs_replayed') / run.n_preds\n")
    out = _run(tiny_root, cell, trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["refs_per_pred"]["value"] == \
        tracedata.refs(tiny_trace_config())
    assert out["metrics"]["feed_stall_s.stream"]["value"] > 0
    assert out["metrics"]["replay_s.stream"]["value"] > 0


def _break(monkeypatch, fault):
    """Plant one fault in the replay's per-batch step (the port's code, as
    loaded in this process): a histogram slot altered where it is
    counted, or one batch never processed."""
    from pluss_torch import trace
    real = trace._segmented_batch

    def batch(last_pos, hist, base, ids, n_valid, pdt, hist_fn):
        if fault == "batch_skipped" and base == ids.shape[0]:
            return
        real(last_pos, hist, base, ids, n_valid, pdt, hist_fn)
        if fault == "slot_altered" and base == 0:
            hist[5] += 1
    monkeypatch.setattr(trace, "_segmented_batch", batch)


@pytest.mark.parametrize("fault", ["slot_altered", "batch_skipped"])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_a_broken_replay_is_not_correct(tiny_root, small_batches,
                                        monkeypatch, fault, mix):
    cell = _add_trace_cell(tiny_root, mix)
    _break(monkeypatch, fault)
    out = _run(tiny_root, cell)
    assert out["attempted"] >= 1
    assert not out["correct"], out["checks"]
    assert out["checks"]["counts_off"]["value"] > 0


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_float32_control_fails_on_a_trace(tiny_root, mix):
    cell = _add_trace_cell(tiny_root, mix)
    got = control.readings(tiny_root.path, cell, [1, 2**31 + 3, 5], "cpu")
    assert len(got) == 3
    for r in got:
        assert not r["correct"], r
        assert r["mrc_gap"] > compare.LIMITS["mrc_gap"]


def test_the_trace_file_lives_in_the_temporary_directory_only(
        tiny_root, small_batches, monkeypatch, tmp_path):
    """Written under the temporary directory for the run, gone after it,
    also when the run fails after set-up."""
    tmp = tmp_path / "tmpdir"
    tmp.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    cell = _add_trace_cell(tiny_root, "replay")
    seen = []
    real = harness.TraceCell.predict

    def predict(self, p, clock):
        seen.append(os.path.dirname(self.path))
        return real(self, p, clock)
    monkeypatch.setattr(harness.TraceCell, "predict", predict)
    assert _run(tiny_root, cell, seconds=0.2)["correct"]
    assert set(seen) == {str(tmp)}
    assert not os.listdir(tmp)
    monkeypatch.setattr(harness, "check", lambda *a, **k: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        _run(tiny_root, cell, seconds=0.2)
    assert not os.listdir(tmp)
    assert not glob.glob(os.path.join(tiny_root.path, "**", "*.u64"),
                         recursive=True)


def test_a_mix_must_fit_the_configurations_kind():
    nest, tr = tiny_config("gemm", 16), tiny_trace_config()
    with pytest.raises(ValueError, match="loop-nest"):
        traffic.check_mix({"run": "replay"}, nest)
    with pytest.raises(ValueError, match="trace"):
        traffic.check_mix({"run": "full"}, tr)
    with pytest.raises(ValueError, match="trace"):
        traffic.check_mix({"run": "sampled", "rate": 0.1}, tr)
    with pytest.raises(ValueError, match="resident_cache"):
        traffic.check_mix({"run": "full", "resident_cache": True}, nest)
    with pytest.raises(ValueError, match="resident_cache"):
        traffic.check_mix({"run": "replay", "resident_cache": 1}, tr)
    for name in ("replay", "replay_resident"):
        with open(os.path.join(ROOT, "benchmark", "traffic",
                               name + ".json")) as f:
            traffic.check_mix(json.load(f), tr)


def test_kernel_2_need_is_the_published_bound():
    """One 2^24-entry batch with int32 reuses: 0.0351 ms at 3.35 TB/s."""
    assert kernels.least_ms(kernels.masked_hist_need_bytes(1 << 24, 4)) \
        == pytest.approx(0.0351, abs=5e-5)


#: what the gemm-1024 cells printed before the harness learned traces
#: (the commit before it, gemm-16 stand-ins on the CPU, seed 7): metric
#: names without and with the trace, and the numbers ``correct`` compares
#: on the full mix (one input; the sampled and sweep mixes check inputs
#: drawn among those the window reached, so their numbers vary with it)
PARENT = {
    "full": (["peak_gib", "pred_p90_s.host", "pred_s.host", "setup_s"],
             ["cri_s.host", "dispatch_s.host", "mrc_s.host", "post_s.host",
              "share_unique_s.host", "template_window_s.host"]),
    "sampled": (["peak_gib", "pred_p90_s", "pred_s", "setup_s"],
                ["cri_s", "mrc_s", "post_s", "sampled_run_s", "sampler_s"]),
    "sweep": (["peak_gib", "pred_s.host", "setup_s"],
              ["cri_s.host", "dispatch_s.host", "mrc_s.host", "plan_s",
               "plan_template_s", "post_s.host", "share_unique_s.host",
               "template_window_s.host"])}
PARENT_CHECKS = {"counts_off": 0, "cri_gap": 1.3163853616131462e-12,
                 "mrc_gap": 1.1712852909795402e-14}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("mix", sorted(PARENT))
def test_the_loop_nest_cells_print_what_they_printed(tiny_root, mix, trace):
    cell = tiny_root.add(tiny_config("gemm", 16), mix)
    real = f"gemm-1024.{mix}"
    for m in tiny_root.doc["end_to_end"] + tiny_root.doc["per_layer"]:
        if "workloads" in m and real not in m["workloads"]:
            m["workloads"].remove(cell)
    tiny_root.save()
    out = harness.run(tiny_root.path, cell, 7, 0.3, trace, t_start=0.0,
                      device="cpu")
    assert out["correct"]
    assert sorted(out["metrics"]) == PARENT[mix][trace]
    got = {k: v["value"] for k, v in out["checks"].items()}
    assert list(got) == list(PARENT_CHECKS) and got["counts_off"] == 0
    if mix == "full":
        for k in ("cri_gap", "mrc_gap"):
            assert got[k] == pytest.approx(PARENT_CHECKS[k], rel=1e-6)
