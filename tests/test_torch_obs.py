"""The port's telemetry (``pluss_torch.obs``) against the JAX package's.

In order of importance:

1. passivity: engine and trace results are bit-identical with telemetry
   on and off (both wires, the segmented batch and the legacy scan);
2. the disabled path is the shared no-op span and costs next to nothing;
3. streams: a port stream passes both packages' ``stats --check``, the
   port's ``stats`` prints byte for byte what ``pluss.cli stats`` prints on
   streams of either package, and ``--check`` rejects what JAX's rejects;
4. parity: the same run through both packages records the same counter,
   gauge and span names (apart from the JAX-only compile counters listed
   below) and the same counts where the counts are deterministic.

Sizes are small: n <= 16, traces of at most 2^16 refs.
"""

import contextlib
import io
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from pluss import cli as jax_cli
from pluss import engine as jax_engine
from pluss import models as jax_models
from pluss import obs as jax_obs
from pluss import residency as jax_residency
from pluss import trace as jax_trace
from pluss.config import SamplerConfig as JaxConfig
from pluss.obs import stats as jax_stats
from pluss_torch import cli, engine, obs, residency, trace
from pluss_torch.config import SamplerConfig
from pluss_torch.obs import stats as stats_mod
from pluss_torch.obs import telemetry as tel
from pluss_torch.obs import xprof
from pluss_torch.obs.telemetry import NOOP_SPAN
from pluss_torch.resilience import FaultPlan, faults
from pluss_torch.resilience.errors import DataLoss
from tests.test_obs import GOLDEN_OUTPUT, GOLDEN_RECORDS
from tests.test_torch_engine import carried

KW = {"cls": 8}

#: names only the JAX package records: XLA's compile counters and its
#: compile registry's in-flight gauge have no torch counterpart (the
#: port's kernels build once per process, outside any run)
JAX_ONLY = {"engine.compiles", "engine.compile_s", "engine.compile_inflight"}


@pytest.fixture(autouse=True)
def _fresh_obs():
    """Every test starts and ends with telemetry off, in both packages."""
    obs.shutdown()
    jax_obs.shutdown()
    faults.install(None)
    yield
    obs.shutdown()
    jax_obs.shutdown()
    faults.install(None)


def _events(path):
    recs, problems, _ = stats_mod.load(path)
    assert problems == [], problems
    return recs


def _write_stream(path, records):
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r, separators=(",", ":")) + "\n")


def _trace_file(path, n=1 << 16, lines=1 << 12, seed=3):
    rng = np.random.default_rng(seed)
    (rng.integers(0, lines, n, dtype=np.int64) << 6).astype(
        "<u8").tofile(path)
    return str(path)


# ---------------------------------------------------------------------------
# the disabled path


def test_disabled_span_is_shared_noop():
    assert not obs.enabled()
    s = obs.span("anything", x=1)
    assert s is NOOP_SPAN
    with s as inner:
        assert inner.set(y=2) is inner


def test_disabled_path_overhead_bound():
    """200k disabled counter+span calls well under a second (the JAX
    package's bound, an order of magnitude above the cost)."""
    assert not obs.enabled()
    t0 = time.perf_counter()
    for _ in range(200_000):
        obs.counter_add("x")
        obs.span("y")
    assert time.perf_counter() - t0 < 1.0


def test_xprof_disabled_is_noop(monkeypatch):
    monkeypatch.delenv("PLUSS_XPROF", raising=False)
    assert not xprof.enabled()
    with xprof.session():
        with xprof.annotate("pluss.test"):
            pass


def test_xprof_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("PLUSS_XPROF", str(tmp_path / "prof"))
    res = engine.run(carried("gemm", 8), SamplerConfig(**KW), device="cpu")
    assert res.max_iteration_count > 0
    out = os.listdir(tmp_path / "prof")
    assert len(out) == 1 and out[0].endswith(".json")
    with open(tmp_path / "prof" / out[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "pluss.engine.gemm8" in names


# ---------------------------------------------------------------------------
# passivity


@pytest.mark.parametrize("model,n", [("gemm", 16), ("mvt", 16),
                                     ("cholesky", 16), ("syrk", 16)])
def test_engine_bit_identity_on_off(tmp_path, model, n):
    spec, cfg = carried(model, n), SamplerConfig(**KW)
    off = engine.run(spec, cfg, device="cpu")
    obs.configure(str(tmp_path / "ev.jsonl"))
    on = engine.run(spec, cfg, device="cpu")
    sliced = engine.run_sliced(spec, cfg, device="cpu", thread_batch=1,
                               max_dispatch_entries=1)
    c = obs.counters()
    obs.shutdown()
    for res in (on, sliced):
        np.testing.assert_array_equal(off.noshare_dense, res.noshare_dense)
        assert off.share_raw == res.share_raw
        assert res.degradations == ()
    assert c["engine.refs_processed"] == 2 * off.max_iteration_count
    assert c["engine.sliced_dispatches"] >= 1
    recs = _events(str(tmp_path / "ev.jsonl"))
    names = {r["name"] for r in recs if r.get("ev") == "span"}
    assert {"engine.dispatch", "engine.finalize"} <= names
    backends = {r["attrs"]["backend"] for r in recs
                if r.get("name") == "engine.dispatch"}
    assert backends == {"vmap", "sliced"}


@pytest.mark.parametrize("segmented", [True, False])
@pytest.mark.parametrize("wire", ["pack", "d24v"])
def test_replay_file_bit_identity_on_off(tmp_path, wire, segmented):
    path = _trace_file(tmp_path / "t.bin")
    kw = dict(window=1 << 12, batch_windows=2, segmented=segmented,
              wire=wire, device="cpu")
    off = trace.replay_file(path, **kw)
    obs.configure(str(tmp_path / "ev.jsonl"))
    on = trace.replay_file(path, feed_workers=3, **kw)
    obs.shutdown()
    np.testing.assert_array_equal(off.hist, on.hist)
    assert (off.total_count, off.n_lines) == (on.total_count, on.n_lines)
    assert on.degradations == () and on.wire == wire
    assert set(on.timing) == set(off.timing)


def test_resident_paths_bit_identity_on_off(tmp_path):
    path = _trace_file(tmp_path / "t.bin")
    kw = dict(window=1 << 12, batch_windows=2)
    meta = trace.pack_file(path, path + ".pack", wire="d24v", **kw)
    off = trace.replay_resident(path + ".pack", meta, device="cpu", **kw)
    obs.configure(str(tmp_path / "ev.jsonl"))
    on = trace.replay_resident(path + ".pack", meta, device="cpu", **kw)
    c = obs.counters()
    obs.shutdown()
    np.testing.assert_array_equal(off.hist, on.hist)
    assert c["trace.resident_refs"] == 1 << 16
    assert c["trace.upload_bytes"] == os.path.getsize(path + ".pack")
    names = {r["name"] for r in _events(str(tmp_path / "ev.jsonl"))
             if r.get("ev") == "span"}
    assert {"trace.stage_resident", "trace.replay_staged"} <= names


# ---------------------------------------------------------------------------
# the replay's counters


def test_replay_stream_valid_and_breakdown_accounts_wall(tmp_path):
    """The main thread's buckets account for the replay span's wall (the
    JAX package's margins, 75%..102%)."""
    path = _trace_file(tmp_path / "t.bin", lines=1 << 13, seed=5)
    ev = str(tmp_path / "ev.jsonl")
    obs.configure(ev)
    trace.replay_file(path, window=1 << 11, batch_windows=2,
                      checkpoint_path=str(tmp_path / "ck.npz"),
                      checkpoint_every=4, device="cpu")
    obs.shutdown()
    recs = _events(ev)
    c = {r["name"]: r["value"] for r in recs if r.get("ev") == "counter"}
    (span,) = [r for r in recs if r.get("name") == "trace.replay_file"]
    accounted = sum(c[f"trace.{k}"] for k in (
        "prefetch_stall_s", "h2d_s", "device_s", "ckpt_save_s", "grow_s"))
    assert 0.75 * span["dur"] <= accounted <= 1.02 * span["dur"]
    assert c["trace.refs_replayed"] == 1 << 16
    assert c["trace.batches"] == 16 and c["trace.ckpt_saves"] == 3
    assert c["trace.device_bytes"] == 16 * 2 * (1 << 11) * 4
    assert span["attrs"]["refs_replayed"] == 1 << 16
    buf = io.StringIO()
    stats_mod.render(recs, buf)
    assert "trace replay breakdown:" in buf.getvalue()


def test_aborted_replay_still_records_counters(tmp_path):
    path = _trace_file(tmp_path / "t.bin", n=1 << 15, lines=1 << 10)
    ev = str(tmp_path / "ev.jsonl")
    obs.configure(ev)
    faults.install(FaultPlan.parse("trace_loss@3"))
    with pytest.raises(DataLoss):
        trace.replay_file(path, window=1 << 11, batch_windows=2,
                          device="cpu")
    obs.shutdown()
    recs = _events(ev)
    c = {r["name"]: r["value"] for r in recs if r.get("ev") == "counter"}
    assert c["trace.batches"] == 2 and c["trace.refs_replayed"] == 2 * 4096
    assert c["resilience.faults_fired"] == 1
    (sp,) = [r for r in recs if r.get("name") == "trace.replay_file"]
    assert sp["error"] == "DataLoss"


def test_resumed_replay_counts_only_new_refs(tmp_path):
    n, window, bw = 1 << 15, 1 << 11, 2   # 8 batches of 4096 refs
    path = _trace_file(tmp_path / "t.bin", n=n, lines=1 << 10)
    ck = str(tmp_path / "ck.npz")
    obs.configure(str(tmp_path / "ev.jsonl"))
    faults.install(FaultPlan.parse("trace_loss@5"))
    with pytest.raises(DataLoss):
        trace.replay_file(path, window=window, batch_windows=bw,
                          checkpoint_path=ck, checkpoint_every=2,
                          device="cpu")
    faults.install(None)
    before = obs.counters()["trace.refs_replayed"]
    trace.replay_file(path, window=window, batch_windows=bw,
                      checkpoint_path=ck, resume=True, device="cpu")
    delta = obs.counters()["trace.refs_replayed"] - before
    obs.shutdown()
    # checkpoints at batches 2 and 4; the fault on the 5th read: the resume
    # starts at batch 4 and replays exactly the tail
    assert delta == n - 4 * bw * window


def test_feed_gauges_and_residency_counters(tmp_path):
    path = _trace_file(tmp_path / "t.bin")
    kw = dict(window=1 << 12, batch_windows=2, device="cpu")
    obs.configure(str(tmp_path / "ev.jsonl"))
    residency.reset()
    cold = trace.replay_file(path, feed_workers=2, resident_cache=True, **kw)
    warm = trace.replay_file(path, resident_cache=True, **kw)
    residency.reset(budget=1024)
    tiny = trace.replay_file(path, resident_cache=True, **kw)
    residency.reset()
    c, g = obs.counters(), obs.gauges()
    obs.shutdown()
    for r in (warm, tiny):
        np.testing.assert_array_equal(r.hist, cold.hist)
    assert (c["residency.miss"], c["residency.hit"], c["residency.pin"],
            c["residency.stage_through"], c["residency.fallback"]) \
        == (2, 1, 1, 1, 1)
    assert "trace.feed_workers_busy" in g and "trace.queue_occupancy" in g
    # the last publish: the stage-through entry (a reset publishes nothing)
    assert g["trace.hbm_resident_bytes"] == 8 * 2 * (1 << 12) * 3


# ---------------------------------------------------------------------------
# stats: the port's reader against the JAX package's


def _cli_out(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_stats_golden_output(tmp_path):
    p = str(tmp_path / "ev.jsonl")
    _write_stream(p, GOLDEN_RECORDS)
    out, err = io.StringIO(), io.StringIO()
    assert stats_mod.main(p, out, err) == 0
    assert out.getvalue() == GOLDEN_OUTPUT and err.getvalue() == ""


@pytest.mark.parametrize("mutate,needle", [
    (lambda rs: rs.__setitem__(0, {"ev": "meta", "schema": 99}),
     "schema"),
    (lambda rs: rs.insert(3, {"ev": "span", "id": 2, "name": "dup",
                              "t": 0, "dur": 0}), "duplicate span id"),
    (lambda rs: rs.insert(3, {"ev": "span", "id": 77, "parent": 1234,
                              "name": "x", "t": 0, "dur": 0}),
     "matches no span"),
    (lambda rs: rs.insert(3, {"ev": "counter", "name": "c",
                              "value": "NaNish"}), "numeric value"),
    (lambda rs: rs.insert(3, {"ev": "alien", "x": 1}), "unknown ev"),
    (lambda rs: rs.append('{"ev":"coun'), "torn"),
    (lambda rs: rs.insert(2, "NOT JSON AT ALL"), "unparseable"),
])
def test_check_rejects_what_jax_rejects(tmp_path, mutate, needle):
    rs = [dict(r) for r in GOLDEN_RECORDS]
    mutate(rs)
    p = str(tmp_path / "ev.jsonl")
    with open(p, "w") as f:
        for r in rs:
            f.write((r if isinstance(r, str)
                     else json.dumps(r, separators=(",", ":"))) + "\n")
    outs = []
    for main in (stats_mod.main, jax_stats.main):
        out, err = io.StringIO(), io.StringIO()
        outs.append((main(p, out, err, check=True), out.getvalue(),
                     err.getvalue()))
    assert outs[0] == outs[1]
    assert needle in outs[0][2]


def test_trace_and_follow_views_match_jax(tmp_path):
    rs = [GOLDEN_RECORDS[0],
          {"ev": "span", "id": 1, "name": "serve.request", "t": 0.0,
           "dur": 0.5, "trace": "r1"},
          {"ev": "span", "id": 2, "parent": 1, "name": "engine.dispatch",
           "t": 0.1, "dur": 0.2, "trace": "r1", "attrs": {"backend": "vmap"}},
          {"ev": "event", "name": "resilience.rung", "t": 0.3,
           "trace": "r1", "attrs": {"rung": "shrink_window"}},
          GOLDEN_RECORDS[-1]]
    p = str(tmp_path / "ev.jsonl")
    _write_stream(p, rs)
    for argv in (["stats", p, "--trace", "r1"], ["stats", p, "--follow"],
                 ["stats", p, "--trace", "nobody"]):
        assert _cli_out(cli.main, argv) == _cli_out(jax_cli.main, argv)


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """One run of the same work through each package, each with its own
    telemetry stream: GEMM-16 planned through a disk plan cache (a miss,
    then a hit), a trace replay, a pack and a resident stage-through
    followed by a warm hit."""
    out = {}
    saved = {k: os.environ.get(k) for k in ("PLUSS_NO_PLAN_CACHE",
                                           "PLUSS_PLAN_CACHE_DIR")}
    try:
        os.environ.pop("PLUSS_NO_PLAN_CACHE", None)
        for name in ("jax", "port"):
            d = tmp_path_factory.mktemp(name)
            os.environ["PLUSS_PLAN_CACHE_DIR"] = str(d / "pc")
            ev = str(d / "ev.jsonl")
            tf = _trace_file(d / "t.bin", n=1 << 14)
            tk = dict(window=1 << 12, batch_windows=2)
            if name == "jax":
                o, eng, tr, res_mod = jax_obs, jax_engine, jax_trace, \
                    jax_residency
                spec, cfg, dk = jax_models.REGISTRY["gemm"](16), \
                    JaxConfig(**KW), {}
                clear = jax_engine.compiled.cache_clear
            else:
                o, eng, tr, res_mod = obs, engine, trace, residency
                spec, cfg, dk = carried("gemm", 16), SamplerConfig(**KW), \
                    {"device": "cpu"}
                clear = engine._plan_cached.cache_clear
            o.configure(ev)
            try:
                clear()
                r1 = eng.run(spec, cfg, **dk)
                clear()
                eng.run(spec, cfg, **dk)
                rep = tr.replay_file(tf, **tk, **dk)
                tr.pack_file(tf, tf + ".pack", **tk)
                res_mod.reset()
                tr.replay_file(tf, resident_cache=True, **tk, **dk)
                tr.replay_file(tf, resident_cache=True, **tk, **dk)
                res_mod.reset()
                c, g = o.counters(), o.gauges()
            finally:
                o.shutdown()
                clear()
            out[name] = {"ev": ev, "counters": c, "gauges": g,
                         "result": r1, "replay": rep}
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    return out


def test_results_of_the_parity_run_agree(streams):
    j, p = streams["jax"], streams["port"]
    np.testing.assert_array_equal(p["result"].noshare_dense,
                                  j["result"].noshare_dense)
    np.testing.assert_array_equal(p["replay"].hist, j["replay"].hist)


def test_counter_gauge_and_span_names_match_jax(streams):
    j, p = streams["jax"], streams["port"]
    assert set(j["counters"]) - set(p["counters"]) <= JAX_ONLY
    assert set(p["counters"]) <= set(j["counters"])
    assert set(j["gauges"]) - set(p["gauges"]) <= JAX_ONLY
    assert set(p["gauges"]) <= set(j["gauges"])

    def spans(ev):
        return {r["name"] for r in _events(ev) if r.get("ev") == "span"}

    assert spans(p["ev"]) == spans(j["ev"])
    assert {"engine.plan", "engine.dispatch", "engine.finalize",
            "trace.replay_file", "trace.pack_file", "trace.replay_staged"} \
        <= spans(p["ev"])


def test_deterministic_counts_match_jax(streams):
    j, p = streams["jax"]["counters"], streams["port"]["counters"]
    # every count that is not a time; times ("_s") differ run to run
    counts = {k for k in p if not k.endswith("_s")}
    assert {"engine.refs_processed", "engine.plan_cache.miss",
            "engine.plan_cache.hit", "trace.batches", "trace.refs_replayed",
            "trace.h2d_bytes", "trace.device_bytes", "trace.pack_refs",
            "trace.resident_refs", "residency.hit", "residency.miss",
            "residency.stage_through"} <= counts
    assert {k: p[k] for k in counts} == {k: j[k] for k in counts}
    assert streams["port"]["gauges"]["trace.hbm_resident_bytes"] \
        == streams["jax"]["gauges"]["trace.hbm_resident_bytes"]


@pytest.mark.parametrize("which", ["jax", "port"])
def test_both_stats_read_both_streams_alike(streams, which):
    ev = streams[which]["ev"]
    for argv in (["stats", ev], ["stats", ev, "--check"]):
        rc, out = _cli_out(cli.main, argv)
        assert (rc, out) == _cli_out(jax_cli.main, argv)
        assert rc == 0
    assert "trace replay breakdown:" in _cli_out(cli.main, ["stats", ev])[1]


# ---------------------------------------------------------------------------
# the CLI, the sinks and the session


def test_cli_telemetry_flag_and_stats(tmp_path):
    path = _trace_file(tmp_path / "t.bin", n=1 << 14, lines=1 << 10)
    ev = str(tmp_path / "ev.jsonl")
    rc, _ = _cli_out(cli.main, [
        "trace", "--cpu", "--file", path, "--out", str(tmp_path / "m.csv"),
        "--window", str(1 << 12), "--batch-windows", "2",
        "--telemetry", ev])
    assert rc == 0
    obs.shutdown()   # the CLI's session, closed as the process would
    rc, out = _cli_out(cli.main, ["stats", ev, "--check"])
    assert rc == 0 and "ok (" in out
    assert "reader prefetch stall" in _cli_out(cli.main, ["stats", ev])[1]
    with pytest.raises(SystemExit):
        cli.main(["acc", "stray-positional"])


def test_prometheus_export(tmp_path):
    prom = str(tmp_path / "metrics.prom")
    obs.configure(str(tmp_path / "ev.jsonl"), prom_path=prom)
    obs.counter_add("trace.h2d_bytes", 12345)
    obs.counter_add("trace.prefetch_stall_s", 1.5)
    obs.gauge_set("trace.queue_occupancy", 3)
    c, g = obs.counters(), obs.gauges()
    obs.shutdown()
    text = open(prom).read()
    assert "# TYPE pluss_trace_h2d_bytes counter" in text
    assert "pluss_trace_h2d_bytes 12345" in text
    assert "pluss_trace_prefetch_stall_s 1.5" in text
    assert "pluss_trace_queue_occupancy 3" in text
    assert text == jax_obs.render_prom(c, g) == obs.render_prom(c, g)


def test_sink_write_failure_degrades_not_raises(tmp_path, capsys):
    t = obs.configure(str(tmp_path / "ev.jsonl"))

    class _Broken:
        def write(self, s):
            raise OSError(28, "No space left on device")

        def flush(self):
            pass

        def close(self):
            pass

        def fileno(self):
            raise OSError(9, "bad fd")

    t._f = _Broken()
    obs.event("x")
    obs.counter_add("a")
    with obs.span("s"):
        pass
    assert "disabling the event stream" in capsys.readouterr().err
    obs.shutdown()


def test_unopenable_sink_disables_not_raises(tmp_path, capsys):
    blocker = tmp_path / "im_a_file"
    blocker.write_text("x")
    assert obs.configure(str(blocker / "ev.jsonl")) is None
    assert not obs.enabled()
    obs.counter_add("x")
    assert "telemetry disabled" in capsys.readouterr().err


def test_env_bootstrap_and_its_suspension(tmp_path, monkeypatch):
    ev = tmp_path / "shared.jsonl"
    monkeypatch.setenv("PLUSS_TELEMETRY", str(ev))
    monkeypatch.setattr(tel, "_bootstrapped", False)
    tel.suspend_env_bootstrap()
    try:
        obs.counter_add("x")
        assert not ev.exists() and not tel.configured()
    finally:
        tel.resume_env_bootstrap()
    obs.counter_add("y")
    assert ev.exists() and obs.enabled()
    obs.shutdown()
    assert jax_stats.main(str(ev), io.StringIO(), io.StringIO(),
                          check=True) == 0


def test_counter_rejects_nan(tmp_path):
    obs.configure(str(tmp_path / "ev.jsonl"))
    with pytest.raises(ValueError):
        obs.counter_add("bad", float("nan"))


def test_spans_nest_per_thread(tmp_path):
    ev = str(tmp_path / "ev.jsonl")
    obs.configure(ev)

    def worker():
        with obs.span("worker.outer"):
            with obs.span("worker.inner"):
                pass

    with obs.span("main.outer"):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    obs.shutdown()
    spans = {r["name"]: r for r in _events(ev) if r.get("ev") == "span"}
    assert "parent" not in spans["worker.outer"]
    assert spans["worker.inner"]["parent"] == spans["worker.outer"]["id"]
    assert "parent" not in spans["main.outer"]


def test_envknobs_warn_once_and_fall_back(monkeypatch, capsys):
    from pluss_torch.utils import envknob

    # values no other test sets: the warning is once per (knob, value)
    # in a process
    monkeypatch.setenv("PLUSS_PLAN_CACHE_MAX", "obs-test-cap")
    assert engine.plan_cache_max() == 256
    assert engine.plan_cache_max() == 256
    monkeypatch.setenv("PLUSS_HBM_BUDGET", "obs-test-budget")
    assert residency.budget_bytes() == residency.device_budget_default()
    monkeypatch.setenv("PLUSS_WIRE", "obs-test-wire")
    assert trace._resolve_wire(None, torch.device("cpu")) == "pack"
    monkeypatch.setenv("PLUSS_WIRE", "d24v")
    assert trace._resolve_wire(None, torch.device("cpu")) == "d24v"
    with pytest.raises(ValueError):
        trace._resolve_wire("zstd", torch.device("cpu"))
    err = capsys.readouterr().err
    assert err.count("PLUSS_PLAN_CACHE_MAX") == 1
    assert "PLUSS_HBM_BUDGET" in err and "PLUSS_WIRE" in err
    assert envknob.env_int("PLUSS_UNSET_KNOB_FOR_TEST", 7) == 7
