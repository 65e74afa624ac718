"""The served configuration ``serve-pool`` and its open-loop cell, on the
CPU at small sizes: the frozen documents are the registry's, an open
window through the program's daemon answers every request and reads
``correct``, a response altered where the daemon produces it or a request
shed or failed turns ``correct`` false, the arrivals follow the seed, and
the float32 control fails."""

import copy
import json
import os

import numpy as np
import pytest

from benchmark import compare, harness, serve, traffic
from conftest import ROOT, tiny_config, tiny_serve_config, tiny_trace_config

CONFIG = "serve-pool"
CELL = "serve-pool.open"
SERVE_METRICS = {"serve_batch_s.serve", "demux_s.serve",
                 "dispatch_s.serve", "cri_s.serve", "mrc_s.serve"}


def _config() -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs",
                           f"{CONFIG}.json")) as f:
        return json.load(f)


@pytest.fixture(autouse=True)
def _serve_env(monkeypatch):
    """The run sets the daemon's two knobs in the environment: put them
    back afterwards."""
    monkeypatch.setenv("PLUSS_SERVE_INTERFERENCE", "off")
    monkeypatch.setenv("PLUSS_SERVE_PLACEMENT", "off")


def _cell(root, rate=8.0):
    return root.add(tiny_serve_config(), "fast",
                    {"run": "open", "rate_per_s": rate, "timeout_s": 60})


def _run(root, cell, seed=5, seconds=1.0, trace=False):
    return harness.run(root.path, cell, seed, seconds, trace, t_start=0.0,
                       device="cpu")


def test_the_configuration_is_the_pool_at_published_sizes():
    from pluss_torch.models import REGISTRY
    from pluss_torch.serve import ServeConfig
    from pluss_torch.spec import loop_size
    from pluss_torch.spec_codec import spec_to_json
    conf = _config()
    assert conf["kind"] == "serve" and conf["reduced"] == []
    assert "interference" in conf["assumed"]
    d = ServeConfig()
    assert conf["server"] == {
        "max_batch": d.max_batch, "max_delay_ms": d.max_delay_ms,
        "max_queue": d.max_queue, "placement": "off",
        "interference": "off"}
    want = {"gemm-1024": ("gemm", 1024, 4, 4),
            "mvt-4000": ("mvt", 4000, 4, 4),
            "syrk-1024": ("syrk", 1024, 2, 4),
            "inline-gemm-1024": ("gemm", 1024, 2, 2)}
    assert [t["name"] for t in conf["tenants"]] == list(want)
    for t in conf["tenants"]:
        model, n, T, CS = want[t["name"]]
        spec = REGISTRY[model](n)
        doc = spec_to_json(spec)
        r = t["request"]
        if t["name"].startswith("inline"):
            doc["name"] = "tenant_gemm1024"
            assert r["spec"] == t["spec"] and "model" not in r
        else:
            assert (r["model"], r["n"]) == (model, n)
        assert t["spec"] == doc
        assert t["accesses"] == sum(loop_size(x) for x in spec.nests)
        assert (r["threads"], r["chunk"]) == (T, CS)
        assert {k: r[k] for k in ("ds", "cls", "cache_kb", "output")} == \
            {"ds": 8, "cls": 64, "cache_kb": 2560, "output": "both"}
        assert "deadline_ms" not in r and "tenant" not in r
    bench = harness.load_bench(ROOT)
    entry = next(c for c in bench["configs"] if c["name"] == CONFIG)
    assert entry["reduced"] == [] and \
        entry["file"] == f"benchmark/configs/{CONFIG}.json"
    (cell,) = [w for w in bench["workloads"] if w["config"] == CONFIG]
    assert (cell["name"], cell["traffic"], cell["chips"]) == \
        (CELL, "open", 1)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["pred_p90_s.serve"]["workloads"] == [CELL]
    assert CELL not in e2e["pred_s"]["workloads"]
    for m in bench["per_layer"]:
        if m["name"].endswith(".serve"):
            assert m["workloads"] == [CELL]
            assert m["moves"] == "pred_p90_s.serve"


def test_an_open_window_answers_every_request(tiny_root):
    cell = _cell(tiny_root)
    out = _run(tiny_root, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 8 and out["failed"] == 0
    assert set(out["metrics"]) >= {"setup_s", "peak_gib",
                                   "pred_p90_s.serve"}
    assert "pred_s" not in out["metrics"]
    assert out["metrics"]["pred_p90_s.serve"]["value"] > 0
    assert list(out)[-1] == "checks"
    assert out["checks"]["counts_off"] == {"value": 0, "limit": 0}


def test_a_traced_window_reads_the_serve_spans_and_counters(tiny_root):
    cell = _cell(tiny_root, rate=12.0)
    out = _run(tiny_root, cell, trace=True)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for name in SERVE_METRICS:
        assert got[name]["value"] > 0, name
    # the demux, CRI and MRC are parts of the device loop's batches
    parts = sum(got[m]["value"] for m in ("demux_s.serve", "cri_s.serve",
                                          "mrc_s.serve"))
    assert parts < got["serve_batch_s.serve"]["value"]


def test_the_trace_covers_a_request_of_every_tenant():
    mix = {"run": "open", "rate_per_s": 3.0}
    for seed in range(20):
        sched = traffic.arrivals(mix, 4, seed, 51)
        span = serve.trace_span(sched, 1.0)
        assert span >= 1.0
        assert {k for due, k in sched if due < span} == {0, 1, 2, 3}
        # no longer than the first request of the last tenant needs
        last = max(min(d for d, k in sched if k == kk) for kk in range(4))
        assert span == max(1.0, last + 1e-6)


def test_a_served_run_knows_each_tenant_plan(tiny_root, tmp_path):
    """The traced requests of each tenant, under the plan the daemon ran
    for it: what the kernel 1 roofline counts its bytes from."""
    conf = tiny_serve_config()
    pool = None
    try:
        pool = serve.Pool(conf, "cpu", str(tmp_path), tiny_root.path)
        pool.warm(timeout_s=120.0)
        plans = serve.tenant_plans(conf["tenants"])
    finally:
        if pool is not None:
            pool.close()
    assert len(plans) == len(conf["tenants"])
    for t, pl in zip(conf["tenants"], plans):
        assert pl.cfg.thread_num == t["request"]["threads"]
        assert pl.cfg.chunk_size == t["request"]["chunk"]


def _alter(monkeypatch, fault):
    """Alter every answer where the daemon produces it, before it goes on
    the wire."""
    from pluss_torch.serve.server import Server
    real = Server._respond_ok

    def respond_ok(self, req, payload, k):
        payload = copy.deepcopy(payload)
        if fault == "mrc_point":
            c, m = payload["mrc"][len(payload["mrc"]) // 2]
            payload["mrc"][len(payload["mrc"]) // 2] = [c, m + 1e-6]
        elif fault == "histogram_entry":
            key = sorted(payload["histogram"])[0]
            payload["histogram"][key] *= 1 + 1e-6
        elif fault == "refs_off":
            payload["refs"] += 1
        return real(self, req, payload, k)
    monkeypatch.setattr(Server, "_respond_ok", respond_ok)


@pytest.mark.parametrize("fault", ["mrc_point", "histogram_entry",
                                   "refs_off"])
def test_an_altered_answer_is_not_correct(tiny_root, monkeypatch, fault):
    cell = _cell(tiny_root)
    _alter(monkeypatch, fault)
    out = _run(tiny_root, cell)
    assert out["failed"] == 0
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out"])
def test_a_broken_walk_under_the_daemon_is_not_correct(tiny_root,
                                                       monkeypatch, fault):
    """The engine the daemon dispatches to, broken underneath: its window
    walk leaves the state unchanged, or walks half of the thread rows."""
    from test_bench_harness import _break
    _break(monkeypatch, fault)
    out = _run(tiny_root, _cell(tiny_root))
    assert out["failed"] == 0
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["shed", "error", "brownout"])
def test_a_shed_or_failed_request_counts_in_failed(tiny_root, monkeypatch,
                                                   fault):
    """A request shed, answered with an error, or answered by the daemon's
    CPU brown-out (its breaker open: the answer is right, but it was not
    served on the card) has failed."""
    from pluss_torch.resilience.breaker import CircuitBreaker
    from pluss_torch.resilience.errors import Overloaded
    from pluss_torch.serve.admission import AdmissionQueue
    from pluss_torch.serve.server import Server
    if fault == "brownout":
        real_allow, real_exec = CircuitBreaker.allow, Server._execute
        lead = {}

        def execute(self, batch, *a, **k):
            lead["id"] = batch[0].id if batch else None
            return real_exec(self, batch, *a, **k)

        def allow(self):
            return lead.get("id") != "r2" and real_allow(self)
        monkeypatch.setattr(Server, "_execute", execute)
        monkeypatch.setattr(CircuitBreaker, "allow", allow)
    elif fault == "shed":
        real = AdmissionQueue.submit

        def submit(self, req):
            if req.id == "r2":
                raise Overloaded("shed for the test", site="test")
            return real(self, req)
        monkeypatch.setattr(AdmissionQueue, "submit", submit)
    else:
        real = Server._execute_spec

        def execute_spec(self, batch, *a, **k):
            if any(r.id == "r2" for r in batch):
                raise RuntimeError("failed for the test")
            return real(self, batch, *a, **k)
        monkeypatch.setattr(Server, "_execute_spec", execute_spec)
    cell = _cell(tiny_root)
    out = _run(tiny_root, cell)
    assert out["attempted"] == 8 and out["failed"] >= 1
    assert not out["correct"]
    if fault == "brownout":   # the brown-out's answer itself is right
        assert out["failed"] == 1
        assert out["checks"]["counts_off"]["value"] == 0


def test_the_arrivals_follow_the_seed():
    mix = {"run": "open", "rate_per_s": 3.0}
    a = traffic.arrivals(mix, 4, 2**33 + 7, 51)
    assert a == traffic.arrivals(mix, 4, 2**33 + 7, 51)
    b = traffic.arrivals(mix, 4, 8, 51)
    assert len(a) == len(b) == 153
    # the same arrivals, one every 1 / rate seconds, for every seed
    assert [d for d, _ in a] == [d for d, _ in b]
    np.testing.assert_allclose(np.diff([d for d, _ in a]), 51 / 153)
    assert a[0][0] == 0 and a[-1][0] < 51
    # the same requests, the tenants' order drawn from the seed
    assert [k for _, k in a] != [k for _, k in b]
    for sched in (a, b):
        assert sorted(np.bincount([k for _, k in sched]).tolist()) == \
            [38, 38, 38, 39]


def test_an_open_mix_runs_only_on_a_serve_configuration():
    open_mix = {"run": "open", "rate_per_s": 1.0}
    for conf in (tiny_config("gemm", 16), tiny_trace_config()):
        with pytest.raises(ValueError, match="serve"):
            traffic.check_mix(open_mix, conf)
    conf = _config()
    for name in ("full", "sampled"):
        with open(os.path.join(ROOT, "benchmark", "traffic",
                               f"{name}.json")) as f:
            with pytest.raises(ValueError, match="open"):
                traffic.check_mix(json.load(f), conf)
    with pytest.raises(ValueError, match="rate_per_s"):
        traffic.check_mix({"run": "open"}, conf)
    for key in ("burst", "arrivals"):
        with pytest.raises(ValueError, match="unknown"):
            traffic.check_mix(dict(open_mix, **{key: 2}), conf)
    traffic.check_mix(open_mix, conf)


def test_every_cell_of_the_benchmark_loads():
    bench = harness.load_bench(ROOT)
    for w in bench["workloads"]:
        _, config, mix = harness.cell_of(bench, w["name"], ROOT)
        assert (mix["run"] == "open") == harness.is_serve(config)


def test_mrc_points_are_held_against_the_whole_curve():
    ref = np.array([1.0, 0.5, 0.5, 0.25])
    assert compare.mrc_points_gap([[0, 1.0], [1, 0.5], [3, 0.25]], ref) == 0
    assert compare.mrc_points_gap([[0, 1.0], [3, 0.2]], ref) == \
        pytest.approx(0.05)
    for bad in ([[1, 0.5], [3, 0.25]], [[0, 1.0], [2, 0.5]],
                [[0, 1.0], [4, 0.25]], []):
        assert compare.mrc_points_gap(bad, ref) == 1.0


def test_the_float32_control_fails(tiny_root):
    conf = tiny_serve_config()
    mix = {"run": "open", "rate_per_s": 2.0}
    got = serve.control(conf, mix, [1, 2, 3], 51, "cpu")
    assert [r["seed"] for r in got] == [1, 2, 3]
    for r in got:
        assert not r["correct"], r
        assert r["cri_gap"] > compare.LIMITS["cri_gap"] or \
            r["mrc_gap"] > compare.LIMITS["mrc_gap"]
