"""The port's serve hardening on the CPU: the circuit breaker (held
against the JAX package's under one fake clock), the crash-safe request
journal, tenant fairness, and the steps of ``pluss/hardening_smoke.py``
and ``pluss/obsplane_smoke.py`` run on the port's daemon — breaker trip,
brown-out, typed shedding and re-close; the journal recovered across a
restart; a watchdog abandon and its flight dump; the drain hard bound;
the metrics endpoint equal to the metrics verb; the connection cap.
Plus the ``heartbeat_dir`` exporter's start and stop and the warm-window quirk, pinned on
both packages.
"""

import io
import json
import os
import socket
import time
import urllib.request

import numpy as np
import pytest

from pluss.resilience import CircuitBreaker as JaxBreaker
from pluss.serve import ServeConfig as JaxServeConfig
from pluss.serve import Server as JaxServer
from pluss.serve.journal import RequestJournal as JaxJournal
from pluss_torch import engine, obs
from pluss_torch.resilience import (CacheCorrupt, CircuitBreaker, FaultPlan,
                                    faults)
from pluss_torch.resilience.errors import Overloaded
from pluss_torch.serve import (AdmissionQueue, Client, RequestJournal,
                               ServeConfig, Server)
from pluss_torch.serve.protocol import parse_request
from tests.test_torch_serve_server import (  # noqa: F401  (fixtures)
    clean_faults,
    jax_server_factory,
    server_factory,
    solo_spec,
)

_GEMM = {"model": "gemm", "n": 16, "threads": 2, "chunk": 2,
         "output": "both"}


# ---------------------------------------------------------------------------
# circuit breaker (unit, fake clock, against JAX's)


def _fake_clock():
    t = [0.0]
    return t, lambda: t[0]


def _drive(cls, script):
    """Run one scripted sequence of breaker calls under a fake clock;
    returns every observable answer."""
    t, clock = _fake_clock()
    b = cls(threshold=2, window_s=3.0, cooldown_s=2.0, max_cooldown_s=5.0,
            jitter=0.2, seed=11, clock=clock, name="t.breaker")
    out = []
    for op, arg in script:
        if op == "at":
            t[0] = arg
            continue
        r = getattr(b, op)()
        out.append((op, r, b.state, round(b.retry_after_s(), 9)))
    return out


def test_breaker_sequence_matches_jax():
    script = [("allow", None), ("record_failure", None), ("at", 10.0),
              ("record_failure", None), ("allow", None),
              ("record_failure", None), ("allow", None), ("at", 12.7),
              ("allow", None), ("allow", None), ("release_probe", None),
              ("allow", None), ("record_failure", None), ("at", 30.0),
              ("allow", None), ("record_failure", None), ("at", 60.0),
              ("allow", None), ("record_success", None), ("allow", None),
              ("record_failure", None), ("record_failure", None)]
    assert _drive(CircuitBreaker, script) == _drive(JaxBreaker, script)


def test_breaker_closed_open_halfopen_closed():
    t, clock = _fake_clock()
    b = CircuitBreaker(threshold=2, window_s=10.0, cooldown_s=5.0,
                       jitter=0.0, clock=clock, name="t.breaker")
    assert b.state == "closed" and b.allow()
    b.record_failure()
    assert b.state == "closed"
    b.record_failure()
    assert b.state == "open" and not b.allow()
    assert b.retry_after_s() == pytest.approx(5.0)
    t[0] = 5.1
    assert b.state == "half_open"
    assert b.allow() and not b.allow()
    b.record_success()
    assert b.state == "closed" and b.allow()


def test_breaker_transition_counters(tmp_path):
    obs.configure(str(tmp_path / "t.jsonl"))
    try:
        t, clock = _fake_clock()
        b = CircuitBreaker(threshold=1, cooldown_s=1.0, jitter=0.0,
                           clock=clock, name="serve.breaker")
        b.record_failure()
        t[0] = 1.5
        assert b.allow()
        b.record_success()
        cs, gs = obs.counters(), obs.gauges()
    finally:
        obs.shutdown()
    assert cs["serve.breaker.open"] == 1 and cs["serve.breaker.close"] == 1
    assert cs["serve.breaker.probe"] == 1
    assert gs["serve.breaker.state"] == 0.0


# ---------------------------------------------------------------------------
# request journal (unit)


def test_journal_open_done_roundtrip_and_cross_package(tmp_path):
    path = str(tmp_path / "j" / "serve_journal.jsonl")
    j = RequestJournal(path)
    j.append("a", {"id": "a", "model": "gemm"}, tenant="t1",
             deadline_epoch=123.5)
    j.append("b", {"id": "b", "model": "mvt"})
    j.complete("a")
    assert j.is_open("b") and not j.is_open("a")
    assert [r["rid"] for r in j.unanswered()] == ["b"]
    (rec,) = RequestJournal(path).unanswered()
    assert rec["obj"] == {"id": "b", "model": "mvt"}
    # the JAX package reads the port's journal, and the other way round
    assert JaxJournal(path).unanswered() == RequestJournal(path).unanswered()
    jpath = str(tmp_path / "jax.jsonl")
    jj = JaxJournal(jpath)
    jj.append("x", {"id": "x", "model": "gemm"}, deadline_epoch=9.0)
    assert RequestJournal(jpath).unanswered() == jj.unanswered()
    j.complete("never-seen")


def test_journal_torn_tail_and_midfile_corruption(tmp_path, capsys):
    path = str(tmp_path / "serve_journal.jsonl")
    j = RequestJournal(path)
    j.append("a", {"id": "a"})
    with open(path, "a") as fh:
        fh.write('{"rid": "b", "st": "op')
    j2 = RequestJournal(path)
    assert "crash artifact" in capsys.readouterr().err
    j2.append("c", {"id": "c"})
    assert [r["rid"] for r in RequestJournal(path).unanswered()] \
        == ["a", "c"]
    with open(path) as fh:
        good = fh.read()
    with open(path, "w") as fh:
        fh.write("NOT JSON AT ALL\n" + good)
    with pytest.raises(CacheCorrupt):
        RequestJournal(path)


def test_journal_compaction_preserves_open_set(tmp_path):
    path = str(tmp_path / "serve_journal.jsonl")
    j = RequestJournal(path, max_records=8)
    for i in range(8):
        j.append(f"r{i}", {"id": f"r{i}"})
        if i != 3:
            j.complete(f"r{i}")
    with open(path) as fh:
        assert len([ln for ln in fh.read().splitlines() if ln]) < 15
    assert [r["rid"] for r in RequestJournal(path).unanswered()] == ["r3"]


# ---------------------------------------------------------------------------
# tenant fairness (unit + daemon)


def _req(rid, tenant=""):
    return parse_request({"id": rid, "model": "gemm", "n": 16,
                          "tenant": tenant})


def test_drr_interleaves_a_flooding_tenant():
    q = AdmissionQueue(max_queue=64)
    for i in range(10):
        q.submit(_req(f"f{i}", "flood"))
    for i in range(2):
        q.submit(_req(f"p{i}", "polite"))
    order = []
    while True:
        req, expired = q.pop(timeout=0)
        if req is None:
            break
        order.append(req.id)
    assert order.index("p0") == 1 and order.index("p1") == 3


def test_rate_limit_sheds_typed_with_retry_after():
    q = AdmissionQueue(max_queue=64, tenant_rps=1.0, tenant_burst=1.0)
    q.submit(_req("a0", "a"))
    with pytest.raises(Overloaded) as ei:
        q.submit(_req("a1", "a"))
    assert ei.value.retry_after_ms and ei.value.retry_after_ms > 0
    q.submit(_req("b0", "b"))


def test_flooded_server_still_serves_the_quiet_tenant(server_factory):
    srv = server_factory(max_batch=1, max_queue=64, max_delay_ms=1)
    with Client(srv.socket_path) as c:
        c.request(_GEMM)
        hold = c.send({"sleep_ms": 500})
        time.sleep(0.15)
        noisy = [c.send({**_GEMM, "tenant": "noisy"}) for _ in range(8)]
        quiet = c.send({**_GEMM, "tenant": "quiet"})
        rq = c.recv(quiet)
        rn = [c.recv(i) for i in noisy]
        c.recv(hold)
    assert rq["ok"] and all(r["ok"] for r in rn)
    assert rq["latency_ms"] < max(r["latency_ms"] for r in rn)


# ---------------------------------------------------------------------------
# the hardening smoke's steps on the port's daemon


def _trace(tmp_path):
    path = str(tmp_path / "smoke_trace.bin")
    rng = np.random.default_rng(20260805)
    (rng.integers(0, 1 << 10, 1 << 12).astype(np.uint64)
     << np.uint64(6)).astype("<u8").tofile(path)
    return path


def test_breaker_trips_browns_out_sheds_and_recloses(tmp_path, clean_faults):
    """hardening_smoke: health/ready on a fresh daemon; two injected
    dispatch failures open the breaker; a spec request browns out on the
    CPU (stamped ``cpu_brownout``, equal to the clean run); a trace
    request is shed typed with ``retry_after_ms``; the probe after the
    cooldown closes the breaker; every journaled request is done."""
    trace_path = _trace(tmp_path)
    obs.configure(str(tmp_path / "events.jsonl"))
    srv = Server(socket_path=str(tmp_path / "s.sock"),
                 config=ServeConfig(journal_dir=str(tmp_path),
                                    breaker_threshold=2,
                                    breaker_window_s=30.0,
                                    breaker_cooldown_s=0.5, device="cpu"))
    srv.start()
    try:
        with Client(srv.address) as cl:
            h = cl.request({"op": "health"})
            assert h["ok"] and h["breaker"] == "closed"
            rd = cl.request({"op": "ready"})
            assert rd["ready"] and not rd["reasons"]
            clean = cl.request(dict(_GEMM))
            assert clean["ok"] and not clean.get("degradations")
            faults.install(FaultPlan.parse("dispatch_fail@1,dispatch_fail@2"))
            for _ in range(2):
                r = cl.request(dict(_GEMM))
                assert not r["ok"] \
                    and r["error"]["type"] == "ResourceExhausted"
            assert cl.request({"op": "health"})["breaker"] == "open"
            rd = cl.request({"op": "ready"})
            assert not rd["ready"] and any("breaker" in s
                                           for s in rd["reasons"])
            bo = cl.request(dict(_GEMM))
            assert bo["ok"] and "cpu_brownout" in bo["degradations"]
            assert bo["mrc"] == clean["mrc"]
            assert bo["histogram"] == clean["histogram"]
            sh = cl.request({"trace": trace_path, "fmt": "u64"})
            assert not sh["ok"] and sh["error"]["type"] == "Overloaded"
            assert sh["error"].get("retry_after_ms", 0) > 0
            time.sleep(0.7)
            pr = cl.request(dict(_GEMM))
            assert pr["ok"] and not pr.get("degradations")
            assert cl.request({"op": "health"})["breaker"] == "closed"
            assert cl.request({"op": "ready"})["ready"]
        faults.install(None)
        srv.shutdown(drain_timeout_s=30)
        c1 = obs.counters()
    finally:
        faults.install(None)
        srv.shutdown(drain_timeout_s=30)
        obs.shutdown()
    for k in ("serve.breaker.open", "serve.breaker.close",
              "serve.breaker.brownout", "serve.breaker.shed"):
        assert c1.get(k, 0) >= 1, k
    assert c1["serve.journal.appended"] >= 5
    assert c1["serve.journal.appended"] == c1["serve.journal.completed"]


def test_unresolved_probe_does_not_wedge_breaker(server_factory,
                                                 clean_faults):
    srv = server_factory(max_batch=1, breaker_threshold=1,
                         breaker_cooldown_s=0.2)
    with Client(srv.socket_path) as c:
        assert c.request(dict(_GEMM))["ok"]
        faults.install(FaultPlan.parse("dispatch_fail@1"))
        assert not c.request(dict(_GEMM))["ok"]
        assert c.request({"op": "health"})["breaker"] == "open"
        time.sleep(0.35)
        orig = srv._execute_spec
        state = {"boomed": False}

        def probe_vanishes(batch, **kw):
            if not state["boomed"]:
                state["boomed"] = True
                raise RuntimeError("probe vanished, no device evidence")
            return orig(batch, **kw)

        srv._execute_spec = probe_vanishes
        try:
            r = c.request(dict(_GEMM))
            assert not r["ok"] and r["error"]["type"] == "PlussError"
            r2 = c.request(dict(_GEMM))
            assert r2["ok"] and not r2.get("degradations")
            assert c.request({"op": "health"})["breaker"] == "closed"
        finally:
            srv._execute_spec = orig


def test_brownout_is_the_only_dispatch_off_the_daemon_device(
        server_factory, clean_faults, monkeypatch):
    """Every dispatch passes the daemon's device but the brown-out, which
    passes ``"cpu"`` to its one ``run_resilient`` call."""
    from pluss_torch.resilience import ladder

    seen = []
    real = ladder.run_resilient

    def spy(spec, cfg=None, **kw):
        seen.append(kw.get("device"))
        return real(spec, cfg, **kw)

    monkeypatch.setattr(ladder, "run_resilient", spy)
    srv = server_factory(max_batch=1, breaker_threshold=1,
                         breaker_cooldown_s=30.0)
    with Client(srv.socket_path) as c:
        assert c.request(dict(_GEMM))["ok"]
        faults.install(FaultPlan.parse("dispatch_fail@1"))
        assert not c.request(dict(_GEMM))["ok"]
        bo = c.request(dict(_GEMM))
    assert bo["degradations"] == ["cpu_brownout"]
    assert seen == [srv.device, "cpu"]


def test_build_failure_on_the_card_is_answered_typed_not_browned_out(
        server_factory, clean_faults, monkeypatch):
    """A daemon on the card whose kernel does not build (``build.load``
    raises ``BuildError``, as a failed nvcc does) answers each request
    with a typed ``CompileError``; the failure does not count toward the
    breaker (threshold 1 here), so no request is browned out to the CPU.
    The card is faked: the daemon's device is ``cuda`` and the sort
    budget is the host's, so the run reaches its build step."""
    from pluss_torch.ops import build

    loads = []

    def no_nvcc(name):
        loads.append(name)
        raise build.BuildError(f"nvcc failed for {name} (test)")

    monkeypatch.setattr(build, "load", no_nvcc)
    monkeypatch.setattr(engine, "sort_budget",
                        lambda dev: engine.CPU_SORT_BUDGET)
    srv = server_factory(max_batch=1, breaker_threshold=1,
                         breaker_cooldown_s=30.0, device="cuda")
    mvt = {"model": "mvt", "n": 12, "threads": 2, "chunk": 2,
           "output": "both"}
    with Client(srv.socket_path) as c:
        for i in range(3):
            r = c.request(dict(mvt, id=f"b{i}"))
            assert not r["ok"] and r["error"]["type"] == "CompileError", r
        assert c.request({"op": "health"})["breaker"] == "closed"
    assert loads == ["event_hist"] * 3
    assert srv.breaker.state == "closed"


def test_watchdog_abandons_hung_dispatch_and_dumps_flight(tmp_path,
                                                          clean_faults,
                                                          monkeypatch):
    """obsplane_smoke: the metrics endpoint and the metrics verb render
    the same counters; health carries the SLO burn; ``hang@1`` under a
    short dispatch timeout is abandoned typed; the flight dump passes
    ``stats --check``; after shutdown the stream passes ``stats --check``
    and ``stats --trace`` resolves the traced request to admission →
    admit → queue wait → batch → demux."""
    from pluss_torch.obs import stats as stats_mod
    from pluss_torch.obs import telemetry

    monkeypatch.setenv("PLUSS_FAULT_HANG_S", "3.0")
    events = str(tmp_path / "events.jsonl")
    obs.configure(events)
    srv = Server(socket_path=str(tmp_path / "s.sock"),
                 config=ServeConfig(journal_dir=str(tmp_path),
                                    metrics_port=0, flight_dir=str(tmp_path),
                                    dispatch_timeout_s=0.5, device="cpu"))
    srv.start()
    try:
        assert srv.metrics_port
        with Client(srv.address) as cl:
            assert cl.request(dict(_GEMM, id="r-spec-1"))["ok"]
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.metrics_port}/metrics",
                    timeout=10) as resp:
                assert resp.status == 200
                scraped = resp.read().decode()
            verb = cl.request({"op": "metrics"})
            assert verb["ok"]
            for needle in ("# TYPE pluss_serve_requests_spec counter",
                           "pluss_serve_ok 1"):
                assert needle in scraped and needle in verb["text"]

            def counter_lines(text):
                return [ln for ln in text.splitlines()
                        if ln.startswith("pluss_serve_ok ")
                        or ln.startswith("pluss_serve_requests_spec ")]

            assert counter_lines(scraped) == counter_lines(verb["text"])
            h = cl.request({"op": "health"})
            assert "slo_burn_fast" in h and "slo_burn_slow" in h
            faults.install(FaultPlan.parse("hang@1"))
            t0 = time.monotonic()
            hung = cl.request(dict(_GEMM, id="r-hang-1"))
            assert time.monotonic() - t0 < 2.5
            faults.install(None)
            assert not hung["ok"] and hung["error"]["type"] == "Overloaded"
            assert "watchdog" in hung["error"]["message"]
            assert hung["error"]["retryable"]
            dump = tmp_path / "flight-r-hang-1.jsonl"
            for _ in range(100):
                if dump.exists():
                    break
                time.sleep(0.05)
            assert stats_mod.main(str(dump), io.StringIO(), io.StringIO(),
                                  check=True) == 0
            meta = json.loads(dump.read_text().splitlines()[0])
            assert meta["flight_reason"] == "watchdog_abandon"
            assert meta["flight_trace"] == "r-hang-1"
            r2 = cl.request(dict(_GEMM, id="r-spec-2"))
            assert r2["ok"] and r2["mrc"] == solo_spec("gemm", 16)["mrc"]
    finally:
        faults.install(None)
        srv.shutdown(drain_timeout_s=30)
    telemetry.shutdown()
    assert stats_mod.main(events, io.StringIO(), io.StringIO(),
                          check=True) == 0
    out = io.StringIO()
    assert stats_mod.main(events, out, io.StringIO(), trace="r-spec-1") == 0
    tree = out.getvalue()
    for needle in ("trace r-spec-1:", "admission.verdict", "serve.admit",
                   "serve.queue_wait", "serve.batch", "serve.demux"):
        assert needle in tree, tree


def test_recovery_replays_open_entries_bit_identically(tmp_path):
    """A journal left by a daemon that died (written by the JAX
    package's journal class): the restarted port daemon replays the open
    entry once, answers the expired one typed without a dispatch, and
    leaves nothing open."""
    jdir = str(tmp_path / "j")
    j = JaxJournal(os.path.join(jdir, "serve_journal.jsonl"))
    j.append("done-0", dict(_GEMM, id="done-0"))
    j.complete("done-0")
    j.append("pend-0", dict(_GEMM, id="pend-0"), tenant="t",
             deadline_epoch=time.time() + 300)
    j.append("dead-0", {"id": "dead-0", "model": "mvt", "n": 16},
             deadline_epoch=time.time() - 5)
    del j
    solo = solo_spec("gemm", 16)
    d0 = engine.DEVICE_DISPATCHES
    srv = Server(socket_path=str(tmp_path / "r.sock"),
                 config=ServeConfig(journal_dir=jdir, device="cpu"))
    srv.start()
    try:
        with Client(srv.socket_path) as c:
            def collect(rid, budget=60.0):
                deadline = time.monotonic() + budget
                while time.monotonic() < deadline:
                    r = c.request({"op": "result", "id": rid})
                    if r.get("op") != "result":
                        return r
                    time.sleep(0.1)
                raise AssertionError(f"{rid} never recovered")

            r = collect("pend-0")
            assert r["ok"] and r["mrc"] == solo["mrc"]
            assert r["histogram"] == solo["histogram"]
            rd = collect("dead-0")
            assert not rd["ok"] and rd["error"]["type"] == "DeadlineExceeded"
            again = c.request({"op": "result", "id": "pend-0"})
            assert again.get("op") == "result" and not again["pending"]
    finally:
        srv.shutdown(drain_timeout_s=30)
    assert engine.DEVICE_DISPATCHES - d0 == 1
    assert not RequestJournal(
        os.path.join(jdir, "serve_journal.jsonl")).unanswered()


def test_journal_survives_a_restart(tmp_path):
    """Requests accepted by one daemon that stops before answering (the
    forced drain answers them retryable but the journal keeps them
    open as of the crash) replay on the next daemon started on the same
    journal directory."""
    jdir = str(tmp_path / "j")
    path = os.path.join(jdir, "serve_journal.jsonl")
    first = Server(socket_path=str(tmp_path / "a.sock"),
                   config=ServeConfig(journal_dir=jdir, device="cpu"))
    # admit without a device loop (the crash stand-in: never started)
    for rid in ("x1", "x2"):
        req = parse_request(dict(_GEMM, id=rid))
        first._journal_append(req, dict(_GEMM, id=rid))
    assert [r["rid"] for r in RequestJournal(path).unanswered()] \
        == ["x1", "x2"]
    second = Server(socket_path=str(tmp_path / "b.sock"),
                    config=ServeConfig(journal_dir=jdir, device="cpu"))
    second.start()
    try:
        with Client(second.socket_path) as c:
            got = {}
            deadline = time.monotonic() + 60
            while len(got) < 2 and time.monotonic() < deadline:
                for rid in ("x1", "x2"):
                    if rid not in got:
                        r = c.request({"op": "result", "id": rid})
                        if r.get("op") != "result":
                            got[rid] = r
                time.sleep(0.05)
    finally:
        second.shutdown(drain_timeout_s=30)
    solo = solo_spec("gemm", 16)
    assert all(r["ok"] and r["histogram"] == solo["histogram"]
               for r in got.values()) and len(got) == 2
    assert not RequestJournal(path).unanswered()


def test_drain_hard_bound_answers_stuck_work(clean_faults, tmp_path,
                                             monkeypatch):
    monkeypatch.setenv("PLUSS_FAULT_HANG_S", "4.0")
    srv = Server(socket_path=str(tmp_path / "d.sock"),
                 config=ServeConfig(max_batch=1, dispatch_timeout_s=0,
                                    device="cpu"))
    srv.start()
    faults.install(FaultPlan.parse("hang@1"))
    c = Client(srv.socket_path)
    stuck = c.send(dict(_GEMM, id="stuck"))
    time.sleep(0.3)
    queued = c.send(dict(_GEMM, id="queued"))
    t0 = time.monotonic()
    srv.shutdown(drain_timeout_s=0.5)
    assert time.monotonic() - t0 < 10
    rs = {rid: c.recv(rid) for rid in (stuck, queued)}
    c.close()
    for r in rs.values():
        assert not r["ok"] and r["error"]["type"] == "Overloaded"
        assert r["error"]["retryable"] is True


def test_conn_cap_sheds_typed_at_accept(server_factory):
    srv = server_factory(max_conns=1)
    with Client(srv.socket_path) as c1:
        assert c1.request({"op": "ping"})["ok"]
        s2 = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s2.settimeout(10)
        s2.connect(srv.socket_path)
        doc = json.loads(s2.makefile("rb").readline())
        s2.close()
        assert not doc["ok"] and doc["error"]["type"] == "Overloaded"
        assert doc["error"].get("retry_after_ms", 0) > 0


def test_heartbeat_dir_is_refused(tmp_path):
    """``heartbeat_dir`` is no longer refused: it starts the multihost
    heartbeat exporter with the daemon and stops it with the drain."""
    srv = Server(socket_path=str(tmp_path / "h.sock"),
                 config=ServeConfig(heartbeat_dir=str(tmp_path),
                                    num_processes=1, prom_refresh_s=0.1,
                                    device="cpu"))
    srv.start()
    try:
        assert srv._hb_stop is not None
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# the warm-window quirk, on both packages


def _quirk_run(pkg, tmp_path, monkeypatch, tuned_window):
    """Start ``pkg``'s daemon with ``--warm <trace>`` (a tuned window
    persisted when ``tuned_window``), wait for ready, send one trace
    request, and return (its response, the daemon's residency
    counters)."""
    trace_path = str(tmp_path / f"warm_{pkg}.u64")
    np.random.default_rng(9).integers(0, 1 << 12, 30000) \
        .astype("<u8").tofile(trace_path)
    cache = tmp_path / f"pc_{pkg}"
    monkeypatch.delenv("PLUSS_NO_PLAN_CACHE", raising=False)
    monkeypatch.setenv("PLUSS_PLAN_CACHE_DIR", str(cache))
    if pkg == "port":
        from pluss_torch import autotune, plancache, residency

        salt, server, config = (plancache.runtime_salt("cpu"), Server,
                                ServeConfig(warm=trace_path, device="cpu"))
    else:
        from pluss import autotune, plancache, residency

        salt, server, config = (plancache.runtime_salt(), JaxServer,
                                JaxServeConfig(warm=trace_path))
    residency.reset()
    autotune.invalidate()
    if tuned_window:
        doc = {"version": 1, "salt": salt,
               "geometry": {"window": tuned_window}}
        save = autotune._save
        assert (save(doc, "cpu") if pkg == "port" else save(doc))
    srv = server(socket_path=str(tmp_path / f"{pkg}.sock"), config=config)
    srv.start()
    try:
        with Client(srv.socket_path) as c:
            deadline = time.monotonic() + 60
            while not c.request({"op": "ready"})["ready"]:
                assert time.monotonic() < deadline
                time.sleep(0.05)
            r = c.request({"trace": trace_path, "output": "histogram"})
            counters = c.request({"op": "stats"})["counters"]
    finally:
        srv.shutdown(drain_timeout_s=30)
        autotune.invalidate()
        residency.reset()
    return r, {k: v for k, v in counters.items()
               if k.startswith("residency.")}


@pytest.mark.parametrize("tuned_window", [None, 1 << 14])
def test_warm_window_quirk_on_both_packages(tmp_path, monkeypatch,
                                            tuned_window):
    """A reference quirk kept for parity: ``--warm`` stages a trace under
    the tuned window, while the trace request replays under
    ``TRACE_WINDOW``; the residency key holds the window, so with a tuned
    window other than 2^20 the warm entry is not hit (the request stages
    through instead).  Without a tuned window the warm entry is hit.
    Both packages answer alike either way."""
    got, gc = _quirk_run("port", tmp_path, monkeypatch, tuned_window)
    want, wc = _quirk_run("jax", tmp_path, monkeypatch, tuned_window)
    assert got["ok"] and want["ok"]
    assert got["histogram"] == want["histogram"]
    hit = tuned_window is None
    assert (gc.get("residency.hit", 0) == 1) == hit, gc
    assert (wc.get("residency.hit", 0) == 1) == hit, wc
    assert (gc.get("residency.stage_through", 0) == 1) == (not hit), gc
    assert (wc.get("residency.stage_through", 0) == 1) == (not hit), wc


@pytest.mark.parametrize("device,runs", [("cuda", 1), ("cpu", 0)])
def test_warm_entry_runs_once_on_the_card(server_factory, monkeypatch,
                                          device, runs):
    """On the card a ``--warm`` model entry is planned and then run once
    (``engine.warm_run`` on the device loop), so the daemon's first
    request pays no first-launch costs; on the CPU it is only planned, as
    in JAX.  The card is faked: ``warm_run`` records its calls, the
    sort budget is the host's and no kernel is built."""
    from pluss_torch.ops import build

    calls = []
    monkeypatch.setattr(build, "load", lambda name: None)
    monkeypatch.setattr(engine, "sort_budget",
                        lambda dev: engine.CPU_SORT_BUDGET)
    monkeypatch.setattr(
        engine, "warm_run", lambda spec, cfg, **kw: calls.append(
            (spec.name, cfg.thread_num, cfg.chunk_size, str(kw["device"]))))
    srv = server_factory(warm="gemm:16:2:2", device=device)
    with Client(srv.socket_path) as c:
        t0 = time.monotonic()
        while not c.request({"op": "ready"})["ready"]:
            assert time.monotonic() - t0 < 60
            time.sleep(0.05)
    assert calls == [("gemm16", 2, 2, "cuda")] * runs


def test_warm_run_is_not_a_run_attempt(clean_faults):
    """``engine.warm_run`` dispatches the plan once and drops the result:
    no ``engine.run`` fault site (an armed ``oom`` stays armed for the
    first real run) and no dispatch count."""
    from pluss_torch.models import gemm

    faults.install(FaultPlan.parse("oom"))
    n0 = engine.DEVICE_DISPATCHES
    engine.warm_run(gemm(16), device="cpu")
    assert engine.DEVICE_DISPATCHES == n0
    with pytest.raises(Exception, match="out of memory"):
        engine.run(gemm(16), device="cpu")
