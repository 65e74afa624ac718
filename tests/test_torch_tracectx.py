"""The port's request trace context and observability plane on the CPU,
held against the JAX package's where both record the same thing:
``obs.tracectx`` (bind, capture/attach, the feed pool's handoff), spans
and events stamped ``trace``, ``trace_event`` emitting only inside a
bound context, a traced serve equal to an untraced one, the span tree
``stats --trace`` rebuilds from a port stream, the SLO burn monitor
(against JAX's under one fake clock) and the flight recorder.
"""

import io
import json
import threading
import time

import pytest

from pluss import obs as jax_obs
from pluss.obs import stats as jax_stats
from pluss.obs import tracectx as jax_tracectx
from pluss.obs.slo import SloMonitor as JaxSlo
from pluss_torch import obs
from pluss_torch.obs import stats as stats_mod
from pluss_torch.obs import telemetry, tracectx
from pluss_torch.obs.flight import FlightRecorder
from pluss_torch.obs.slo import SloMonitor
from pluss_torch.serve import Client
from tests.test_torch_serve_server import server_factory  # noqa: F401


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.shutdown()
    jax_obs.shutdown()
    yield
    obs.shutdown()
    jax_obs.shutdown()


def _events(path):
    recs, problems, _ = stats_mod.load(str(path))
    assert problems == [], problems
    return recs


_REQ = {"model": "gemm", "n": 16, "threads": 2, "chunk": 2,
        "output": "both"}


# ---------------------------------------------------------------------------
# tracectx primitives


def test_bind_nests_and_restores():
    assert tracectx.current() is None
    with tracectx.bind("r1"):
        assert tracectx.current() == "r1"
        with tracectx.bind("r2"):
            assert tracectx.current() == "r2"
        with tracectx.bind(None):
            assert tracectx.current() == "r1"
        assert tracectx.current() == "r1"
    assert tracectx.current() is None


def test_capture_attach_crosses_threads():
    got = {}

    def worker(token):
        with tracectx.attach(token):
            got["inner"] = tracectx.current()
        got["after"] = tracectx.current()

    with tracectx.bind("r-x"):
        t = threading.Thread(target=worker, args=(tracectx.capture(),))
        t.start()
        t.join()
    assert got == {"inner": "r-x", "after": None}


def test_feed_pool_workers_inherit_context():
    from pluss_torch.trace import _FeedPool

    seen = []
    with tracectx.bind("r-feed"):
        pool = _FeedPool(0, 3, claim_fn=lambda b: None,
                         read_fn=lambda b: seen.append(tracectx.current()),
                         compact_fn=lambda b, raw: raw,
                         encode_fn=lambda b, mid: b, workers=2, depth=2)
    with pool:
        assert list(pool) == [0, 1, 2]
    assert seen == ["r-feed"] * 3


def test_trace_event_needs_bound_context_like_jax(tmp_path):
    """The same calls in both packages write records with the same
    names, ``trace`` stamps and attributes, and stamp spans with the
    context they started under."""
    def record(o, ctx, path):
        o.configure(str(path))
        o.trace_event("unbound.event", x=1)
        with ctx.bind("r-1"):
            o.trace_event("bound.event", x=2)
            with o.span("bound.span", k=3):
                with ctx.bind("r-2"):
                    o.event("inner.event", y=4)
        with o.span("plain.span"):
            pass
        o.shutdown()

    record(obs, tracectx, tmp_path / "p.jsonl")
    record(jax_obs, jax_tracectx, tmp_path / "j.jsonl")

    def shape(path):
        return [{k: v for k, v in r.items() if k not in ("t", "dur", "pid",
                                                          "argv", "t_wall")}
                for r in _events(path) if r.get("ev") in ("span", "event")]

    got, want = shape(tmp_path / "p.jsonl"), shape(tmp_path / "j.jsonl")
    assert got == want
    names = {r["name"]: r for r in got}
    assert "unbound.event" not in names
    assert names["bound.event"]["trace"] == "r-1"
    assert names["bound.span"]["trace"] == "r-1"
    assert names["inner.event"]["trace"] == "r-2"
    assert "trace" not in names["plain.span"]


def test_disabled_trace_event_is_cheap():
    assert not obs.enabled()
    t0 = time.perf_counter()
    for _ in range(200_000):
        obs.trace_event("serve.admit", kind="spec")
    assert time.perf_counter() - t0 < 1.0


def test_cache_layers_attribute_inside_a_context(tmp_path, monkeypatch):
    """The plan cache's ``trace_event`` hook emits inside a request
    context only (a plan cache miss, then a hit)."""
    from pluss_torch import engine
    from pluss_torch.config import SamplerConfig
    from pluss_torch.models import gemm

    monkeypatch.delenv("PLUSS_NO_PLAN_CACHE", raising=False)
    monkeypatch.setenv("PLUSS_PLAN_CACHE_DIR", str(tmp_path / "pc"))
    obs.configure(str(tmp_path / "ev.jsonl"))
    cfg = SamplerConfig(thread_num=2, chunk_size=2)
    engine._plan_cached.cache_clear()
    engine.plan(gemm(12), cfg)                  # outside: nothing
    with tracectx.bind("r-pc"):
        engine.plan(gemm(12), cfg)              # inside: a hit
    obs.shutdown()
    consults = [r for r in _events(tmp_path / "ev.jsonl")
                if r.get("name") == "plan_cache.consult"]
    assert [(r["trace"], r["attrs"]["outcome"]) for r in consults] \
        == [("r-pc", "hit")]
    engine._plan_cached.cache_clear()


# ---------------------------------------------------------------------------
# traced serve


def test_traced_serve_equal_to_untraced(server_factory, tmp_path):
    srv = server_factory(max_batch=4)
    with Client(srv.socket_path) as c:
        untraced = c.request(dict(_REQ, id="u-1"))
    obs.configure(str(tmp_path / "ev.jsonl"))
    srv2 = server_factory(max_batch=4)
    with Client(srv2.socket_path) as c:
        traced = c.request(dict(_REQ, id="t-1"))
    assert untraced["ok"] and traced["ok"]
    assert traced["mrc"] == untraced["mrc"]
    assert traced["histogram"] == untraced["histogram"]


def test_traced_request_span_tree_matches_jax_render(server_factory,
                                                     tmp_path):
    """``stats --trace`` on a port stream rebuilds admit → queue →
    dispatch → demux, and the port's renderer prints what the JAX
    package's prints for the same stream."""
    ev = tmp_path / "ev.jsonl"
    obs.configure(str(ev))
    srv = server_factory(max_batch=4)
    with Client(srv.socket_path) as c:
        assert c.request(dict(_REQ, id="r-tree"))["ok"]
    srv.shutdown(drain_timeout_s=30)
    obs.shutdown()
    buf = io.StringIO()
    assert stats_mod.main(str(ev), buf, io.StringIO(), trace="r-tree") == 0
    tree = buf.getvalue()
    for needle in ("trace r-tree:", "admission.verdict", "serve.admit",
                   "serve.queue_wait", "serve.batch", "serve.demux",
                   "engine.dispatch"):
        assert needle in tree, f"missing {needle!r}:\n{tree}"
    jbuf = io.StringIO()
    assert jax_stats.main(str(ev), jbuf, io.StringIO(), trace="r-tree") == 0
    assert jbuf.getvalue() == tree
    assert stats_mod.main(str(ev), io.StringIO(), io.StringIO(),
                          check=True) == 0


def test_coalesced_batch_links_member_rids(server_factory, tmp_path):
    ev = tmp_path / "ev.jsonl"
    obs.configure(str(ev))
    srv = server_factory(max_batch=8, max_delay_ms=10, max_queue=32)
    with Client(srv.socket_path) as hold:
        hid = hold.send({"sleep_ms": 500})
        time.sleep(0.15)
        with Client(srv.socket_path) as c:
            ids = [c.send(dict(_REQ, id=f"co-{i}")) for i in range(3)]
            rs = [c.recv(i) for i in ids]
        hold.recv(hid)
    assert all(r["ok"] for r in rs)
    assert any(r.get("batched", 1) > 1 for r in rs)
    srv.shutdown(drain_timeout_s=30)
    obs.shutdown()
    recs = _events(ev)
    batch = [r for r in recs if r.get("name") == "serve.batch"
             and len(r.get("attrs", {}).get("traces", [])) > 1]
    assert batch
    members = set(batch[-1]["attrs"]["traces"])
    for rid in members:
        buf = io.StringIO()
        assert stats_mod.main(str(ev), buf, io.StringIO(), trace=rid) == 0
        assert "serve.batch" in buf.getvalue()
    coal = [r for r in recs if r.get("name") == "serve.coalesced"]
    assert coal and set(coal[-1]["attrs"]["traces"]) == members


def test_trace_request_attributes_its_feed(server_factory, tmp_path):
    """A trace request's replay spans (the feed pool's included) carry
    the request's id."""
    import numpy as np

    path = tmp_path / "refs.bin"
    np.random.default_rng(1).integers(0, 512, 4096).astype("<u8") \
        .tofile(path)
    ev = tmp_path / "ev.jsonl"
    obs.configure(str(ev))
    srv = server_factory(max_batch=2)
    with Client(srv.socket_path) as c:
        assert c.request({"trace": str(path), "id": "tr-1"})["ok"]
    srv.shutdown(drain_timeout_s=30)
    obs.shutdown()
    recs = _events(ev)
    replay = [r for r in recs if r.get("name") == "trace.replay_file"]
    assert replay and all(r.get("trace") == "tr-1" for r in replay)


# ---------------------------------------------------------------------------
# SLO burn-rate monitor, against JAX's


def test_slo_burn_math_matches_jax():
    def drive(cls):
        now = [1000.0]
        m = cls(target=0.1, fast_s=60, slow_s=600, burn_fast=2.0,
                burn_slow=1.0, min_count=10, clock=lambda: now[0])
        out = []
        for step, ok in enumerate([False] * 4 + [True] * 6 + [False] * 3):
            m.record(ok=ok)
            now[0] += 1.5
            out.append((round(m.burn(m.fast_s), 9),
                        round(m.burn(m.slow_s), 9), m.burning_fast()))
        now[0] += 700.0
        out.append((m.burn(m.fast_s), m.burning_fast()))
        return out

    assert drive(SloMonitor) == drive(JaxSlo)


def test_slo_transition_events_only(tmp_path):
    ev = tmp_path / "ev.jsonl"
    obs.configure(str(ev))
    now = [2000.0]
    m = SloMonitor(target=0.1, fast_s=60, slow_s=60, burn_fast=2.0,
                   burn_slow=2.0, min_count=4, clock=lambda: now[0])
    for _ in range(8):
        m.record(ok=False)
    for _ in range(40):
        m.record(ok=True)
    obs.shutdown()
    fast = [r for r in _events(ev) if r.get("name") == "slo.burn"
            and r["attrs"]["window"] == "fast"]
    assert [r["attrs"]["state"] for r in fast] == ["burning", "recovered"]


def test_slo_health_and_ready_gate(server_factory):
    srv = server_factory(max_batch=4)
    with Client(srv.socket_path) as c:
        assert c.request(dict(_REQ, id="s-1"))["ok"]
        h = c.request({"op": "health"})
        assert "slo_burn_fast" in h and "slo_burn_slow" in h
        assert c.request({"op": "ready"})["ready"]
    srv.slo.min_count = 10
    for _ in range(50):
        srv.slo.record(ok=False)
    with Client(srv.socket_path) as c:
        rd = c.request({"op": "ready"})
    assert not rd["ready"] and any("slo" in s for s in rd["reasons"])


# ---------------------------------------------------------------------------
# flight recorder


def test_flight_dump_passes_stats_check(tmp_path):
    fr = FlightRecorder(out_dir=str(tmp_path), ring=64, throttle_s=0.0)
    fr.arm()
    try:
        with tracectx.bind("r-boom"):
            with obs.span("serve.batch", size=1):
                obs.trace_event("residency.consult", outcome="miss")
        path = fr.dump("dispatch_error", rid="r-boom")
    finally:
        fr.disarm()
        telemetry.shutdown()
    assert path and path.endswith("flight-r-boom.jsonl")
    for main in (stats_mod.main, jax_stats.main):
        assert main(path, io.StringIO(), io.StringIO(), check=True) == 0
    recs = [json.loads(ln) for ln in open(path)]
    assert recs[0]["flight_reason"] == "dispatch_error"
    assert recs[0]["flight_trace"] == "r-boom"
    assert any(r.get("name") == "serve.batch" and r.get("trace") == "r-boom"
               for r in recs)
    assert not any(r.get("ev") == "end" for r in recs)


def test_flight_ring_bounded_and_throttled(tmp_path):
    fr = FlightRecorder(out_dir=str(tmp_path), ring=16, throttle_s=60.0)
    fr.arm()
    try:
        with tracectx.bind("r-ring"):
            for i in range(100):
                obs.trace_event("tick", i=i)
        p1 = fr.dump("watchdog_abandon", rid="a")
        p2 = fr.dump("watchdog_abandon", rid="b")
        p3 = fr.dump("breaker_open", rid="c")
    finally:
        fr.disarm()
        telemetry.shutdown()
    assert p1 and p3 and p2 is None
    ticks = [r for r in (json.loads(ln) for ln in open(p1))
             if r.get("name") == "tick"]
    assert len(ticks) == 16 and ticks[-1]["attrs"]["i"] == 99


def test_flight_memory_only_until_dump(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert not obs.enabled()
    fr = FlightRecorder(out_dir=str(tmp_path), ring=32)
    fr.arm()
    try:
        assert telemetry.configured()
        obs.counter_add("serve.ok")
        with tracectx.bind("r-m"):
            obs.trace_event("serve.admit", kind="spec")
        assert list(tmp_path.iterdir()) == []
        path = fr.dump("drain_forced")
    finally:
        fr.disarm()
        telemetry.shutdown()
    recs = [json.loads(ln) for ln in open(path)]
    assert any(r.get("name") == "serve.admit" for r in recs)
    assert any(r.get("name") == "serve.ok" and r.get("ev") == "counter"
               for r in recs)


def test_server_owns_flight_session_no_counter_leak(server_factory):
    srv = server_factory(max_batch=2)
    with Client(srv.socket_path) as c:
        assert c.request(dict(_REQ, id="f-1"))["ok"]
    srv.shutdown(drain_timeout_s=30)
    assert not telemetry.configured()
