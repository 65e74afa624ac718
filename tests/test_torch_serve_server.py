"""The port's serving daemon (``pluss_torch.serve.server``) on the CPU:
in-process daemons on unix sockets and TCP (``ServeConfig(device="cpu")``),
mixed requests equal to solo port runs, shared-dispatch coalescing, typed
shedding, deadlines, drain; the same request list answered equally by an
in-process JAX daemon and the port's (apart from ``latency_ms``,
``batched`` and ``interference``); and each package's ``Client`` against
the other package's server.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from pluss.serve import Client as JaxClient
from pluss.serve import ServeConfig as JaxServeConfig
from pluss.serve import Server as JaxServer
from pluss_torch import cri, engine, mrc, obs
from pluss_torch import trace as trace_mod
from pluss_torch.config import SamplerConfig
from pluss_torch.models import REGISTRY
from pluss_torch.resilience import FaultPlan, faults
from pluss_torch.serve import Client, ServeConfig, Server

CPU = torch.device("cpu")


@pytest.fixture
def server_factory(tmp_path):
    """In-process port daemons on the CPU on throwaway unix sockets; every
    one is shut down at the end (daemon threads must not leak)."""
    servers = []
    counter = [0]

    def build(**cfg_kw) -> Server:
        counter[0] += 1
        sock = str(tmp_path / f"s{counter[0]}.sock")
        cfg_kw.setdefault("device", "cpu")
        srv = Server(socket_path=sock, config=ServeConfig(**cfg_kw))
        srv.start()
        servers.append(srv)
        return srv

    yield build
    for srv in servers:
        srv.shutdown(drain_timeout_s=30)


@pytest.fixture
def jax_server_factory(tmp_path):
    servers = []
    counter = [0]

    def build(**cfg_kw) -> JaxServer:
        counter[0] += 1
        sock = str(tmp_path / f"j{counter[0]}.sock")
        srv = JaxServer(socket_path=sock, config=JaxServeConfig(**cfg_kw))
        srv.start()
        servers.append(srv)
        return srv

    yield build
    for srv in servers:
        srv.shutdown(drain_timeout_s=30)


@pytest.fixture
def clean_faults():
    yield
    faults.install(None)


def solo_spec(model, n, threads=2, chunk=2, cache_kb=2560):
    """The port's solo CPU run of a request, shaped like a response."""
    cfg = SamplerConfig(thread_num=threads, chunk_size=chunk,
                        cache_kb=cache_kb)
    res = engine.run(REGISTRY[model](n), cfg, device=CPU)
    ri = cri.distribute(res.noshare_list(), res.share_list(),
                        cfg.thread_num)
    return {"mrc": [[int(c), float(m)]
                    for c, m in mrc.dedup_lines(mrc.aet_mrc(ri, cfg))],
            "histogram": {str(int(k)): float(v)
                          for k, v in sorted(ri.items())},
            "refs": int(res.max_iteration_count)}


def _trace(tmp_path, seed=3, n=4096):
    path = tmp_path / f"refs{seed}.bin"
    np.random.default_rng(seed).integers(0, 512, n).astype("<u8") \
        .tofile(path)
    return str(path)


def _gemm_c(n: int) -> str:
    from pluss_torch.frontend import polybench

    src = open(polybench.gemm_source_path()).read()
    return src.replace("#define N 128", f"#define N {n}")


# ---------------------------------------------------------------------------
# the port's daemon alone


def test_mixed_requests_match_solo(server_factory, tmp_path):
    srv = server_factory(max_batch=8, max_delay_ms=10)
    trace_path = _trace(tmp_path)
    with Client(srv.socket_path) as c:
        rs = c.request_many([
            {"model": "gemm", "n": 16, "threads": 2, "chunk": 2,
             "output": "both"},
            {"model": "mvt", "n": 12, "threads": 2, "chunk": 2,
             "output": "both"},
            {"trace": trace_path, "output": "both"},
        ])
    assert all(r["ok"] for r in rs)
    for r, (model, n) in zip(rs, [("gemm", 16), ("mvt", 12)]):
        solo = solo_spec(model, n)
        assert r["mrc"] == solo["mrc"] and r["histogram"] == solo["histogram"]
        assert r["refs"] == solo["refs"]
        assert "degradations" not in r
    rep = trace_mod.replay_file(trace_path, "u64", cls=64, device=CPU)
    ri = rep.histogram()
    assert rs[2]["histogram"] == {str(int(k)): float(v)
                                  for k, v in sorted(ri.items())}
    assert rs[2]["mrc"] == [[int(c), float(m)] for c, m in
                            mrc.dedup_lines(mrc.aet_mrc(ri, SamplerConfig()))]
    assert rs[2]["refs"] == 4096


def test_inline_spec_and_source_requests(server_factory):
    from pluss_torch.spec_codec import spec_to_json

    srv = server_factory(max_batch=4)
    doc = spec_to_json(REGISTRY["gemm"](13))
    doc["name"] = "tenant13"
    with Client(srv.socket_path) as c:
        r = c.request({"spec": doc, "threads": 2, "chunk": 2,
                       "output": "both"})
        s = c.request({"source": _gemm_c(16), "lang": "c",
                       "name": "gemm_src", "threads": 2, "chunk": 2,
                       "output": "both"})
        st = c.request({"op": "stats"})
    assert r["ok"] and r["model"] == "tenant13"
    assert r["histogram"] == solo_spec("gemm", 13)["histogram"]
    assert s["ok"] and s["model"] == "gemm_src"
    assert s["histogram"] == solo_spec("gemm", 16)["histogram"]
    assert st["counters"].get("serve.requests.source") == 1


def test_coalescing_shares_one_dispatch(server_factory):
    """Compatible requests queued behind a hold, differing only in
    ``cache_kb`` and ``output``, come back from ONE run of the engine
    (``batched`` 4, one more device dispatch), each equal to its solo
    run."""
    srv = server_factory(max_batch=8, max_delay_ms=10, max_queue=32)
    reqs = [{"model": "gemm", "n": 16, "threads": 2, "chunk": 2,
             "cache_kb": kb, "output": out}
            for kb, out in ((1, "mrc"), (2, "both"), (4, "histogram"),
                            (2560, "both"))]
    with Client(srv.socket_path) as c:
        hold = c.send({"sleep_ms": 400})
        time.sleep(0.1)   # the hold must reach the device loop first
        d0 = engine.DEVICE_DISPATCHES
        ids = [c.send(o) for o in reqs]
        rs = [c.recv(i) for i in ids]
        c.recv(hold)
        d1 = engine.DEVICE_DISPATCHES
    assert all(r["ok"] for r in rs)
    assert {r["batched"] for r in rs} == {4}
    assert d1 - d0 == 1
    for o, r in zip(reqs, rs):
        solo = solo_spec("gemm", 16, cache_kb=o["cache_kb"])
        for k in ("mrc", "histogram"):
            assert (k in r) == (o["output"] in (k, "both"))
            if k in r:
                assert r[k] == solo[k]


def test_incompatible_requests_not_coalesced(server_factory):
    srv = server_factory(max_batch=8, max_delay_ms=5, max_queue=32)
    with Client(srv.socket_path) as c:
        hold = c.send({"sleep_ms": 300})
        time.sleep(0.1)
        a = c.send({"model": "gemm", "n": 16, "threads": 2, "chunk": 2})
        b = c.send({"model": "gemm", "n": 16, "threads": 4, "chunk": 2})
        ra, rb = c.recv(a), c.recv(b)
        c.recv(hold)
    assert ra["ok"] and rb["ok"]
    assert ra["batched"] == 1 and rb["batched"] == 1


def test_overload_sheds_with_typed_error(server_factory):
    srv = server_factory(max_queue=2, max_batch=1, max_delay_ms=0)
    with Client(srv.socket_path) as c:
        hold = c.send({"sleep_ms": 500})
        time.sleep(0.1)
        ids = [c.send({"model": "gemm", "n": 16, "threads": 2,
                       "chunk": 2}) for _ in range(6)]
        rs = [c.recv(i) for i in ids]
        c.recv(hold)
    shed = [r for r in rs if not r["ok"]]
    assert shed, "a burst past max_queue must shed"
    assert all(r["error"]["type"] == "Overloaded"
               and r["error"]["retryable"] for r in shed)
    assert len(rs) - len(shed) <= 3


def test_deadline_exceeded_while_queued(server_factory):
    srv = server_factory(max_queue=8, max_batch=1, max_delay_ms=0)
    with Client(srv.socket_path) as c:
        hold = c.send({"sleep_ms": 400})
        time.sleep(0.1)
        rid = c.send({"model": "gemm", "n": 16, "threads": 2, "chunk": 2,
                      "deadline_ms": 50})
        r = c.recv(rid)
        c.recv(hold)
    assert not r["ok"] and r["error"]["type"] == "DeadlineExceeded"


def test_invalid_requests_get_typed_errors(server_factory):
    srv = server_factory()
    with Client(srv.socket_path) as c:
        r = c.request({"model": "no_such_model", "id": "x"})
        assert not r["ok"] and r["error"]["type"] == "InvalidRequest"
        c._sock.sendall(b"this is not json\n")
        raw = json.loads(c._rfile.readline())
        assert not raw["ok"] and raw["error"]["type"] == "InvalidRequest"
        assert c.request({"op": "ping"})["ok"]
        r = c.request({"op": "nope"})
        assert not r["ok"] and r["error"]["type"] == "InvalidRequest"


def test_degraded_request_isolated_from_neighbors(server_factory,
                                                  clean_faults):
    """An injected OOM rides the serve ladder inside its own batch; the
    degraded request and its neighbor both equal their solo runs."""
    solo_a, solo_b = solo_spec("gemm", 16), solo_spec("mvt", 12)
    srv = server_factory(max_batch=8, max_delay_ms=5, max_queue=32)
    faults.install(FaultPlan.parse("oom@1"))
    with Client(srv.socket_path) as c:
        hold = c.send({"sleep_ms": 300})
        time.sleep(0.1)
        ids_a = [c.send({"model": "gemm", "n": 16, "threads": 2,
                         "chunk": 2, "output": "both"}) for _ in range(2)]
        id_b = c.send({"model": "mvt", "n": 12, "threads": 2, "chunk": 2,
                       "output": "both"})
        rs_a = [c.recv(i) for i in ids_a]
        rb = c.recv(id_b)
        c.recv(hold)
    assert all(r["ok"] for r in rs_a) and rb["ok"]
    assert any(r.get("degradations") for r in rs_a + [rb])
    for r in rs_a:
        assert r["histogram"] == solo_a["histogram"]
    assert rb["histogram"] == solo_b["histogram"]


def test_serve_ladders_never_leave_the_device():
    from pluss_torch.resilience.ladder import LADDER, SERVE_LADDER
    from pluss_torch.serve.server import SERVE_TRACE_LADDER

    assert "cpu_fallback" not in SERVE_LADDER + SERVE_TRACE_LADDER
    assert set(SERVE_LADDER) <= set(LADDER)


def test_drain_answers_queued_then_stops(server_factory):
    srv = server_factory(max_batch=1, max_delay_ms=0, max_queue=16)
    with Client(srv.socket_path) as c:
        hold = c.send({"sleep_ms": 300})
        time.sleep(0.1)
        rid = c.send({"model": "gemm", "n": 16, "threads": 2, "chunk": 2})
        time.sleep(0.1)
        t = threading.Thread(target=srv.shutdown, daemon=True)
        t.start()
        r = c.recv(rid)
        c.recv(hold)
        t.join(timeout=30)
    assert r["ok"]
    assert srv._drained.is_set()
    srv.shutdown()   # idempotent


def test_shutdown_control_line_drains(server_factory):
    srv = server_factory()
    with Client(srv.socket_path) as c:
        assert c.request({"model": "gemm", "n": 8, "threads": 2})["ok"]
        ack = c.request({"op": "shutdown"})
    assert ack["ok"] and ack["draining"]
    assert srv._drained.wait(30)


def test_tcp_port_mode():
    srv = Server(port=0, config=ServeConfig(max_batch=2, device="cpu"))
    srv.start()
    try:
        assert srv.port != 0
        with Client(f"127.0.0.1:{srv.port}") as c:
            assert c.request({"op": "ping"})["ok"]
            r = c.request({"model": "gemm", "n": 13, "threads": 2,
                           "chunk": 2})
            assert r["ok"] and r["mrc"] == solo_spec("gemm", 13)["mrc"]
    finally:
        srv.shutdown()


def test_server_ctor_validation(tmp_path):
    with pytest.raises(ValueError):
        Server(config=ServeConfig(device="cpu"))
    with pytest.raises(ValueError):
        Server(socket_path=str(tmp_path / "x.sock"), port=1234,
               config=ServeConfig(device="cpu"))


def test_no_card_and_no_cpu_raises(tmp_path):
    """Without a card and without ``device="cpu"`` the daemon refuses to
    start: it never moves to the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(socket_path=str(tmp_path / "x.sock"))


def test_serve_slo_telemetry_block(server_factory, tmp_path):
    import io

    from pluss_torch.obs import stats as stats_mod

    sink = tmp_path / "tel.jsonl"
    obs.configure(str(sink))
    try:
        srv = server_factory(max_batch=8, max_delay_ms=5)
        with Client(srv.socket_path) as c:
            for _ in range(3):
                assert c.request({"model": "gemm", "n": 16, "threads": 2,
                                  "chunk": 2})["ok"]
        srv.shutdown()
        obs.flush_metrics()
        cs, gs = obs.counters(), obs.gauges()
    finally:
        obs.shutdown()
    assert cs["serve.requests"] == 3 and cs["serve.ok"] == 3
    assert cs["serve.batches"] >= 1
    assert "serve.p50_ms" in gs and "serve.queue_depth" in gs
    assert "serve.compile_inflight" in gs
    records, problems, _ = stats_mod.load(str(sink))
    assert not problems, problems
    out = io.StringIO()
    stats_mod.render(records, out)
    assert "serve SLO:" in out.getvalue()


# ---------------------------------------------------------------------------
# the port's daemon against the JAX package's


def _strip(doc):
    return {k: v for k, v in doc.items()
            if k not in ("latency_ms", "batched", "interference")}


def _request_list(tmp_path):
    from pluss_torch.spec_codec import spec_to_json

    inline = spec_to_json(REGISTRY["mvt"](12))
    inline["name"] = "tenant_mvt"
    bad = {"name": "oob", "arrays": [["A", 1]],
           "nests": [{"trip": 8, "body": [
               {"name": "A1", "array": "A", "addr_terms": [[0, 1]]}]}]}
    return [
        {"id": "a", "model": "gemm", "n": 16, "threads": 2, "chunk": 2,
         "output": "both"},
        {"id": "b", "model": "gemm", "n": 16, "threads": 2, "chunk": 2,
         "cache_kb": 1},
        {"id": "c", "model": "syrk_tri", "n": 10, "threads": 3,
         "output": "histogram"},
        {"id": "d", "spec": inline, "threads": 2, "output": "both"},
        {"id": "e", "source": _gemm_c(12), "name": "g12", "threads": 2,
         "chunk": 2, "output": "both"},
        {"id": "f", "trace": _trace(tmp_path), "output": "both"},
        {"id": "g", "trace": _trace(tmp_path, 5, 10000), "cls": 32,
         "window": 1 << 12},
        {"id": "h", "sleep_ms": 5},
        {"id": "i", "model": "no_such_model"},
        {"id": "j", "spec": bad, "threads": 2},
        {"id": "k", "model": "gemm", "output": "csv"},
        {"id": "l", "op": "ping"},
        {"id": "m", "op": "nope"},
        {"id": "n", "op": "result"},
    ]


def test_port_daemon_answers_like_the_jax_daemon(server_factory,
                                                 jax_server_factory,
                                                 tmp_path):
    objs = _request_list(tmp_path)
    port = server_factory(max_batch=4, max_delay_ms=5)
    jax = jax_server_factory(max_batch=4, max_delay_ms=5)
    with Client(port.socket_path) as c:
        got = [c.request(dict(o)) for o in objs]
    with JaxClient(jax.socket_path) as c:
        want = [c.request(dict(o)) for o in objs]
    for o, g, w in zip(objs, got, want):
        assert _strip(g) == _strip(w), o.get("id")
    assert [g["ok"] for g in got] == [True] * 8 + [False] * 3 + [True] \
        + [False] * 2


def test_placement_orders_leads_like_the_jax_daemon(server_factory,
                                                   jax_server_factory,
                                                   monkeypatch):
    """``PLUSS_SERVE_PLACEMENT=on``: one request list queued behind a
    sleep on each daemon (one request a dispatch) is answered equally and
    dispatched in the same lead order, which placement has reordered
    (a co-tenant of the previous dispatch that composes at cost 0 goes
    before one that does not)."""
    from pluss.serve import placement as jax_placement
    from pluss_torch.serve import placement

    monkeypatch.setenv("PLUSS_SERVE_PLACEMENT", "on")
    leads = {"port": [], "jax": []}
    for tag, mod in (("port", placement), ("jax", jax_placement)):
        def note(self, lead, _real=mod.Placer.note_dispatch, _tag=tag):
            if lead.kind == "spec":
                leads[_tag].append(lead.id)
            return _real(self, lead)
        monkeypatch.setattr(mod.Placer, "note_dispatch", note)
    objs = [{"id": "a", "model": "gemm", "n": 16, "threads": 2,
             "chunk": 2, "output": "both"},
            {"id": "b", "model": "mvt", "n": 12, "threads": 2, "chunk": 2,
             "output": "both"},
            {"id": "c", "model": "syrk", "n": 12, "threads": 2,
             "chunk": 2, "output": "both"},
            {"id": "d", "model": "gemm", "n": 16, "threads": 2,
             "chunk": 2, "cache_kb": 1, "output": "both"}]
    got = {}
    for tag, factory, client in (("port", server_factory, Client),
                                 ("jax", jax_server_factory, JaxClient)):
        srv = factory(max_batch=1)
        assert srv._placer is not None
        with client(srv.socket_path) as c:
            hold = c.send({"sleep_ms": 300})
            time.sleep(0.1)
            rids = [c.send(dict(o)) for o in objs]
            got[tag] = [c.recv(r) for r in rids]
            c.recv(hold)
    assert all(r["ok"] for r in got["port"])
    for o, g, w in zip(objs, got["port"], got["jax"]):
        assert _strip(g) == _strip(w), o["id"]
    assert leads["port"] == leads["jax"]
    assert sorted(leads["port"]) == ["a", "b", "c", "d"]
    assert leads["port"] != ["a", "b", "c", "d"]


def test_clients_cross_packages(server_factory, jax_server_factory):
    """JAX's ``Client`` against the port's server and the port's
    ``Client`` against JAX's: the wire is one protocol."""
    port = server_factory(max_batch=4)
    jax = jax_server_factory(max_batch=4)
    objs = [{"model": "gemm", "n": 12, "threads": 2, "chunk": 2,
             "output": "both"},
            {"model": "mvt", "n": 12, "threads": 2, "output": "histogram"}]
    with JaxClient(port.socket_path) as c:
        a = c.request_many([dict(o) for o in objs])
        assert c.request({"op": "ping"})["ok"]
    with Client(jax.socket_path) as c:
        b = c.request_many([dict(o) for o in objs])
        assert c.request({"op": "ping"})["ok"]
    assert [_strip(x) for x in a] == [_strip(x) for x in b]
    assert a[0]["histogram"] == solo_spec("gemm", 12)["histogram"]
