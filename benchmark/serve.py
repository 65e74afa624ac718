"""The served cell: the program's daemon in this process, driven open-loop.

A configuration with ``"kind": "serve"`` (``benchmark/configs/<name>.json``)
names the daemon's settings (``server``) and a pool of tenants, each with
the request object it sends on the wire, its spec document frozen from the
registry and its access count.  Its mix is an open loop
(:func:`benchmark.traffic.arrivals`): the requests due in the window's
first ``--seconds``, each to a tenant, at a rate of the mix's.

Set-up starts :class:`pluss_torch.serve.Server` with those settings on a
unix socket under the temporary directory, opens one connection per
tenant and sends one warm-up request on each, so that plans load from the
disk cache and kernels build.  In the window each tenant's sender thread
sends its requests at their due times, whatever is still unanswered, and
its reader thread reads the answers.  A request is timed from its due time
to the moment its whole response line has been read, so a sender that
falls behind hides nothing.  The window closes when the last request has
been answered or has failed: shed, answered with an error, answered by
the daemon's CPU brown-out (:data:`OFF_DEVICE`: not served on the card),
or unanswered ``timeout_s`` after it was due.  Then the peak memory is read, the server
shut down, and the reference (:mod:`benchmark.reference`) computes each
tenant's answer once; every response is held against its tenant's.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import socket
import statistics
import sys
import tempfile
import threading
import time

import numpy as np

from benchmark import compare, devtrace, harness, traffic

#: AF_UNIX's limit on a socket path, in bytes (107 and the NUL)
SOCKET_PATH_MAX = 107

#: a response's ``degradations`` that say it was computed off the card:
#: the daemon's open breaker runs spec batches on the host
OFF_DEVICE = frozenset({"cpu_brownout"})


class _Conn:
    """One client connection: a JSON object a line each way."""

    def __init__(self, path: str):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.connect(path)
        self.rfile = self.sock.makefile("rb")

    def send(self, obj: dict) -> None:
        self.sock.sendall(json.dumps(obj).encode() + b"\n")

    def readline(self) -> bytes:
        return self.rfile.readline()

    def close(self) -> None:
        with contextlib.suppress(OSError):
            self.sock.shutdown(socket.SHUT_RDWR)
        with contextlib.suppress(OSError):
            self.rfile.close()
            self.sock.close()


def _socket_path(tmp: str, root: str) -> str:
    path = os.path.join(tmp, "s")
    if len(path.encode()) <= SOCKET_PATH_MAX:
        return path
    # a temporary directory too deep for a socket: one in the checkout's
    # cache directory, by a path relative to the working directory
    d = os.path.join(root, ".benchcache")
    os.makedirs(d, exist_ok=True)
    return os.path.relpath(os.path.join(d, f"serve-{os.getpid()}.sock"))


class Pool:
    """The system under test: the daemon with the configuration's
    settings on ``device``, and one client connection per tenant."""

    def __init__(self, config: dict, device: str, tmp: str, root: str):
        s = config["server"]
        os.environ["PLUSS_SERVE_INTERFERENCE"] = s["interference"]
        os.environ["PLUSS_SERVE_PLACEMENT"] = s["placement"]
        from pluss_torch.serve import ServeConfig, Server
        self.tenants = config["tenants"]
        self.path = _socket_path(tmp, root)
        self.server = Server(socket_path=self.path, config=ServeConfig(
            max_queue=s["max_queue"], max_batch=s["max_batch"],
            max_delay_ms=s["max_delay_ms"], flight_dir=tmp,
            device=None if device == "cuda" else device))
        self.server.start()
        self.conns: list[_Conn] = []
        self.conns = [_Conn(self.path) for _ in self.tenants]

    def warm(self, timeout_s: float) -> None:
        """One request per tenant, each answered before the next is sent;
        a failed one ends the run."""
        for k, (conn, t) in enumerate(zip(self.conns, self.tenants)):
            conn.sock.settimeout(timeout_s)
            conn.send(dict(t["request"], id=f"warm-{k}"))
            doc = json.loads(conn.readline() or b"null")
            conn.sock.settimeout(None)
            if not doc or not doc.get("ok"):
                raise RuntimeError(f"the warm-up request of tenant "
                                   f"{t['name']} failed: {doc}")

    def close(self, drain_timeout_s: float = 60.0) -> None:
        """Shut the server down (it drains its queue first) and close the
        connections.  Idempotent."""
        if self.server is not None:
            server, self.server = self.server, None
            server.shutdown(drain_timeout_s)
        for c in self.conns:
            c.close()


class _Trace:
    """``torch.profiler`` over the window's first seconds
    (:func:`trace_span`: past the first request of every tenant), from the
    first due request until that long has passed and every request due in
    it has been answered; read back once the window has closed.  The host
    operations of every thread are recorded where the profiler can (the
    daemon's device loop is a thread of its own), so that idle gaps are
    named by what that thread ran."""

    def __init__(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            from torch._C._profiler import _ExperimentalConfig
            kw = {"experimental_config":
                  _ExperimentalConfig(profile_all_threads=True)}
        except (ImportError, TypeError):
            kw = {}
        self.prof = torch.profiler.profile(activities=acts, **kw)
        self.prof.__enter__()
        self.rf = torch.profiler.record_function("bench.trace")
        self.rf.__enter__()
        self.traced_s = None
        self.preds: list = []
        self.ops, self.busy_s, self.gaps, self.launched = [], None, [], []

    def stop(self, seconds: float) -> None:
        self.rf.__exit__(None, None, None)
        self.traced_s = seconds
        self.prof.__exit__(None, None, None)

    def read(self, clock) -> None:
        t_read = clock()
        events = self.prof.events()
        self.ops = devtrace.device_ops(events)
        if self.ops:
            self.busy_s = sum(s for _, s, _ in self.ops)
            self.gaps = devtrace.idle_gaps(events)
            self.launched = devtrace.launched_under(events)
        print(f"benchmark: read back {self.traced_s:.3f} s of device trace "
              f"in {clock() - t_read:.3f} s", file=sys.stderr)


class Window:
    """One open-loop window over ``conns`` (one per tenant): the requests
    of ``sched`` (:func:`benchmark.traffic.arrivals`) sent at their due
    times, their answers read as they come."""

    def __init__(self, conns: list, requests: list, sched: list,
                 timeout_s: float, clock):
        self.conns, self.clock, self.timeout_s = conns, clock, timeout_s
        self.sched = sched
        self.ids = [f"r{i}" for i in range(len(sched))]
        self.items: list[list] = [[] for _ in conns]
        for rid, (due, k) in zip(self.ids, sched):
            self.items[k].append((due, rid, dict(requests[k], id=rid)))
        self.got: dict = {}        # id -> (time read, response)
        self.sent: dict = {}       # id -> time sent
        self.cond = threading.Condition()
        self.stop = threading.Event()
        self.threads: list[threading.Thread] = []
        self.t0 = self.t_close = None

    def _send(self, conn, items) -> None:
        for due, rid, obj in items:
            wait = self.t0 + due - self.clock()
            if wait > 0 and self.stop.wait(wait):
                return
            self.sent[rid] = self.clock()
            try:
                conn.send(obj)
            except OSError:
                return

    def _read(self, conn, n: int) -> None:
        while n:
            try:
                line = conn.readline()
            except (OSError, ValueError):
                return
            if not line:
                return
            t = self.clock()
            doc = json.loads(line)
            with self.cond:
                self.got[doc.get("id")] = (t, doc)
                self.cond.notify_all()
            n -= 1

    def run(self, trace: _Trace | None = None, trace_s: float = 0.0,
            at_start=None) -> None:
        """Send, read, and return once every request has been answered or
        ``timeout_s`` has passed since the last one was due; ``trace`` is
        stopped once ``trace_s`` has passed and the requests due in it
        have been answered."""
        clock = self.clock
        if at_start is not None:
            at_start()
        self.t0 = clock()
        for conn, items in zip(self.conns, self.items):
            for target, arg in ((self._send, items), (self._read, len(items))):
                t = threading.Thread(target=target, args=(conn, arg),
                                     daemon=True)
                t.start()
                self.threads.append(t)
        deadline = self.t0 + self.sched[-1][0] + self.timeout_s
        traced = {rid for rid, (due, _) in zip(self.ids, self.sched)
                  if due < trace_s}
        while True:
            with self.cond:
                now = clock()
                done = len(self.got) == len(self.ids) or now >= deadline
                tracing = trace is not None and trace.traced_s is None
                stop_trace = tracing and now - self.t0 >= trace_s and \
                    traced <= self.got.keys()
                if not done and not stop_trace:
                    self.cond.wait(0.02 if tracing else 1.0)
                    continue
            if stop_trace or (done and tracing):
                trace.stop(clock() - self.t0)
                trace.preds = [rid for rid in self.ids if rid in traced]
            if done:
                break
        self.t_close = clock()

    def join(self) -> None:
        """Stop the senders; the readers end with their connections."""
        self.stop.set()
        for t in self.threads:
            t.join(timeout=10)

    def outcome(self) -> tuple[list, list]:
        """``(answered, failed)``: ``(tenant, seconds from due, response)``
        of each request answered in time on the card, ``(id, why)`` of
        each other."""
        answered, failed = [], []
        for rid, (due, k) in zip(self.ids, self.sched):
            t, doc = self.got.get(rid, (None, None))
            late = None if t is None else t - (self.t0 + due)
            if doc is None or late > self.timeout_s:
                failed.append((rid, "unanswered"))
            elif not doc.get("ok"):
                failed.append((rid, doc.get("error")))
            elif OFF_DEVICE & set(doc.get("degradations") or ()):
                failed.append((rid, "served off the card: "
                               f"{doc['degradations']}"))
            else:
                answered.append((k, late, doc))
        return answered, failed

    def sender_late_s(self) -> float:
        """How late the senders ran: the most a request went out after its
        due time."""
        return max((self.sent[rid] - (self.t0 + due) for rid, (due, _) in
                    zip(self.ids, self.sched) if rid in self.sent),
                   default=0.0)


def trace_span(sched: list, least_s: float) -> float:
    """Seconds from the window's start whose requests the device trace
    covers: at least ``least_s``, and past the first request of every
    tenant in ``sched``, so that each tenant's path is in the trace."""
    first: dict = {}
    for due, k in sched:
        first.setdefault(k, due)
    return max([least_s] + [due + 1e-6 for due in first.values()])


class ServeTraced(harness.Traced):
    """:class:`benchmark.harness.Traced` of a served run: the requests
    answered in the window are its predictions, the requests due in the
    traced span its traced ones, and each tenant's plan (the program's,
    which the daemon ran) is known with the traced requests it served."""

    def __init__(self, n_preds, spans, counters, tracer, mix, config,
                 tenant_of: dict, plans: list):
        super().__init__(n_preds, spans, counters, tracer, None, mix, config)
        self._tenant_of, self._plans = tenant_of, plans

    def planned(self) -> list:
        return [(pl, {"run": "full"}, t["spec"],
                 [rid for rid in self.traced_preds
                  if self._tenant_of[rid] == k])
                for k, (t, pl) in enumerate(zip(self.config["tenants"],
                                                self._plans))]


def tenant_plans(tenants: list) -> list:
    """The program's plan of each tenant's request, as the daemon planned
    it (from the process's plan memo)."""
    from pluss_torch import engine
    from pluss_torch.serve.protocol import parse_request
    out = []
    for t in tenants:
        req = parse_request(dict(t["request"], id="plan"))
        out.append(engine._plan_cached(req.spec, req.cfg, None, None,
                                       req.window))
    return out


def reference(tenant: dict, device: str):
    """The reference's counts for ``tenant``'s request: every access of
    its frozen spec document under its schedule
    (:func:`benchmark.reference.stream.full`)."""
    from benchmark.reference import stream
    r = tenant["request"]
    return stream.full(tenant["spec"], stream.Schedule(
        r["threads"], r["chunk"], r["ds"], r["cls"]), device)


def answer(tenant: dict, h, dtype=np.float64) -> tuple[dict, np.ndarray]:
    """The CRI histogram and the MRC of the counts ``h``, in ``dtype``."""
    from benchmark.reference import curve
    r = tenant["request"]
    rih = curve.distribute(h.noshare, h.share, r["threads"], dtype)
    return rih, curve.aet_mrc(rih, r["cache_kb"], dtype)


def check(config: dict, answered: list, device: str) -> dict:
    """Hold every answered response against its tenant's reference: the
    access count (``refs``), the CRI histogram (``histogram``) and each
    ``[c, m]`` point of the curve (``mrc``)."""
    nums = {"counts_off": 0, "cri_gap": 0.0, "mrc_gap": 0.0}
    for k, tenant in enumerate(config["tenants"]):
        docs = [doc for kk, _, doc in answered if kk == k]
        if not docs:
            continue
        h = reference(tenant, device)
        rih, crv = answer(tenant, h)
        for doc in docs:
            nums["counts_off"] += int(doc.get("refs") != h.accesses)
            hist = {int(c): float(v)
                    for c, v in (doc.get("histogram") or {}).items()}
            nums["cri_gap"] = max(nums["cri_gap"],
                                  compare.cri_gap(hist, rih))
            nums["mrc_gap"] = max(nums["mrc_gap"], compare.mrc_points_gap(
                doc.get("mrc") or [], crv))
    return nums


def control(config: dict, mix: dict, seeds: list, seconds: float,
            device: str) -> list[dict]:
    """The float32 control per seed: the reference in the program's place
    with its CRI and MRC in float32, for every tenant a run with that seed
    sends a request to, against the float64 reference."""
    memo, out = {}, []
    tenants = config["tenants"]
    for seed in seeds:
        nums = {"counts_off": 0, "cri_gap": 0.0, "mrc_gap": 0.0}
        for k in sorted({k for _, k in traffic.arrivals(
                mix, len(tenants), seed, seconds)}):
            if k not in memo:
                h = reference(tenants[k], device)
                rih, crv = answer(tenants[k], h)
                crih, ccrv = answer(tenants[k], h, np.float32)
                memo[k] = (compare.cri_gap(crih, rih),
                           compare.mrc_gap(ccrv, crv))
            nums["cri_gap"] = max(nums["cri_gap"], memo[k][0])
            nums["mrc_gap"] = max(nums["mrc_gap"], memo[k][1])
        out.append({"seed": seed, **nums, "correct": compare.judge(nums)})
    return out


def _window_records(path: str, counters0: dict,
                    counters1: dict) -> tuple[list, dict]:
    """The window's ``(name, seconds)`` of each span record that began at
    or after the ``bench.window`` event, and each counter's increase over
    the window (from in-process snapshots at its start and its end)."""
    recs = []
    with open(path) as f:
        for line in f:
            recs.append(json.loads(line))
    t_w = next((r["t"] for r in recs if r.get("ev") == "event"
                and r.get("name") == "bench.window"), None)
    spans = [(r["name"], r["dur"]) for r in recs if t_w is not None
             and r.get("ev") == "span" and r["t"] >= t_w]
    counters = {k: v - counters0.get(k, 0) for k, v in counters1.items()
                if v != counters0.get(k, 0)}
    return spans, counters


def run(root, bench, cell, config, mix, seed, seconds, trace, t_start,
        device) -> dict:
    """One run of a served cell on ``device``; returns the result line's
    object (see :func:`benchmark.harness.run`)."""
    import torch
    cuda = device == "cuda"
    clock = time.monotonic
    tenants = config["tenants"]
    sched = traffic.arrivals(mix, len(tenants), seed, seconds)
    timeout_s = float(mix.get("timeout_s", 120))
    with contextlib.ExitStack() as stack:
        tmp = tempfile.mkdtemp(prefix="bench-serve-")
        stack.callback(shutil.rmtree, tmp, True)
        if trace:
            # before the server starts, which otherwise makes a session
            # of its own in memory only
            from pluss_torch import obs
            tel = os.path.join(tmp, "telemetry.jsonl")
            obs.configure(tel)
            stack.callback(obs.shutdown)
        pool = Pool(config, device, tmp, root)
        stack.callback(pool.close, 5.0)   # a way out mid-run drains short
        pool.warm(timeout_s=900.0)
        setup_peak = 0
        if cuda:
            torch.cuda.synchronize()
            setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        win = Window(pool.conns, [t["request"] for t in tenants], sched,
                     timeout_s, clock)
        stack.callback(win.join)
        snap = {}
        tracer = _Trace() if trace else None

        def at_start():
            if trace:
                snap["counters"] = obs.counters()
                obs.event("bench.window")
        cpu0 = time.process_time()
        win.run(tracer, trace_span(sched, harness.TRACE_S) if trace
                else 0.0, at_start)
        cpu_s = time.process_time() - cpu0
        setup_s = win.t0 - t_start
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        pool.close()
        win.join()
        answered, failed = win.outcome()
        traced = None
        if trace:
            tracer.read(clock)
            counters1 = obs.counters()
            obs.shutdown()
            spans, counters = _window_records(tel, snap["counters"],
                                              counters1)
            if not any(n == "serve.batch" for n, _ in spans):
                print("benchmark: no serve.batch span of the window reached "
                      "the telemetry file", file=sys.stderr)
            traced = ServeTraced(len(answered), spans, counters, tracer,
                                 mix, config, dict(zip(win.ids, (
                                     k for _, k in sched))),
                                 tenant_plans(tenants))
    for rid, why in failed[:10]:
        print(f"request {rid} failed: {why}", file=sys.stderr)
    for k, t in enumerate(tenants):
        mine = sorted(late for kk, late, _ in answered if kk == k)
        if mine:
            print(f"benchmark: tenant {t['name']}: {len(mine)} answered, "
                  f"median {statistics.median(mine):.4f} s, longest "
                  f"{mine[-1]:.4f} s", file=sys.stderr)
    times = [late for _, late, _ in answered]
    metrics = {}
    for m in harness.metrics_of(bench, cell, trace):
        if trace:
            v = harness._reader(m["name"], root)(traced)
        else:
            v = {"setup_s": setup_s,
                 "pred_p90_s": statistics.quantiles(
                     times, n=10, method="inclusive")[8]
                 if len(times) >= 2 else None,
                 "peak_gib": peak / 2**30}.get(harness.quantity(m["name"]))
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    del pool
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = clock()
    nums = check(config, answered, device)
    reference_s = clock() - t_ref
    print(f"benchmark: the reference took {reference_s:.3f} s",
          file=sys.stderr)
    correct = bool(answered) and not failed and compare.judge(nums)
    out = {"correct": correct, "attempted": len(sched),
           "failed": len(failed), "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(0) if cuda
                      else "cpu",
                      "count": int(cell["chips"]),
                      "memory_peak_bytes": int(max(setup_peak, peak))
                      if cuda else 0}}
    if trace:
        out["device"]["busy_s"] = traced.busy_s
        out["device"]["window_s"] = traced.traced_s
        out["breakdown"] = {
            "device_ops": [[k, s] for k, s, _ in traced.ops[:10]],
            "idle_gaps": [[k, s] for k, s in tracer.gaps]}
    out["host_cpu_s"] = cpu_s   # the process's CPU seconds in the window
    out["window_s"] = win.t_close - win.t0
    out["sender_late_s"] = win.sender_late_s()
    out["reference_s"] = reference_s
    if cuda:
        out["card"] = harness._card()
    out["checks"] = {k: {"value": v, "limit": compare.LIMITS[k]}
                     for k, v in nums.items()}
    found = sorted({m.split(".")[0] for m in sys.modules}
                   & set(harness.FORBIDDEN))
    if found:
        raise SystemExit(f"benchmark: the process holds {found} after the "
                         "window; no result")
    return out
