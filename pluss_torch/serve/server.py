"""``serve``: the long-lived, multi-tenant MRC prediction daemon.

The port's copy of ``pluss/serve/server.py``.  The daemon dispatches to
ONE device, ``ServeConfig.device`` (default: the CUDA card; ``"cpu"``
serves on the host).  Where the JAX package switches its process-wide
default device, the port passes the device to each dispatch: every
dispatch takes ``ServeConfig.device`` except an open breaker's brown-out
rung, which passes ``device="cpu"`` to that one ``run_resilient`` call and
stamps ``cpu_brownout``.  A daemon built without a card and without
``device="cpu"`` raises: it never moves to the CPU by itself.  Every
device dispatch runs on the device loop's thread (the warm thread hands
its trace staging to the loop); the warm thread and the background
compile do host planning and kernel builds only.  ``heartbeat_dir``
starts the multihost heartbeat exporter
(:func:`pluss_torch.parallel.multihost.start_heartbeat_exporter`): the
``multihost.heartbeat_age_s.<i>`` gauges of ``num_processes`` workers,
refreshed with the Prometheus textfile every ``prom_refresh_s``.

Process shape (everything host-side except the shared dispatches):

- **listener** (unix socket or localhost TCP) — accepts connections; one
  reader thread per connection parses JSONL requests and runs the
  ADMISSION gate (:func:`pluss_torch.serve.protocol.parse_request` — analyzer
  verdicts, size bounds) *off* the device loop, then submits to the
  bounded :class:`~pluss_torch.serve.admission.AdmissionQueue` (full queue =
  typed ``Overloaded`` shed, never a blocked accept path);
- **device loop** (one thread) — pulls coalesced batches from the
  :class:`~pluss_torch.serve.batcher.Batcher` and executes each batch as ONE
  shared dispatch: spec batches through ``run_resilient`` under the
  process-safe :data:`~pluss_torch.resilience.ladder.SERVE_LADDER` (no
  ``cpu_fallback`` — a rung must degrade the REQUEST, never pin the
  process), trace batches through ``replay_file_resilient`` under the
  equally CPU-pin-free serve trace ladder; results demux per member
  (:meth:`~pluss_torch.engine.SamplerResult.tenant_view`) and each response is
  shaped to its own request's ``output``;
- **SLO publisher** (timer) — p50/p99 latency from a
  :class:`~pluss_torch.obs.telemetry.LatencyReservoir`, queue depth, batch
  occupancy, shed rate as ``serve.*`` gauges/counters, re-exported to
  the Prometheus textfile (``PLUSS_PROM``) every ``prom_refresh_s`` so a
  scraper sees a LIVE daemon, not only its shutdown snapshot.

Failure containment is per REQUEST: an injected fault or real OOM rides
the resilience ladder inside its own batch; other in-flight requests see
nothing (tests/test_torch_serve_server.py pins batched results
bit-identical to solo runs, degraded neighbors included).  Draining
(``shutdown()``, SIGTERM, or a ``{"op": "shutdown"}`` control line) stops
admission, finishes the queue, answers everything, flushes telemetry,
and exits cleanly — with
``drain_timeout_s`` as a HARD bound: past it, everything still queued or
stuck in flight is answered typed retryable and the daemon exits 0.

Fleet hardening rides four more layers:

- **crash-safe request journal** (``--journal-dir`` /
  ``PLUSS_SERVE_JOURNAL``): every accepted non-sleep request is appended
  ``open`` before it can dispatch and marked ``done`` on the first
  reply; a restarted daemon replays the still-open entries through
  normal admission and parks the answers for reconnecting clients
  (``{"op": "result", "id": rid}``), bit-identical to a clean run;
- **hung-dispatch watchdog** (``PLUSS_SERVE_DISPATCH_TIMEOUT_S``): a
  monitor thread abandons a wedged device dispatch to a FRESH device
  loop (generation-tagged; the stale loop exits on its own and its late
  replies lose the per-request claim race), answering the members typed
  retryable;
- **device circuit breaker**
  (:class:`~pluss_torch.resilience.breaker.CircuitBreaker`): classified
  device failures (``ResourceExhausted`` escaping the ladder, a dispatch
  the watchdog abandoned) open it; a kernel that does not build
  (``CompileError``) fails its requests typed and counts nothing; while
  open, spec requests brown out on the
  host CPU device (bit-identical, stamped ``cpu_brownout``, that
  dispatch only) and trace requests shed typed ``Overloaded`` carrying
  the next probe slot as ``retry_after_ms``;
- **per-tenant fairness** (:class:`~pluss_torch.serve.admission`): DRR pops +
  token-bucket rate limits keyed on the request's ``tenant`` field.

Supervisors poll ``{"op": "health"}`` (always answers) and
``{"op": "ready"}`` (ready = warmed AND breaker closed AND queue below
the high-water mark AND not draining).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import queue
import socket
import threading
import time

from pluss_torch import obs
from pluss_torch.obs import tracectx
from pluss_torch.obs.flight import FlightRecorder
from pluss_torch.obs.slo import SloMonitor
from pluss_torch.resilience.breaker import CircuitBreaker
from pluss_torch.resilience.errors import (
    DeadlineExceeded,
    Overloaded,
    ResourceExhausted,
    classify,
)
from pluss_torch.resilience.ladder import SERVE_LADDER, Retry
from pluss_torch.serve.admission import AdmissionQueue
from pluss_torch.serve.batcher import Batcher
from pluss_torch.serve.journal import RequestJournal
from pluss_torch.serve.protocol import (
    Request,
    error_response,
    parse_request,
    result_payload,
)
from pluss_torch.utils.envknob import env_float, env_int

#: trace-replay rung subset for serving: like TRACE_LADDER minus the
#: process-pinning ``cpu_fallback`` (same reasoning as SERVE_LADDER)
SERVE_TRACE_LADDER: tuple[str, ...] = ("serial_feed", "shrink_window")

#: ``{"op": "ready"}`` reports not-ready once the queue passes this
#: fraction of ``max_queue`` — a supervisor should stop routing new
#: traffic here BEFORE requests start shedding, not after
READY_HIGHWATER = 0.8

#: parked recovered-response bound: answers for clients that never
#: reconnect must not accumulate for the daemon's whole life (each holds
#: a full result payload).  Past the cap the OLDEST parked answer is
#: dropped — its client can still re-submit; the journal entry is
#: already complete
_MAX_RECOVERED = 1024


@dataclasses.dataclass
class ServeConfig:
    """Serving knobs (CLI flags mirror these 1:1)."""

    max_queue: int = 128          # admission bound (beyond = shed)
    max_batch: int = 16           # coalesced requests per dispatch
    max_delay_ms: float = 10.0    # adaptive batch window
    default_deadline_ms: float | None = None   # per-request default
    prom_refresh_s: float = 5.0   # SLO gauge + textfile refresh cadence
    #: the JAX package's fleet-health exporter; refused here (it needs the
    #: multi-device layer, ROADMAP Queue 1, item 7)
    heartbeat_dir: str | None = None
    num_processes: int | None = None   # heartbeat worker count
    #: background warmup at daemon start (``--warm``): comma-separated
    #: ``name[:n[:threads[:chunk]]]`` entries, or ``all`` for every
    #: registry model at the default warm size — see :func:`_warm_objs`
    warm: str | None = None
    # -- fleet hardening.  The None-valued knobs resolve through
    # envknob warn-and-default at Server construction, so a fleet can be
    # tuned per-host without new CLI plumbing:
    #: crash-safe request journal directory (``--journal-dir`` /
    #: ``PLUSS_SERVE_JOURNAL``); None disables journaling
    journal_dir: str | None = None
    #: watchdog bound on one device dispatch, seconds
    #: (``PLUSS_SERVE_DISPATCH_TIMEOUT_S``, default 120; 0 disables)
    dispatch_timeout_s: float | None = None
    #: breaker: failures-in-window that open it
    #: (``PLUSS_SERVE_BREAKER_THRESHOLD``, default 5)
    breaker_threshold: int | None = None
    #: breaker failure-counting window, seconds
    #: (``PLUSS_SERVE_BREAKER_WINDOW_S``, default 30)
    breaker_window_s: float | None = None
    #: breaker base open->half-open cooldown, seconds
    #: (``PLUSS_SERVE_BREAKER_COOLDOWN_S``, default 5)
    breaker_cooldown_s: float | None = None
    #: per-tenant token-bucket refill rate, requests/second
    #: (``PLUSS_SERVE_TENANT_RPS``, default 0 = rate limiting off)
    tenant_rps: float | None = None
    #: per-tenant burst (``PLUSS_SERVE_TENANT_BURST``, default 2x rps)
    tenant_burst: float | None = None
    #: concurrent-connection cap (``PLUSS_SERVE_MAX_CONNS``, default
    #: 256); excess connections get one typed Overloaded line and close
    max_conns: int | None = None
    #: per-connection idle timeout, seconds
    #: (``PLUSS_SERVE_CONN_IDLE_S``, default 300; 0 disables)
    conn_idle_s: float | None = None
    #: HARD drain bound (``--drain-timeout-s``): past it, still-pending
    #: requests are answered typed retryable and shutdown completes
    drain_timeout_s: float = 60.0
    # -- observability:
    #: live metrics plane (``--metrics-port``): serve the Prometheus
    #: rendering at ``http://127.0.0.1:<port>/metrics`` from a stdlib
    #: HTTP thread (0 = pick a free port, resolved onto
    #: ``Server.metrics_port``); None disables the endpoint — the
    #: ``{"op": "metrics"}`` verb and PLUSS_PROM textfile remain
    metrics_port: int | None = None
    #: flight-recorder dump directory (``--flight-dir`` /
    #: ``PLUSS_FLIGHT_DIR``, default "."): incident dumps land here as
    #: ``flight-<rid-or-ts>.jsonl``
    flight_dir: str | None = None
    #: the one device every dispatch goes to: None is the CUDA card,
    #: ``"cpu"`` the host (the JAX package's process-wide default device)
    device: object = None


#: ``--warm`` entry defaults (small enough to compile fast, large enough
#: that the compiled shapes match real small-request traffic)
_WARM_N, _WARM_THREADS, _WARM_CHUNK = 16, 4, 4


def _warm_objs(text: str) -> list[dict]:
    """Expand a ``--warm`` value into request objects for
    :func:`~pluss_torch.serve.protocol.parse_request`.

    Going THROUGH the wire parser is the point: warmup must build the
    exact (spec, cfg, share_cap, window) a real request would carry —
    including protocol defaults like ``cache_kb`` that differ from
    :class:`SamplerConfig`'s — or the warmed executables would sit in
    memo slots no live request ever keys into."""
    out = []
    for entry in text.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if entry == "all":
            from pluss_torch.models import REGISTRY

            out.extend({"model": m, "n": _WARM_N, "threads": _WARM_THREADS,
                        "chunk": _WARM_CHUNK, "id": f"warm-{m}"}
                       for m in REGISTRY)
            continue
        if os.path.sep in entry or os.path.exists(entry):
            # a trace path: warm it INTO the residency store so the
            # first real trace request replays resident.  Path detection
            # precedes the colon split — model names never contain a
            # separator, and an existing bare filename is a trace too.
            out.append({"trace": entry,
                        "id": f"warm-trace-{os.path.basename(entry)}"})
            continue
        parts = entry.split(":")
        if len(parts) > 4:
            raise ValueError(
                f"--warm entry {entry!r}: expected name[:n[:threads[:chunk]]]")
        name = parts[0]
        nums = [int(p) for p in parts[1:]]
        n = nums[0] if len(nums) > 0 else _WARM_N
        threads = nums[1] if len(nums) > 1 else _WARM_THREADS
        chunk = nums[2] if len(nums) > 2 else _WARM_CHUNK
        out.append({"model": name, "n": n, "threads": threads,
                    "chunk": chunk, "id": f"warm-{name}-{n}"})
    return out


class Server:
    """One serving process bound to a unix socket path or a TCP port."""

    def __init__(self, socket_path: str | None = None,
                 port: int | None = None, host: str = "127.0.0.1",
                 config: ServeConfig | None = None):
        if (socket_path is None) == (port is None):
            raise ValueError("pass exactly one of socket_path / port")
        self.socket_path = socket_path
        self.host, self.port = host, port
        self.config = c = config or ServeConfig()
        from pluss_torch import engine

        #: the dispatch device: the card unless the config asks for the
        #: CPU; no card and no explicit device raises here
        self.device = engine.resolve_device(c.device)
        # hardening knobs: explicit config wins, else envknob
        # warn-and-default
        self._dispatch_timeout_s = c.dispatch_timeout_s \
            if c.dispatch_timeout_s is not None \
            else env_float("PLUSS_SERVE_DISPATCH_TIMEOUT_S", 120.0,
                           minimum=0.0)
        self._max_conns = c.max_conns if c.max_conns is not None \
            else env_int("PLUSS_SERVE_MAX_CONNS", 256)
        self._conn_idle_s = c.conn_idle_s if c.conn_idle_s is not None \
            else env_float("PLUSS_SERVE_CONN_IDLE_S", 300.0, minimum=0.0)
        tenant_rps = c.tenant_rps if c.tenant_rps is not None \
            else env_float("PLUSS_SERVE_TENANT_RPS", 0.0, minimum=0.0)
        tenant_burst = c.tenant_burst if c.tenant_burst is not None \
            else env_float("PLUSS_SERVE_TENANT_BURST", 0.0, minimum=0.0)
        self.queue = AdmissionQueue(c.max_queue, tenant_rps=tenant_rps,
                                    tenant_burst=tenant_burst or None)
        self.breaker = CircuitBreaker(
            threshold=c.breaker_threshold if c.breaker_threshold is not None
            else env_int("PLUSS_SERVE_BREAKER_THRESHOLD", 5),
            window_s=c.breaker_window_s if c.breaker_window_s is not None
            else env_float("PLUSS_SERVE_BREAKER_WINDOW_S", 30.0,
                           minimum=0.1),
            cooldown_s=c.breaker_cooldown_s
            if c.breaker_cooldown_s is not None
            else env_float("PLUSS_SERVE_BREAKER_COOLDOWN_S", 5.0,
                           minimum=0.05),
            name="serve.breaker")
        journal_dir = c.journal_dir or os.environ.get("PLUSS_SERVE_JOURNAL")
        self._journal = RequestJournal(
            os.path.join(journal_dir, "serve_journal.jsonl")) \
            if journal_dir else None
        self._recovered: dict[str, dict] = {}   # rid -> parked response
        self._recovered_lock = threading.Lock()
        # interference-aware placement: when PLUSS_SERVE_PLACEMENT
        # is on, the batcher's lead pick minimizes the predicted pairwise
        # interference against the previous dispatch — ordering-only, so
        # results stay bit-identical to the advisory-only A/B control
        from pluss_torch.serve.placement import Placer, placement_enabled

        self._placer = Placer() if placement_enabled() else None
        self.batcher = Batcher(self.queue, self.config.max_batch,
                               self.config.max_delay_ms,
                               placer=self._placer)
        self.latency = obs.LatencyReservoir()
        # observability plane: SLO burn monitor over request
        # outcomes, crash flight recorder (armed in start(); creates a
        # memory-only telemetry session when none is configured), and
        # the optional HTTP metrics endpoint
        self.slo = SloMonitor()
        self.flight = FlightRecorder(out_dir=c.flight_dir)
        self.metrics_port: int | None = None
        self._metrics_httpd = None
        self._hb_stop = None
        self._owns_obs_session = False
        self._breaker_was_open = False
        self._listener: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._conns: list[socket.socket] = []
        self._conn_lock = threading.Lock()
        self._stopping = threading.Event()
        self._shutdown_lock = threading.Lock()
        self._shutdown_started = False
        self._drained = threading.Event()
        self._stop_requested = threading.Event()   # control-line shutdown
        # device work handed to the device loop by other threads (the warm
        # thread's trace staging): (fn, future) pairs
        self._loop_jobs: queue.Queue = queue.Queue()
        self._slo_lock = threading.Lock()
        self._responses = 0
        self._last_publish = 0.0
        # batches parked while their plan variant compiles off-thread:
        # batch_key -> (requests, compile-done event).  Touched only from
        # the device loop (park/collect) and _bg_compile (event set).
        self._park_lock = threading.Lock()
        self._parked: dict = {}
        # watchdog state: device loops carry a GENERATION — abandoning a
        # hung dispatch bumps the generation (the stale loop exits at its
        # next top-of-loop check) and spawns a fresh loop.  _inflight is
        # (gen, t0, batch) while a spec/trace dispatch is on the device.
        self._gen_lock = threading.Lock()
        self._dev_gen = 0
        self._inflight_lock = threading.Lock()
        self._inflight: tuple[int, float, list[Request]] | None = None
        # readiness: set immediately when no --warm is configured, else
        # at the end of the warm loop
        self._warm_done = threading.Event()
        # interference advisory: co-tenancy stamps are computed
        # from the static composition once per (dispatch key, co-tenant
        # key set) and cached — pure host math, but not free
        from pluss_torch.utils.envknob import env_choice

        self._interference_on = env_choice(
            "PLUSS_SERVE_INTERFERENCE", "on", ("on", "off")) == "on"
        self._advisory_cache: dict[tuple, dict | None] = {}
        self._advisory_lock = threading.Lock()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        """Bind, start the accept loop, device loop, and SLO publisher."""
        # arm the flight recorder FIRST: its ring must hold the daemon's
        # whole story, serve.start included.  When telemetry was not
        # configured this bootstraps a memory-only session (torn down
        # again in shutdown(), so embedded servers leave the process's
        # global obs state as they found it).
        self._owns_obs_session = not obs.enabled()
        self.flight.arm()
        if self.socket_path is not None:
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass
            ls = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            ls.bind(self.socket_path)
        else:
            ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            ls.bind((self.host, self.port))
            self.port = ls.getsockname()[1]   # resolve port 0
        ls.listen(64)
        self._listener = ls
        obs.event("serve.start",
                  addr=self.socket_path or f"{self.host}:{self.port}",
                  max_queue=self.config.max_queue,
                  max_batch=self.config.max_batch,
                  max_delay_ms=self.config.max_delay_ms,
                  placement=self._placer is not None)
        if self.config.metrics_port is not None:
            self._start_metrics_httpd(self.config.metrics_port)
        for name, target in (("pluss-serve-accept", self._accept_loop),
                             ("pluss-serve-slo", self._slo_loop)):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        self._spawn_device_loop()
        if self._dispatch_timeout_s > 0:
            t = threading.Thread(target=self._watchdog_loop,
                                 name="pluss-serve-watchdog", daemon=True)
            t.start()
            self._threads.append(t)
        if self._journal is not None:
            pending = self._journal.unanswered()
            if pending:
                t = threading.Thread(target=self._recover_loop,
                                     args=(pending,),
                                     name="pluss-serve-recover",
                                     daemon=True)
                t.start()
                self._threads.append(t)
        if self.config.heartbeat_dir:
            from pluss_torch.parallel.multihost import \
                start_heartbeat_exporter

            self._hb_stop = start_heartbeat_exporter(
                self.config.heartbeat_dir, self.config.num_processes or 1,
                interval_s=self.config.prom_refresh_s)
        if self.config.warm:
            t = threading.Thread(target=self._warm_loop,
                                 name="pluss-serve-warm", daemon=True)
            t.start()
            self._threads.append(t)
        else:
            self._warm_done.set()   # nothing to warm: born ready

    def _render_metrics(self) -> str:
        """The live metrics text: the SAME renderer as the PLUSS_PROM
        textfile (:func:`pluss_torch.obs.telemetry.render_prom`), plus the
        latency reservoir's quantiles as a Prometheus summary — a
        scraper and the shutdown textfile can never disagree on
        spelling."""
        from pluss_torch.obs.telemetry import render_prom

        q = {"0.5": self.latency.quantile(0.5),
             "0.9": self.latency.quantile(0.9),
             "0.99": self.latency.quantile(0.99)}
        return render_prom(obs.counters(), obs.gauges(),
                           {"serve.latency_ms": q})

    def _start_metrics_httpd(self, port: int) -> None:
        """The pull half of the metrics plane: a stdlib HTTP server on
        its own thread answering ``GET /metrics`` with the live
        Prometheus rendering.  Loopback-only by design — the daemon
        serves local callers; a fleet scraper rides the node agent."""
        import http.server

        outer = self

        class _MetricsHandler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — stdlib handler API
                if self.path.split("?")[0].rstrip("/") not in ("",
                                                               "/metrics"):
                    self.send_error(404)
                    return
                body = outer._render_metrics().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):   # scrapes are not accesslog
                pass

        httpd = http.server.ThreadingHTTPServer(("127.0.0.1", port),
                                                _MetricsHandler)
        httpd.daemon_threads = True
        self._metrics_httpd = httpd
        self.metrics_port = httpd.server_address[1]   # resolve port 0
        t = threading.Thread(target=httpd.serve_forever,
                             name="pluss-serve-metrics", daemon=True)
        t.start()
        self._threads.append(t)
        obs.event("serve.metrics_endpoint", port=self.metrics_port)

    def _warm_loop(self) -> None:
        """Background warmup: precompile each ``--warm`` entry's plan
        variants so the first real request dispatches warm.  Runs OFF the
        device loop (the daemon serves while warming); the single-flight
        registry dedupes against any request that races a warm entry.
        Failures are counted + evented, never fatal — a bad entry leaves
        that model cold, nothing else."""
        try:
            self._warm_loop_inner()
        finally:
            # ready-gating only: a failed warmup still ends the warming
            # phase (the failures are counted + evented), it does not
            # wedge ``{"op": "ready"}`` at not-ready forever
            self._warm_done.set()

    def _warm_loop_inner(self) -> None:
        import sys

        from pluss_torch import autotune, engine

        # announce the persisted autotuned geometry — trace warms
        # below resolve their window through it, so the residency entry
        # and first real requests share one compiled plan
        geo = autotune.tuned_geometry(self.device)
        if geo:
            obs.event("serve.warm_geometry", **geo)
            print("pluss_torch serve: warming with autotuned geometry "
                  + " ".join(f"{k}={geo[k]}" for k in sorted(geo)),
                  file=sys.stderr)
        warmed = 0
        try:
            objs = _warm_objs(self.config.warm)
        except Exception as e:  # noqa: BLE001 — malformed --warm value
            obs.counter_add("serve.warm_fail")
            obs.event("serve.warm_error", entry=self.config.warm,
                      error=str(e))
            return
        for obj in objs:
            if self._stopping.is_set():
                return
            try:
                req = parse_request(obj)
                if req.kind == "trace":
                    from pluss_torch import trace as trace_mod

                    with obs.span("serve.warm", trace=req.trace):
                        # _resolve_window consults the autotuned
                        # geometry before the TRACE_WINDOW default (the
                        # JAX package's rule, kept: _execute_trace
                        # replays under TRACE_WINDOW, so a tuned window
                        # other than that misses this entry).  Staging
                        # is device work: the device loop runs it
                        window = req.window \
                            or trace_mod._resolve_window(None, self.device)
                        self._on_device_loop(
                            lambda: trace_mod.ensure_resident(
                                req.trace, cls=req.cfg.cls, window=window,
                                device=self.device))
                else:
                    with obs.span("serve.warm", model=obj.get("model")):
                        engine.precompile(req.spec, req.cfg,
                                          window_accesses=req.window,
                                          device=self.device)
                        if self.device.type == "cuda":
                            # the port's kernels are built, not compiled
                            # per shape as JAX's are: what a first run on
                            # the card still pays (kernel modules loaded,
                            # the allocator grown) is paid here, once, on
                            # the device loop
                            self._on_device_loop(
                                lambda: engine.warm_run(
                                    req.spec, req.cfg,
                                    window_accesses=req.window,
                                    device=self.device))
                warmed += 1
                obs.counter_add("serve.warmed")
            except Exception as e:  # noqa: BLE001 — entry-local failure
                obs.counter_add("serve.warm_fail")
                obs.event("serve.warm_error", entry=repr(obj),
                          error=f"{type(e).__name__}: {e}")
        obs.event("serve.warm_done", warmed=warmed)

    def _on_device_loop(self, fn):
        """Run ``fn`` on the device loop's thread and return its value
        (or raise its error): device work asked for by another thread.
        Gives up with a classified error when the daemon stops first."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._loop_jobs.put((fn, fut))
        while True:
            try:
                return fut.result(timeout=0.25)
            except concurrent.futures.TimeoutError:
                if self._stopping.is_set() and fut.cancel():
                    raise Overloaded("server stopping; device work not run",
                                     site="serve.device_loop")

    def _run_loop_jobs(self) -> None:
        while True:
            try:
                fn, fut = self._loop_jobs.get_nowait()
            except queue.Empty:
                return
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 — handed back
                fut.set_exception(e)

    def _recover_loop(self, pending: list[dict]) -> None:
        """Replay journaled-unanswered requests through NORMAL admission.

        Each recovered request's reply PARKS its response keyed by rid —
        a reconnecting client collects it with
        ``{"op": "result", "id": rid}`` — and the first claimed reply
        marks the journal entry done, exactly like a live request.
        Entries whose wall-clock deadline died with the old process are
        answered typed ``DeadlineExceeded`` without touching the device
        (the no-re-execution premise: never burn capacity on an answer
        nobody can still be waiting for)."""
        obs.event("serve.recover_start", entries=len(pending))
        for rec in pending:
            if self._stopping.is_set():
                return
            rid = rec.get("rid")
            dle = rec.get("deadline_epoch")

            def park(doc: dict, rid=rid) -> None:
                with self._recovered_lock:
                    self._recovered[rid] = doc
                    while len(self._recovered) > _MAX_RECOVERED:
                        # dicts iterate in insertion order: evict oldest
                        oldest = next(iter(self._recovered))
                        del self._recovered[oldest]
                        obs.counter_add("serve.journal.recovered_evicted")
                obs.counter_add("serve.journal.recovered")

            if dle is not None and time.time() >= dle:
                obs.counter_add("serve.deadline_exceeded")
                obs.counter_add("serve.journal.expired")
                self._journal.complete(rid)
                park(error_response(rid, DeadlineExceeded(
                    "deadline passed before the daemon was restarted",
                    site="serve.recover")))
                continue
            try:
                req = parse_request(rec.get("obj"),
                                    self.config.default_deadline_ms)
                if dle is not None:
                    # rebase the surviving wall-clock budget onto this
                    # process's monotonic clock
                    req.deadline = time.monotonic() + (dle - time.time())
                req.reply = park
                req.journaled = True   # already `open` in the journal
                self.queue.submit(req)
            except Exception as e:  # noqa: BLE001 — typed park, no escape
                self._journal.complete(rid)
                park(error_response(rid, classify(e, site="serve.recover")))

    @property
    def address(self) -> str:
        return self.socket_path or f"{self.host}:{self.port}"

    def serve_forever(self) -> None:
        """Block until a signal or a shutdown control line, then drain.
        Starts the server if :meth:`start` was not called already.  Call
        only from the main thread (signal handlers)."""
        import signal

        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: self._stop_requested.set())
        if self._listener is None:
            self.start()
        self._stop_requested.wait()
        self.shutdown()

    def shutdown(self, drain_timeout_s: float | None = None) -> None:
        """Drain-and-stop: close admission, finish every queued request,
        answer everything, flush telemetry.  Idempotent.

        ``drain_timeout_s`` (default: the config's) is a HARD bound: a
        drain that cannot finish — a dispatch wedged in a kernel, a plan
        that never returns — answers everything still queued, parked, or
        in flight with a typed retryable error and completes anyway.
        Exit 0, not a hang: the supervisor restarting us (with
        ``--recover``) is the path that actually serves those clients."""
        if drain_timeout_s is None:
            drain_timeout_s = self.config.drain_timeout_s
        with self._shutdown_lock:   # atomic test-and-set: the control-
            # line path and serve_forever's signal path can race here
            already = self._shutdown_started
            self._shutdown_started = True
        if already:
            self._drained.wait(drain_timeout_s)
            return
        # order matters: close ADMISSION first, then flag the stop.  The
        # device loop exits on (stopping AND queue empty); with the queue
        # closed first, a submit racing this window sheds typed instead
        # of landing in a queue nobody will ever drain.
        self.queue.close()
        self._stopping.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        if not self._threads:   # never started: nothing will drain
            self._drained.set()
        if not self._drained.wait(drain_timeout_s):
            self._force_drain()
        if self._hb_stop is not None:
            self._hb_stop()
        if self._metrics_httpd is not None:
            try:
                self._metrics_httpd.shutdown()
            except Exception:  # noqa: BLE001 — endpoint teardown is best-effort
                pass
        self._publish_slo(force=True)
        obs.event("serve.stop", responses=self._responses)
        obs.flush_metrics()
        # release the flight recorder's tap, and when the session was a
        # memory-only bootstrap of OUR making (no --telemetry, no env),
        # tear it down too: an embedded server must not leave a global
        # telemetry session accumulating counters across its process
        flight_tel = self.flight._tel
        self.flight.disarm()
        from pluss_torch.obs import telemetry as _telemetry

        if self._owns_obs_session and _telemetry.active() is flight_tel:
            _telemetry.shutdown()
        with self._conn_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        if self.socket_path is not None:
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass

    def _force_drain(self) -> None:
        """The drain hard bound fired: answer everything still queued,
        parked, or wedged in flight with a typed retryable error and
        declare the drain done.  The per-request claim guard makes this
        safe against the stuck dispatch eventually completing — whoever
        claims first answers, the other goes silent."""
        obs.counter_add("serve.drain_forced")
        obs.event("serve.drain_forced", queue_depth=len(self.queue))
        self.flight.dump("drain_forced")
        err = Overloaded(
            "server shut down before this request was served; retry",
            site="serve.drain", retry_after_ms=1000)
        while True:   # still-queued requests (the queue is closed)
            req, expired = self.queue.pop(timeout=0)
            for r in expired:
                self._respond_deadline(r)
            if req is None:
                break
            self._respond_err(req.reply, req.id, err, req=req)
        with self._park_lock:   # batches parked behind a compile
            parked = list(self._parked.values())
            self._parked.clear()
        for reqs, _done in parked:
            for r in reqs:
                self._respond_err(r.reply, r.id, err, req=r)
        with self._inflight_lock:   # the stuck in-flight batch itself
            inflight, self._inflight = self._inflight, None
        if inflight is not None:
            for r in inflight[2]:
                self._respond_err(r.reply, r.id, err, req=r)
        self._drained.set()

    # -- listener / connections ---------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                if self._stopping.is_set():
                    return   # listener closed by shutdown
                # transient accept failure (EMFILE under connection
                # pressure, interrupted call): a daemon must keep
                # accepting, not silently stop serving new connections
                obs.counter_add("serve.accept_errors")
                time.sleep(0.05)
                continue
            with self._conn_lock:
                n_conns = len(self._conns)
            if self._max_conns and n_conns >= self._max_conns:
                # typed shed AT ACCEPT: one Overloaded line, then close —
                # a reader thread per unbounded connection is exactly the
                # resource a connection flood exhausts
                obs.counter_add("serve.conn_shed")
                try:
                    conn.sendall(json.dumps(error_response(
                        None, Overloaded(
                            f"connection limit reached "
                            f"({self._max_conns}); back off and retry",
                            site="serve.accept", retry_after_ms=100)))
                        .encode() + b"\n")
                except OSError:
                    pass
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            if self._conn_idle_s > 0:
                # slowloris guard: a connection idle past the bound gets
                # its reader thread reclaimed (see _conn_loop)
                conn.settimeout(self._conn_idle_s)
            with self._conn_lock:
                self._conns.append(conn)
            t = threading.Thread(target=self._conn_loop, args=(conn,),
                                 name="pluss-serve-conn", daemon=True)
            t.start()

    def _conn_loop(self, conn: socket.socket) -> None:
        wlock = threading.Lock()

        def reply(doc: dict) -> None:
            data = json.dumps(doc).encode() + b"\n"
            try:
                with wlock:
                    conn.sendall(data)
            except OSError:
                obs.counter_add("serve.client_gone")

        try:
            rfile = conn.makefile("rb")
            for line in rfile:
                if not line.strip():
                    continue
                self._handle_line(line, reply)
        except TimeoutError:
            # socket.timeout subclasses OSError, so it MUST be caught
            # before the bare-OSError fallthrough or idle closes would
            # be silently indistinguishable from client disconnects
            obs.counter_add("serve.conn_idle_closed")
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._conn_lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def _handle_line(self, line: bytes, reply) -> None:
        try:
            obj = json.loads(line)
        except ValueError as e:
            from pluss_torch.resilience.errors import InvalidRequest

            obs.counter_add("serve.requests")
            obs.counter_add("serve.admission_rejects")
            self._respond_err(reply, None, InvalidRequest(
                f"unparseable request line: {e}", site="serve.parse"))
            return
        op = obj.get("op") if isinstance(obj, dict) else None
        if op is not None:   # control lines are not requests (no SLO)
            self._handle_control(op, obj, reply)
            return
        obs.counter_add("serve.requests")
        # bind the request's trace context for the whole admission leg:
        # the analyzer verdict inside parse_request, the journal append,
        # and the submit/shed outcome all land stamped trace=<rid>
        rid = obj.get("id") if isinstance(obj, dict) else None
        with tracectx.bind(None if rid is None else str(rid)):
            try:
                req = parse_request(obj, self.config.default_deadline_ms)
            except Exception as e:  # noqa: BLE001 — typed response, no escape
                obs.counter_add("serve.admission_rejects")
                obs.trace_event("serve.reject", error=type(e).__name__)
                self._respond_err(reply, rid if rid is None else str(rid),
                                  classify(e, site="serve.parse"))
                return
        # counted by ORIGIN (spec/trace/sleep/source): a source-derived
        # request executes as kind "spec", but the SLO breakdown should
        # show the ingestion surface it arrived through
        obs.counter_add(f"serve.requests.{req.origin or req.kind}")
        req.reply = reply
        # re-bind under the PARSED id: anonymous requests are assigned
        # one in parse_request, and that is the id the client echoes
        with tracectx.bind(req.id):
            self._journal_append(req, obj)
            try:
                self.queue.submit(req)
                obs.trace_event("serve.admit", kind=req.kind,
                                tenant=req.tenant or "")
            except Exception as e:  # noqa: BLE001 — Overloaded et al, typed
                obs.trace_event("serve.shed", error=type(e).__name__)
                self._respond_err(reply, req.id, classify(
                    e, site="serve.admission"), req=req)

    def _journal_append(self, req: Request, obj: dict) -> None:
        """Journal an admitted request BEFORE it queues: the record must
        exist before any crash that could lose the in-memory queue.
        Sleeps are never journaled (a synthetic hold is not work a
        restarted daemon owes anybody)."""
        if self._journal is None or req.kind == "sleep":
            return
        rem = req.remaining_s()
        try:
            # wall-clock deadline: monotonic instants do not survive a
            # restart, but "N seconds from admission" does
            self._journal.append(
                req.id, {**obj, "id": req.id}, tenant=req.tenant,
                deadline_epoch=time.time() + rem if rem is not None
                else None)
            req.journaled = True
        except OSError:
            # a full/broken journal disk must not take serving down with
            # it — the request just loses crash coverage
            obs.counter_add("serve.journal.append_fail")

    def _handle_control(self, op: str, obj: dict, reply) -> None:
        if op == "ping":
            reply({"id": obj.get("id"), "ok": True, "op": "ping"})
        elif op == "stats":
            from pluss_torch import engine

            reply({"id": obj.get("id"), "ok": True, "op": "stats",
                   "counters": obs.counters(), "gauges": obs.gauges(),
                   "queue_depth": len(self.queue),
                   # zero-recompute witness of a journal recovery:
                   # completed journal entries must not move this
                   "device_dispatches": int(engine.DEVICE_DISPATCHES)})
        elif op == "health":
            with self._conn_lock:
                n_conns = len(self._conns)
            fast, slow = self.slo.burn_rates()
            reply({"id": obj.get("id"), "ok": True, "op": "health",
                   "breaker": self.breaker.state,
                   "queue_depth": len(self.queue),
                   "conns": n_conns,
                   "warmed": self._warm_done.is_set(),
                   "draining": self._stopping.is_set(),
                   "slo_burn_fast": round(fast, 4),
                   "slo_burn_slow": round(slow, 4)})
        elif op == "metrics":
            # the push half of the metrics plane: same rendering as the
            # HTTP endpoint, over the protocol socket — a client that can
            # submit requests can scrape without a second port
            reply({"id": obj.get("id"), "ok": True, "op": "metrics",
                   "text": self._render_metrics()})
        elif op == "ready":
            reasons = self._not_ready_reasons()
            reply({"id": obj.get("id"), "ok": True, "op": "ready",
                   "ready": not reasons, "reasons": reasons})
        elif op == "result":
            # reconnect surface for recovered requests: a client that
            # crashed with the daemon re-asks by rid instead of re-paying
            rid = obj.get("id")
            rid = None if rid is None else str(rid)
            with self._recovered_lock:
                doc = self._recovered.pop(rid, None)
            if doc is not None:
                reply(doc)
            else:
                reply({"id": rid, "ok": False, "op": "result",
                       "pending": bool(self._journal is not None and rid
                                       and self._journal.is_open(rid))})
        elif op == "shutdown":
            # ack first, THEN signal: the drain closes this connection
            reply({"id": obj.get("id"), "ok": True, "op": "shutdown",
                   "draining": True})
            self._stop_requested.set()
            # in-process embeddings (tests) have no serve_forever waiting
            # on the event; shut down from a helper thread (never from
            # this conn thread: shutdown joins the drain that must still
            # answer other connections)
            threading.Thread(target=self.shutdown, daemon=True,
                             name="pluss-serve-shutdown").start()
        else:
            from pluss_torch.resilience.errors import InvalidRequest

            reply(error_response(obj.get("id"), InvalidRequest(
                f"unknown op {op!r}", site="serve.parse")))

    def _not_ready_reasons(self) -> list[str]:
        """Why a load balancer should NOT route here right now.  Empty
        means ready: warmed, breaker closed, queue below high-water, not
        draining."""
        reasons: list[str] = []
        if not self._warm_done.is_set():
            reasons.append("warmup in progress")
        state = self.breaker.state
        if state != "closed":
            reasons.append(f"breaker {state}")
        highwater = max(1, int(self.config.max_queue * READY_HIGHWATER))
        depth = len(self.queue)
        if depth >= highwater:
            reasons.append(
                f"queue depth {depth} >= high-water {highwater}")
        if self.slo.burning_fast():
            reasons.append(
                f"slo burning fast (burn {self.slo.burn(self.slo.fast_s):.1f}"
                f" >= {self.slo.burn_fast:g} over {self.slo.fast_s:g}s)")
        if self._stopping.is_set():
            reasons.append("draining")
        return reasons

    # -- device loop --------------------------------------------------------

    def _spawn_device_loop(self) -> None:
        """Start a fresh device loop under a NEW generation.  Bumping the
        generation first stales any previous loop: a hung dispatch that
        eventually returns finds ``gen != self._dev_gen`` and exits
        instead of racing the replacement for the queue."""
        with self._gen_lock:
            self._dev_gen += 1
            gen = self._dev_gen
        t = threading.Thread(target=self._device_loop, args=(gen,),
                             name=f"pluss-serve-device-{gen}", daemon=True)
        t.start()
        self._threads.append(t)

    def _device_loop(self, gen: int) -> None:
        while True:
            if gen != self._dev_gen:
                return   # abandoned by the watchdog: a fresh loop owns the queue
            self._run_loop_jobs()
            self._run_ready_parked(gen=gen)
            batch, expired = self.batcher.next_batch(timeout=0.25)
            for req in expired:
                self._respond_deadline(req)
            if not batch:
                if self._stopping.is_set() and len(self.queue) == 0:
                    if self._parked:
                        # drain must answer parked members too: wait out
                        # their compiles and execute before declaring done
                        self._run_ready_parked(wait=True, gen=gen)
                        continue
                    self._drained.set()
                    return
                continue
            if self._maybe_park(batch):
                continue
            self._execute(batch, gen)

    def _maybe_park(self, batch: list[Request]) -> bool:
        """Keep the device loop draining while a cold key compiles.

        A spec batch whose plan variants are not yet warm — and with
        OTHER keys waiting in the queue — parks behind an off-thread
        ``engine.precompile`` instead of pinning the device loop on an
        inline compile; the loop keeps serving warm keys meanwhile.  A
        later batch for the same key joins the parked members (the
        single dispatch answers all).  With nothing else to do, or
        during drain, the batch compiles inline as before."""
        lead = batch[0]
        if lead.kind != "spec" or self._stopping.is_set():
            return False
        key = lead.batch_key()
        with self._park_lock:
            parked = self._parked.get(key)
            if parked is not None:
                parked[0].extend(batch)
                obs.counter_add("serve.compile_parked", len(batch))
                return True
        from pluss_torch import engine

        if engine.is_warm(lead.spec, lead.cfg,
                          window_accesses=lead.window):
            return False
        if not self.queue.has_other_work(key):
            return False   # the loop would idle anyway: compile inline
        done = threading.Event()
        with self._park_lock:
            self._parked[key] = (list(batch), done)
        obs.counter_add("serve.compile_parked", len(batch))
        threading.Thread(target=self._bg_compile, args=(lead, done),
                         name="pluss-serve-compile", daemon=True).start()
        return True

    def _bg_compile(self, lead: Request, done: threading.Event) -> None:
        from pluss_torch import engine

        # the compile worker runs on its own thread (host planning and
        # kernel builds only): attach the lead's trace context so the
        # engine.plan/precompile spans it records resolve to the request
        # that parked behind them
        try:
            with tracectx.attach(lead.id), \
                    obs.span("serve.compile_bg"):
                engine.precompile(lead.spec, lead.cfg,
                                  window_accesses=lead.window,
                                  device=self.device)
        except Exception:  # noqa: BLE001 — the real dispatch will surface
            # a typed per-request error through the ladder; the parked
            # batch must still execute, so a compile failure only counts
            obs.counter_add("serve.compile_bg_fail")
        finally:
            done.set()

    def _run_ready_parked(self, wait: bool = False,
                          gen: int | None = None) -> None:
        with self._park_lock:
            items = list(self._parked.items())
        for key, (reqs, done) in items:
            if wait:
                done.wait()
            elif not done.is_set():
                continue
            with self._park_lock:
                self._parked.pop(key, None)
            self._execute(reqs, gen)

    # -- watchdog -----------------------------------------------------------

    def _set_inflight(self, gen: int | None, batch: list[Request]) -> None:
        if gen is None:
            return
        with self._inflight_lock:
            self._inflight = (gen, time.monotonic(), batch)

    def _clear_inflight(self, gen: int | None) -> None:
        if gen is None:
            return
        with self._inflight_lock:
            if self._inflight is not None and self._inflight[0] == gen:
                self._inflight = None

    def _watchdog_loop(self) -> None:
        """Bound every device dispatch by ``_dispatch_timeout_s``: a hung
        dispatch (wedged compile, dead device, injected ``hang`` fault)
        is abandoned — its batch answered typed-retryable, its loop
        staled, a fresh loop spawned — instead of wedging serving until
        an operator notices."""
        timeout = self._dispatch_timeout_s
        poll = max(0.02, min(0.25, timeout / 4.0))
        while not self._stopping.wait(poll):
            with self._inflight_lock:
                inf = self._inflight
            if inf is None:
                continue
            gen, t0, batch = inf
            age = time.monotonic() - t0
            if age >= timeout:
                self._abandon(gen, batch, age)

    def _abandon(self, gen: int, batch: list[Request], age: float) -> None:
        with self._inflight_lock:
            if self._inflight is None or self._inflight[0] != gen:
                return   # the dispatch finished while we decided
            self._inflight = None
        # stale the hung loop BEFORE answering or respawning: if its
        # dispatch ever returns, the generation check makes it exit
        # without popping another batch
        with self._gen_lock:
            if self._dev_gen == gen:
                self._dev_gen += 1
        obs.counter_add("serve.watchdog.abandoned")
        obs.counter_add("serve.watchdog.abandoned_requests", len(batch))
        with tracectx.bind(batch[0].id if batch else None):
            obs.event("serve.watchdog_abandon", age_s=round(age, 3),
                      batch=len(batch))
        # the post-mortem moment: the hung dispatch's whole run-up is
        # still in the ring
        self.flight.dump("watchdog_abandon",
                         rid=batch[0].id if batch else None)
        # a hang is evidence against the device, same as a classified
        # dispatch failure
        self.breaker.record_failure()
        self._note_breaker()
        err = Overloaded(
            f"dispatch abandoned by the watchdog after {age:.1f}s; retry",
            site="serve.watchdog", retry_after_ms=1000)
        for req in batch:
            self._respond_err(req.reply, req.id, err, req=req)
        self._spawn_device_loop()

    def _note_breaker(self) -> None:
        """Flight-dump the OPEN transition (once per open, throttled by
        the recorder): the failures that tripped the breaker are the
        post-mortem, and they are still in the ring right now."""
        is_open = self.breaker.state == "open"
        if is_open and not self._breaker_was_open:
            self.flight.dump("breaker_open")
        self._breaker_was_open = is_open

    # -- dispatch -----------------------------------------------------------

    def _execute(self, batch: list[Request],
                 gen: int | None = None) -> None:
        # members can expire between batching and dispatch
        now = time.monotonic()
        live = []
        for req in batch:
            if req.expired():
                self._respond_deadline(req)
            else:
                live.append(req)
                # per-member queue-wait attribution: admission instant to
                # dispatch pop, stamped with the member's own trace id
                with tracectx.bind(req.id):
                    obs.trace_event(
                        "serve.queue_wait",
                        ms=round((now - req.t_admit) * 1e3, 3))
        if not live:
            return
        lead = live[0]
        brownout = False
        # the batch span runs under the LEAD's context and links every
        # member by id: `stats --trace <rid>` finds this one span
        # for any member rid via its `traces` attribute
        with tracectx.bind(lead.id), \
                obs.span("serve.batch", kind=lead.kind, size=len(live),
                         traces=[r.id for r in live]):
            try:
                if lead.kind == "sleep":
                    time.sleep(lead.sleep_ms / 1e3)
                    self._respond_ok(lead, {"slept_ms": lead.sleep_ms},
                                     len(live))
                    return
                if not self.breaker.allow():
                    # the brown-out dispatch rides the SAME watchdog
                    # window as a device dispatch: a wedged CPU compile
                    # or injected hang must be abandoned, not wedge the
                    # loop with the breaker open
                    brownout = True
                    self._set_inflight(gen, live)
                    try:
                        self._brownout(live)
                    finally:
                        self._clear_inflight(gen)
                    return
                self._set_inflight(gen, live)
                try:
                    from pluss_torch.resilience import faults

                    faults.check("serve.dispatch")
                    # success is recorded via on_success BEFORE replies
                    # fan out: a client reading {"op": "health"} right
                    # after its probe answer must see the closed state
                    if lead.kind == "spec":
                        self._execute_spec(
                            live, on_success=self.breaker.record_success)
                    else:
                        self._execute_trace(
                            live, on_success=self.breaker.record_success)
                finally:
                    self._clear_inflight(gen)
                    # allow() may have granted this dispatch the half-
                    # open probe; if it ended without record_success /
                    # record_failure (deadline, client error, every
                    # member claimed), free the slot — a leaked probe
                    # wedges the breaker half-open forever
                    self.breaker.release_probe()
            except BaseException as e:  # noqa: BLE001 — typed fan-out
                if isinstance(e, (KeyboardInterrupt, SystemExit)):
                    raise
                err = classify(e, site=f"serve.{lead.kind}")
                # an exception escaping the ladder IS the incident the
                # flight recorder exists for: dump the ring while the
                # records leading here are still in it
                self.flight.dump("dispatch_error", rid=lead.id)
                if not brownout and isinstance(err, ResourceExhausted):
                    # only DEVICE evidence feeds the breaker: client
                    # errors and deadlines say nothing about the device,
                    # and a kernel that does not build (CompileError) is
                    # answered typed, never turned into a CPU brown-out
                    self.breaker.record_failure()
                    self._note_breaker()
                if isinstance(err, DeadlineExceeded):
                    # a deadline blown INSIDE the ladder must land in the
                    # same SLO counter as the queue/demux expiry paths
                    obs.counter_add("serve.deadline_exceeded", len(live))
                for req in live:
                    self._respond_err(req.reply, req.id, err, req=req)

    def _brownout(self, live: list[Request]) -> None:
        """Open-breaker service: spec batches run the CPU brown-out rung
        (slower, stamped ``cpu_brownout``, bit-identical — the engine is
        deterministic across backends); trace replays are shed typed
        (their value IS device-rate replay; a CPU replay would occupy the
        loop for longer than any client deadline)."""
        lead = live[0]
        retry_ms = int(self.breaker.retry_after_s() * 1e3) + 1
        if lead.kind != "spec":
            obs.counter_add("serve.breaker.shed", len(live))
            err = Overloaded(
                "device circuit breaker open; trace replay shed",
                site="serve.breaker", retry_after_ms=retry_ms)
            for req in live:
                self._respond_err(req.reply, req.id, err, req=req)
            return
        obs.counter_add("serve.breaker.brownout", len(live))
        # the one dispatch that leaves ServeConfig.device: this call only,
        # stamped, and reached only through an open breaker
        self._execute_spec(live, device="cpu", stamp=("cpu_brownout",))

    @staticmethod
    def _batch_deadline_s(batch: list[Request]) -> float | None:
        """Ladder churn budget of one dispatch: the LONGEST remaining
        member deadline (a retry that can still save one member is worth
        taking; members it cannot save fail their own deadline check at
        demux)."""
        rems = [r.remaining_s() for r in batch]
        if any(r is None for r in rems):
            return None
        return max(rems)

    def _execute_spec(self, batch: list[Request], device=None,
                      stamp: tuple[str, ...] = (),
                      on_success=None) -> None:
        from pluss_torch import cri
        from pluss_torch.resilience.ladder import run_resilient

        # members the watchdog or a forced drain already answered must
        # not burn a dispatch: an abandoned thread waking from a wedged
        # hang would otherwise run the engine for nobody — and eat a
        # fault plan or a breaker budget some LIVE request owns
        batch = [r for r in batch if not r.is_claimed()]
        if not batch:
            return
        lead = batch[0]
        # the device is an argument of this dispatch alone: a brown-out
        # passes the CPU, every other dispatch the daemon's device
        res = run_resilient(
            lead.spec, lead.cfg,
            device=self.device if device is None else device,
            window_accesses=lead.window, rungs=SERVE_LADDER,
            retry=Retry(backoff_s=0.01),
            deadline_s=self._batch_deadline_s(batch))
        if stamp:
            res.degradations = tuple(res.degradations) + tuple(stamp)
        if on_success is not None:
            on_success()
        advisory = self._interference_advisory(lead)
        k = len(batch)
        for req in batch:
            # re-bind per member: the demux span and the response land
            # under the MEMBER's trace id, not the batch lead's
            with tracectx.bind(req.id):
                if req.expired():
                    self._respond_deadline(req)
                    continue
                # demux: each tenant gets an independently-owned result
                # view, then its own CRI pass + shaping (deterministic on
                # equal inputs, so coalesced responses stay bit-identical
                # to solo)
                with obs.span("serve.demux"):
                    view = res.tenant_view()
                    ri = cri.distribute(view.noshare_list(),
                                        view.share_list(),
                                        req.cfg.thread_num)
                    payload = result_payload(req, ri, req.cfg)
                payload["model"] = req.spec.name
                payload["refs"] = int(view.max_iteration_count)
                if view.degradations:
                    payload["degradations"] = list(view.degradations)
                if advisory is not None:
                    # ADDITIVE stamp: the result fields above are
                    # untouched, so coalesced responses stay bit-identical
                    # to solo runs
                    payload["interference"] = advisory
                self._respond_ok(req, payload, k)

    def _interference_advisory(self, lead: Request) -> dict | None:
        """Co-tenancy advisory for a spec dispatch: when OTHER
        workloads are queued behind this dispatch, the static cross-nest
        composition (:mod:`pluss_torch.analysis.interference`) prices this
        workload's miss-ratio inflation under co-scheduling and stamps a
        typed verdict (PL801 severe / PL802 benign / PL803 outside the
        composition contract) onto the response.  Advisory only: it never
        reorders, sheds, or alters results — and never fails a dispatch
        (any internal error degrades to no stamp, counted)."""
        if not self._interference_on or lead.spec is None:
            return None
        try:
            key = lead.batch_key()
            co = self.queue.co_tenant_specs(key)
            if not co:
                return None
            cache_key = (key, tuple(sorted(k for k, _, _ in co)))
            with self._advisory_lock:
                if cache_key in self._advisory_cache:
                    adv = self._advisory_cache[cache_key]
                else:
                    adv = self._compute_advisory(lead, co)
                    if len(self._advisory_cache) >= 256:
                        # bounded memo: arbitrary co-tenant key sets must
                        # not grow this for the daemon's whole life
                        self._advisory_cache.clear()
                    self._advisory_cache[cache_key] = adv
            if adv is not None:
                obs.counter_add("serve.interference.advisories")
                if adv["code"] == "PL801":
                    obs.counter_add("serve.interference.severe")
                obs.gauge_set("serve.interference.last_inflation",
                              float(adv.get("inflation", 0.0)))
            return adv
        except Exception:  # noqa: BLE001 — advisory must never fail serving
            obs.counter_add("serve.interference.errors")
            return None

    @staticmethod
    def _compute_advisory(lead: Request, co: list[tuple]) -> dict | None:
        from pluss_torch.analysis import interference as itf
        from pluss_torch.analysis import ri as ri_mod

        co_names = sorted({spec.name for _, spec, _ in co})
        inputs: list[itf.WorkloadInput] = []
        for spec, cfg in [(lead.spec, lead.cfg)] + [(s, c)
                                                    for _, s, c in co]:
            pred = ri_mod.derive(spec, cfg)
            if not pred.derivable or pred.accesses <= 0:
                if spec is lead.spec:
                    # the advisory is ABOUT the lead: underivable lead
                    # means the pair is outside the composition contract
                    return {"code": "PL803", "co_tenants": co_names,
                            "detail": "workload outside the composition "
                                      "model's contract"}
                continue
            inputs.append(itf.WorkloadInput(
                spec.name, pred.noshare, pred.share, cfg,
                float(pred.accesses), int(pred.accesses), spec=spec))
        if len(inputs) < 2:
            return {"code": "PL803", "co_tenants": co_names,
                    "detail": "co-tenants outside the composition "
                              "model's contract"}
        rep = itf.compose(inputs, lead.cfg)
        v = rep.verdicts[0]   # the lead workload's verdict
        return {"code": v.code, "co_tenants": co_names,
                "inflation": round(v.inflation, 9),
                "solo_miss_ratio": round(v.solo_mr, 9),
                "degraded_miss_ratio": round(v.degraded_mr, 9),
                "threshold": rep.threshold,
                "cache_kb": rep.cache_kb}

    def _execute_trace(self, batch: list[Request],
                       on_success=None) -> None:
        from pluss_torch import residency
        from pluss_torch import trace as trace_mod
        from pluss_torch.resilience.ladder import replay_file_resilient

        batch = [r for r in batch if not r.is_claimed()]
        if not batch:
            return
        lead = batch[0]
        # Ride the residency store: a repeat trace replays from device
        # memory with zero feed bytes.  Admission priced the staging
        # (hbm_bytes) — an entry the budget can never fit skips the store up front
        # instead of paying a doomed stage-through; a transient miss
        # inside still degrades to the streamed path through the ladder.
        resident = 0 < lead.hbm_bytes <= residency.store().budget()
        rep = replay_file_resilient(
            lead.trace, lead.fmt, cls=lead.cfg.cls,
            window=lead.window or trace_mod.TRACE_WINDOW,
            resident_cache=resident,
            rungs=SERVE_TRACE_LADDER, retry=Retry(backoff_s=0.01),
            device=self.device)
        if on_success is not None:
            on_success()
        k = len(batch)
        for req in batch:
            with tracectx.bind(req.id):
                if req.expired():
                    self._respond_deadline(req)
                    continue
                with obs.span("serve.demux"):
                    payload = result_payload(req, rep.histogram(),
                                             req.cfg)
                payload["trace"] = req.trace
                payload["refs"] = int(rep.total_count)
                payload["n_lines"] = int(rep.n_lines)
                if rep.degradations:
                    payload["degradations"] = list(rep.degradations)
                self._respond_ok(req, payload, k)

    # -- responses / SLO ----------------------------------------------------

    def _finish(self, req_or_none, ms: float | None) -> None:
        with self._slo_lock:
            self._responses += 1
            n = self._responses
        if ms is not None:
            self.latency.add(ms)
        if n % 32 == 0:
            self._publish_slo()

    def _claimed(self, req: Request) -> bool:
        """Claim the ONE answer a request gets.  False means somebody
        (the watchdog, a forced drain, a racing demux path) answered
        first — the caller must not reply again.  The first claim also
        marks the journal entry done: from here a crash owes the client
        nothing."""
        if not req.claim():
            return False
        if self._journal is not None and req.journaled:
            self._journal.complete(req.id)
        return True

    def _respond_ok(self, req: Request, payload: dict, k: int) -> None:
        if not self._claimed(req):
            return
        ms = (time.monotonic() - req.t_admit) * 1e3
        doc = {"id": req.id, "ok": True, **payload,
               "batched": k, "latency_ms": round(ms, 3)}
        # count BEFORE replying: a client that reads counters right after
        # its response (the stats op, tests) must see itself counted
        obs.counter_add("serve.ok")
        self.slo.record(True)
        self._finish(req, ms)
        req.reply(doc)

    def _respond_err(self, reply, rid, err,
                     req: Request | None = None) -> None:
        if req is not None and not self._claimed(req):
            return
        obs.counter_add("serve.errors")
        # the SLO burns on SERVICE-attributable failures only: sheds,
        # deadlines, device exhaustion.  Client-attributable rejects
        # (InvalidRequest et al) and parse failures (req=None) consume
        # nobody's error budget
        if req is not None and isinstance(
                err, (Overloaded, DeadlineExceeded, ResourceExhausted)):
            self.slo.record(False)
        self._finish(None, None)
        reply(error_response(rid, err))

    def _respond_deadline(self, req: Request) -> None:
        if not self._claimed(req):
            return
        obs.counter_add("serve.deadline_exceeded")
        obs.counter_add("serve.errors")
        self.slo.record(False)
        self._finish(None, None)
        req.reply(error_response(req.id, DeadlineExceeded(
            "deadline passed before the result was produced",
            site="serve.deadline")))

    def _publish_slo(self, force: bool = False) -> None:
        now = time.monotonic()
        with self._slo_lock:
            if not force and now - self._last_publish < 0.5:
                return
            self._last_publish = now
        p50 = self.latency.quantile(0.50)
        p99 = self.latency.quantile(0.99)
        if p50 is not None:
            obs.gauge_set("serve.p50_ms", round(p50, 3))
        if p99 is not None:
            obs.gauge_set("serve.p99_ms", round(p99, 3))
        obs.gauge_set("serve.queue_depth", float(len(self.queue)))
        fast, slow = self.slo.burn_rates()
        obs.gauge_set("serve.slo.burn_fast", round(fast, 4))
        obs.gauge_set("serve.slo.burn_slow", round(slow, 4))
        with self._inflight_lock:
            inf = self._inflight
        if inf is not None:
            obs.gauge_set("serve.watchdog.dispatch_age_s",
                          round(time.monotonic() - inf[1], 3))
        from pluss_torch import engine

        obs.gauge_set("serve.compile_inflight",
                      float(engine.compile_inflight()))

    def _slo_loop(self) -> None:
        interval = max(self.config.prom_refresh_s, 0.1)
        while not self._stopping.wait(interval):
            self._publish_slo(force=True)
            tel = obs.active()
            if tel is not None and tel.prom_path:
                try:
                    tel.write_prom()
                except OSError:
                    pass
