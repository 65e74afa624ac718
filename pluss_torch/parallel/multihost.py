"""Multi-process execution on ``torch.distributed``.

The port's counterpart of ``pluss/parallel/multihost.py``.  The static
shard dispatch (:func:`pluss_torch.parallel.shard.shard_run`) needs only
``all_gather_into_tensor`` and ``all_reduce``, so a run across processes
is a configuration of the same call: initialize a process group, give
each rank its own device, call ``shard_run``.  NCCL carries the
collectives between CUDA ranks, gloo between CPU ranks (and between ranks
that share one card, which NCCL refuses).  This module brings the group
up, hardened as the JAX package's is:

- :func:`initialize` retries the rendezvous under a bounded exponential
  backoff with a per-attempt timeout, and classifies a terminal failure as
  :class:`~pluss_torch.resilience.errors.CollectiveError` at the
  ``multihost.init`` fault site;
- :func:`start_heartbeat` / :func:`dead_workers` give every process a
  file-based liveness channel on storage all ranks reach (a collective
  carries no liveness: a dead peer hangs it or breaks it);
- :func:`watched_shard_run` runs the sharded call under a watchdog that
  sees a stopped heartbeat within ``stale_s`` and, on the coordinator,
  salvages the run with ``engine.run`` in a clean subprocess, stamped
  ``local_salvage`` (``shard_run`` equals ``engine.run``, so the salvage
  is bit-identical, only slower).

Usage (one process per rank; no cluster environment tells a program its
place, so the caller names the address, the world size and the rank)::

    from pluss_torch.parallel import multihost
    multihost.initialize("tcp://localhost:29500", num_processes=2,
                         process_id=rank, device="cuda")
    res = shard_run(gemm(1024), devices=multihost.global_devices("cuda"))
"""

from __future__ import annotations

import datetime
import json
import os
import threading
import time

import torch

from pluss_torch import obs
from pluss_torch.resilience import faults
from pluss_torch.resilience.errors import WorkerDied, classify
from pluss_torch.utils import envknob


def heartbeat_interval_s() -> float:
    """File-heartbeat write period: ``PLUSS_HEARTBEAT_S`` (default 0.5 s)."""
    return envknob.env_float("PLUSS_HEARTBEAT_S", 0.5, 0.01)


def heartbeat_timeout_s() -> float:
    """Staleness that declares a worker dead: ``PLUSS_HEARTBEAT_TIMEOUT_S``
    (default 5 s, never below two heartbeat intervals)."""
    v = envknob.env_float("PLUSS_HEARTBEAT_TIMEOUT_S", 5.0, 0.05)
    return max(v, 2 * heartbeat_interval_s())


def _init_method(address: str | None) -> str:
    """``host:port`` -> ``tcp://host:port``; a URL (``tcp://``,
    ``file://``) as it is; None -> ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``)."""
    if address is None:
        return "env://"
    return address if "://" in address else f"tcp://{address}"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device=None,
               backend: str | None = None,
               connect_timeout_s: float = 60.0,
               max_retries: int = 3,
               backoff_s: float = 1.0) -> None:
    """``torch.distributed.init_process_group`` with bounded retry and
    backoff.

    ``coordinator_address``: the rendezvous (``host:port``, a ``tcp://``
    or ``file://`` URL, or None for ``env://``); ``num_processes`` and
    ``process_id`` are the world size and this rank.  ``backend`` defaults
    to NCCL when ``device`` is a CUDA device and gloo otherwise
    (``device`` resolves as every entry point's: the card unless the
    caller asks for the CPU).  Each attempt passes the ``multihost.init``
    fault site; a failed one retries after ``backoff_s * 2^attempt``; the
    last failure raises classified (a refused or timed-out rendezvous is a
    :class:`~pluss_torch.resilience.errors.CollectiveError`).
    """
    import torch.distributed as dist

    from pluss_torch import engine

    if backend is None:
        backend = "nccl" if engine.resolve_device(device).type == "cuda" \
            else "gloo"
    if process_id and os.environ.get("PLUSS_TELEMETRY"):
        # a worker names its stream before anything here can open the
        # coordinator's shared path (a sink truncates its path on open)
        obs.configure(f"{os.environ['PLUSS_TELEMETRY']}.p{process_id}")
    kwargs = dict(backend=backend, init_method=_init_method(
        coordinator_address), world_size=num_processes if num_processes
        is not None else -1, rank=process_id if process_id is not None
        else -1, timeout=datetime.timedelta(seconds=connect_timeout_s))
    last: BaseException | None = None
    t0 = time.monotonic()
    for attempt in range(max_retries):
        try:
            faults.check("multihost.init")   # chaos injection site
            dist.init_process_group(**kwargs)
            obs.counter_add("multihost.init_attempts", attempt + 1)
            obs.counter_add("multihost.init_s", time.monotonic() - t0)
            return
        except BaseException as e:  # noqa: BLE001 — classified below
            if isinstance(e, (KeyboardInterrupt, SystemExit)):
                raise
            last = e
            if attempt + 1 < max_retries:
                delay = backoff_s * (2 ** attempt)
                print(f"multihost: initialize attempt {attempt + 1}/"
                      f"{max_retries} failed ({e}); retrying in "
                      f"{delay:.1f}s", flush=True)
                time.sleep(delay)
    err = classify(last, site="multihost.init")
    err.args = (f"distributed initialize failed after {max_retries} "
                f"attempts: {err.args[0]}",)
    raise err


def process_count() -> int:
    """Ranks of the process group (1 without one)."""
    from pluss_torch.parallel.shard import group_size

    return group_size()


def _rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return _rank()


def is_coordinator() -> bool:
    """True on the process that owns printing and IO (rank 0)."""
    return process_index() == 0


def global_devices(device=None) -> list:
    """The device list this rank passes to ``shard_run`` in a process
    group: its own device, one segment (the group holds the others).  On
    CUDA the rank's card is ``LOCAL_RANK`` (else the rank) modulo the
    cards visible; several ranks may share one card (gloo only)."""
    from pluss_torch import engine

    dev = engine.resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return [dev]
    local = int(os.environ.get("LOCAL_RANK", process_index()))
    return [torch.device("cuda", local % torch.cuda.device_count())]


# ---------------------------------------------------------------------------
# liveness: file heartbeats and a watchdog


def _hb_path(hb_dir: str, process_index: int) -> str:
    return os.path.join(hb_dir, f"hb.{process_index}.json")


def start_heartbeat(hb_dir: str, process_index: int | None = None,
                    interval_s: float | None = None):
    """Write ``hb.<i>.json`` every ``interval_s`` (default
    :func:`heartbeat_interval_s`) from a daemon thread; returns a
    ``stop()`` callable.  Staleness is judged by :func:`dead_workers`
    against the file's mtime.

    The ``multihost.heartbeat`` fault site: a plan entry ``kill_worker@i``
    hard-exits process ``i`` from this thread after its first beat
    (``os._exit(43)``, no cleanup, like a killed worker)."""
    pid = _rank() if process_index is None else process_index
    if interval_s is None:
        interval_s = heartbeat_interval_s()
    os.makedirs(hb_dir, exist_ok=True)
    stop = threading.Event()

    def beat() -> None:
        n = 0
        while not stop.is_set():
            tmp = _hb_path(hb_dir, pid) + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"t": time.time(), "n": n, "pid": os.getpid()}, f)
            os.replace(tmp, _hb_path(hb_dir, pid))
            n += 1
            if faults.should_kill("multihost.heartbeat", pid):
                os._exit(43)
            stop.wait(interval_s)

    t = threading.Thread(target=beat, daemon=True, name=f"pluss-hb-{pid}")
    t.start()

    def stopper() -> None:
        stop.set()
        t.join(timeout=5)

    return stopper


#: monotonic time of the last heartbeat-age gauge publication: the gauges
#: are sampled at most once per beat interval, the verdicts every poll
_last_age_gauge = 0.0


def dead_workers(hb_dir: str, num_processes: int,
                 stale_s: float | None = None) -> list[int]:
    """Process indices whose heartbeat is missing or older than ``stale_s``
    (default :func:`heartbeat_timeout_s`).  Each worker's heartbeat age is
    published as the gauge ``multihost.heartbeat_age_s.<i>`` (-1 for a
    missing file), at most once per beat interval."""
    global _last_age_gauge
    if stale_s is None:
        stale_s = heartbeat_timeout_s()
    obs_on = obs.enabled()
    if obs_on:
        mono = time.monotonic()
        if mono - _last_age_gauge < heartbeat_interval_s():
            obs_on = False
        else:
            _last_age_gauge = mono
    now = time.time()
    dead = []
    for i in range(num_processes):
        try:
            age = now - os.path.getmtime(_hb_path(hb_dir, i))
        except OSError:
            if obs_on:
                obs.gauge_set(f"multihost.heartbeat_age_s.{i}", -1.0)
            dead.append(i)
            continue
        if obs_on:
            obs.gauge_set(f"multihost.heartbeat_age_s.{i}", round(age, 3))
        if age > stale_s:
            dead.append(i)
    return dead


def start_heartbeat_exporter(hb_dir: str, num_processes: int,
                             interval_s: float | None = None):
    """Refresh the ``multihost.heartbeat_age_s.<i>`` gauges (through
    :func:`dead_workers`) and rewrite the Prometheus textfile
    (``PLUSS_PROM``) on a timer, so a long-lived daemon's fleet health is
    scrapeable while it runs.  ``interval_s`` defaults to
    ``PLUSS_PROM_REFRESH_S`` (5 s), floored at the heartbeat interval.
    Returns an idempotent ``stop()`` that joins the thread and refreshes
    once more; a failing tick prints one notice and the timer goes on."""
    if interval_s is None:
        interval_s = envknob.env_float("PLUSS_PROM_REFRESH_S", 5.0, 0.1)
    interval_s = max(interval_s, heartbeat_interval_s())
    stop_ev = threading.Event()
    warned = [False]

    def tick() -> None:
        try:
            dead_workers(hb_dir, num_processes)
            tel = obs.active()
            if tel is not None and tel.prom_path:
                tel.write_prom()
        except Exception as e:  # noqa: BLE001 — an observer must not kill
            if not warned[0]:
                warned[0] = True
                import sys

                print(f"multihost: heartbeat exporter tick failed ({e}); "
                      "continuing", file=sys.stderr)

    def loop() -> None:
        while not stop_ev.wait(interval_s):
            tick()

    t = threading.Thread(target=loop, name="pluss-hb-exporter", daemon=True)
    t.start()

    def stop() -> None:
        stop_ev.set()
        t.join(timeout=5)
        tick()

    return stop


def watched_shard_run(spec, cfg=None, devices=None, *, hb_dir: str,
                      num_processes: int | None = None,
                      timeout_s: float = 60.0,
                      stale_s: float | None = None,
                      first_beat_timeout_s: float = 30.0,
                      salvage: bool = True, **kw):
    """``shard_run`` under a worker-death watchdog.

    The sharded call runs in a daemon thread while this one polls the
    heartbeat directory.  When a worker stops beating (or the run passes
    ``timeout_s``), the hung or broken collective is abandoned and, on the
    coordinator with ``salvage``, the run is recomputed by ``engine.run``
    in a clean subprocess on the kind of device ``devices`` name, stamped
    ``degradations=('worker_died:<ids>', 'local_salvage')``; elsewhere
    :class:`~pluss_torch.resilience.errors.WorkerDied` is raised.  The
    watchdog arms once every worker has beaten (bounded by
    ``first_beat_timeout_s``).  ``**kw`` goes to ``shard_run``.
    """
    from pluss_torch.config import DEFAULT
    from pluss_torch.parallel.shard import _as_devices, shard_run

    cfg = cfg if cfg is not None else DEFAULT
    nproc = num_processes or process_count()
    if stale_s is None:
        stale_s = heartbeat_timeout_s()
    box: dict = {}

    def target() -> None:
        t0 = time.monotonic()
        try:
            box["res"] = shard_run(spec, cfg, devices=devices, **kw)
            obs.counter_add("multihost.shard_run_s", time.monotonic() - t0)
        except BaseException as e:  # noqa: BLE001 — classified below
            box["err"] = e

    t = threading.Thread(target=target, daemon=True,
                         name="pluss-watched-shard-run")
    t.start()
    deadline = time.time() + timeout_s
    armed = False
    arm_deadline = time.time() + first_beat_timeout_s
    dead: list[int] = []
    while t.is_alive() and time.time() < deadline:
        if not armed:
            if not dead_workers(hb_dir, nproc, stale_s=1e18):
                armed = True   # every worker has beaten at least once
            elif time.time() > arm_deadline:
                armed = True   # never-beaten workers now count as dead
        if armed:
            dead = dead_workers(hb_dir, nproc, stale_s)
            if dead:
                break
        t.join(timeout=0.25)
    if not t.is_alive():
        if "err" not in box:
            return box["res"]
        # a dead peer often breaks the collective instead of hanging it:
        # give the liveness channel one staleness window to attribute the
        # error before blaming the computation (only a worker that has
        # beaten can be declared dead here)
        grace = time.time() + stale_s + 2.0
        while not dead and time.time() < grace:
            dead = [i for i in dead_workers(hb_dir, nproc, stale_s)
                    if os.path.exists(_hb_path(hb_dir, i))]
            if not dead:
                time.sleep(0.25)
        if not dead:
            raise classify(box["err"], site="shard.run")
    if not dead:   # still running past the deadline: recheck liveness
        dead = dead_workers(hb_dir, nproc, stale_s)
    err = WorkerDied(
        f"worker(s) {dead or '<unknown>'} stopped heartbeating; "
        f"abandoning the hung collective", site="multihost.watch",
        process_ids=tuple(dead))
    obs.counter_add("multihost.worker_deaths", max(1, len(dead)))
    obs.event("multihost.worker_died", processes=list(dead),
              model=getattr(spec, "name", "?"))
    if salvage and is_coordinator():
        print(f"multihost: {err}; salvaging in a clean subprocess",
              flush=True)
        obs.counter_add("multihost.salvages")
        kind = _as_devices(devices)[0].type if devices else None
        res = _salvage_subprocess(spec, cfg, kw.get("window_accesses"),
                                  kw.get("assignment"),
                                  kw.get("start_point"), device=kind)
        res.degradations = (
            f"worker_died:{','.join(map(str, dead)) or '?'}",
            "local_salvage")
        return res
    raise err


def _salvage_subprocess(spec, cfg, window_accesses: int | None,
                        assignment=None, start_point: int | None = None,
                        device=None, timeout_s: float = 600.0):
    """Recompute ``engine.run`` in a fresh single-process interpreter on
    ``device`` (None: the card).  Not in process: the abandoned
    collective may still hold the process group (and its device queue).
    The spec, config and result travel by pickle; the child leaves the
    group, the fault plan and the telemetry sink alone (a sink truncates
    its path on open)."""
    import pickle
    import subprocess
    import sys
    import tempfile

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory() as td:
        inp, outp = os.path.join(td, "in.pkl"), os.path.join(td, "out.pkl")
        with open(inp, "wb") as f:
            pickle.dump({"spec": spec, "cfg": cfg, "device": device,
                         "window_accesses": window_accesses,
                         "assignment": assignment,
                         "start_point": start_point}, f)
        code = (
            "import pickle, sys\n"
            "from pluss_torch import engine\n"
            "p = pickle.load(open(sys.argv[1], 'rb'))\n"
            "res = engine.run(p['spec'], p['cfg'], device=p['device'],\n"
            "                 assignment=p['assignment'],\n"
            "                 start_point=p['start_point'],\n"
            "                 window_accesses=p['window_accesses'])\n"
            "pickle.dump(res, open(sys.argv[2], 'wb'))\n"
        )
        env = {**os.environ, "PYTHONPATH": repo + os.pathsep
               + os.environ.get("PYTHONPATH", "")}
        for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                    "LOCAL_RANK", "PLUSS_FAULT_PLAN", "PLUSS_TELEMETRY",
                    "PLUSS_PROM", "PLUSS_XPROF"):
            env.pop(var, None)
        proc = subprocess.run([sys.executable, "-c", code, inp, outp],
                              env=env, capture_output=True, text=True,
                              timeout=timeout_s)
        if proc.returncode != 0:
            raise WorkerDied("local salvage subprocess failed: "
                             f"{proc.stderr[-500:]}", site="multihost.salvage")
        with open(outp, "rb") as f:
            return pickle.load(f)
