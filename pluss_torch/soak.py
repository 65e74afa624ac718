"""Seeded soaks of the port: the property, chaos and serve soaks.

    python -m pluss_torch.soak [examples] [seed] [--cpu]
    python -m pluss_torch.soak --chaos N [seed] [--cpu]
    python -m pluss_torch.soak --serve N [seed] [--chaos] [--telemetry PATH] [--cpu]

The port's copy of the JAX package's ``soak.py``: the same three modes,
arguments and printed lines.  Every mode runs on the CUDA card unless
``--cpu`` is given; with no card and no ``--cpu`` it raises (it never
moves to the host by itself).  The seed defaults to the clock and is
printed, so any failure replays exactly.  Each mode's summary line ends
with the launches of the three kernels in this process
(``launches {...}``; the serve soak adds the daemon's).

- **Property soak** (default): three differential properties over random
  loop nests drawn by :func:`specs`, :func:`configs` and
  :func:`schedules` (the draw logic of the JAX package's property tests),
  ``examples`` of them for the first and two thirds and one third for the
  others, under ``hypothesis.seed``: :func:`pluss_torch.engine.run` on
  the device against the same run on the CPU (the kernels against their
  plain versions); the same under random ``assignment``/``start_point``;
  and :func:`pluss_torch.parallel.shard.shard_run` over ``D`` in (1, 2,
  4) copies of the device, steal and static dispatch, against the CPU's
  ``engine.run``.  A spec both sides refuse counts as equal only when
  both raise the same exception type.  The tests hold the CPU side
  against the JAX package and the oracle.
- **Chaos soak** (``--chaos N [seed]``): N rounds, each running
  :func:`pluss_torch.resilience.run_resilient` under a seeded random fault
  plan (:meth:`~pluss_torch.resilience.FaultPlan.random`: injected OOMs,
  kernel build failures, corrupt plan-cache entries) on a workload drawn
  from a pool; every round must end bit-identical to the clean run or in
  a classified ``PlussError`` (a raw exception escaping is a failure).
  The process's plan memo is dropped before each resilient run, so its
  plan comes from the disk cache, where a ``corrupt_cache`` fault fires.
  Then a ``cli sweep`` worker process is SIGKILLed mid-sweep, and the
  resumed device-group sweep must restore every journaled point,
  recompute only the rest and equal a clean serial sweep.
- **Serve soak** (``--serve N [seed] [--chaos] [--telemetry PATH]``): a
  ``python -m pluss_torch.cli serve`` daemon subprocess (telemetry on, a
  fault plan in ``PLUSS_FAULT_PLAN``: ``oom@2``, or a seeded random plan
  under ``--chaos``) and concurrent clients: a ``--warm`` first request
  answered near the steady p50, a forced shed (a ``sleep_ms`` hold plus
  a burst over ``--max-queue``, answered with typed ``Overloaded``), N
  interleaved requests from four client threads, every response (the
  degraded ones and their batch neighbours included) equal to a solo run
  in this process on the same device, and ``{"op": "shutdown"}`` with
  exit 0.  On the card the daemon runs with the co-tenancy advisory off
  (``PLUSS_SERVE_INTERFERENCE=off``): it derives each co-tenant's static
  prediction inside the dispatch, host work that at the card pool's
  sizes takes most of the daemon's time.

On the card the pools run at users' sizes: the chaos pool mvt-4000,
trmm-1000, GEMM-1024, GEMM-512 at two threads and chunk 3, and syrk-500;
the serve pool GEMM-1024 (the ``--warm`` entry), mvt-4000, syrk-1000, an
inline GEMM-1000 spec and a 2^24-ref trace over 2^20 cache lines (replayed
on the d24v wire); the sweep kill runs GEMM-256.  With ``--cpu`` they are
the JAX package's (n <= 16, a 20,000-ref trace, gemm-16).  The kernels are
built in this process before a daemon or sweep worker is spawned, so the
processes that share the card load one build.  Departures from the JAX
soak: the port has no share cap, so no ``share_cap`` fault and no
share-cap count; the serve soak stops after the drain (the JAX soak's
repeated-trace, crash/recover, placement and observability phases are
held on the card by ``chip_smoke.py``'s ``serve`` phase and on the host
by the serve tests).
"""

from __future__ import annotations

import json
import os
import sys
import time

#: the repository root: the working directory of spawned subprocesses
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- the device and the kernels' launch counts ------------------------------

def device_of(cpu: bool):
    """The soak's device: the host with ``--cpu``, else the CUDA card (this
    raises when there is none)."""
    import torch

    from pluss_torch import engine

    if cpu:
        return torch.device("cpu")
    engine.resolve_device(None)   # raises with no card
    return torch.device("cuda", torch.cuda.current_device())


def _wrappers() -> dict:
    """The three kernels' wrappers, under the names chip_smoke.py gives
    them; each counts its launches (``ops.build.count_launch``)."""
    from pluss_torch.ops.decode import decode_d24v
    from pluss_torch.ops.event_hist import event_histogram, masked_histogram

    return {"carried_event_hist": event_histogram,
            "masked_hist": masked_histogram, "d24v_decode": decode_d24v}


def launches() -> dict[str, int]:
    """This process's launches of each kernel so far."""
    return {name: int(w.launches) for name, w in _wrappers().items()}


def launches_of_counters(counters: dict) -> dict[str, int]:
    """The kernels' launches in another process, read off its telemetry
    counters (``kernel.launches.<wrapper>``)."""
    return {name: int(counters.get(f"kernel.launches.{w.__name__}", 0))
            for name, w in _wrappers().items()}


def prebuild(dev) -> None:
    """Build the three kernels now when ``dev`` is the card, so processes
    spawned later load this build instead of racing to compile it."""
    if dev.type == "cuda":
        from pluss_torch.ops import build

        build.build("event_hist", "masked_hist", "d24v_decode")


def _same(got, want) -> bool:
    return (got.max_iteration_count == want.max_iteration_count
            and got.noshare_dense.shape == want.noshare_dense.shape
            and (got.noshare_dense == want.noshare_dense).all()
            and got.share_raw == want.share_raw)


# --- the strategies ----------------------------------------------------------

def _max_addr(ref, max_ivs: list[int]) -> int:
    """Largest address the ref can touch (coefs are nonneg)."""
    return ref.addr_base + sum(
        c * max_ivs[d] for d, c in ref.addr_terms if c > 0
    )


def specs():
    """Random small loop nests: up to 2 nests of depth <= 3, trips 2-6,
    one bounded ancestor at most (``bound_coef`` over the parallel index,
    or ``bound_level`` over an enclosing inner level), varying starts,
    refs at every depth with 0-3 address terms, share spans 1-40."""
    from hypothesis import strategies as st

    from pluss_torch.spec import Loop, LoopNestSpec, Ref

    @st.composite
    def draw_spec(draw):
        n_arrays = draw(st.integers(1, 3))
        names = [f"arr{i}" for i in range(n_arrays)]
        n_nests = draw(st.integers(1, 2))
        nests = []
        maxes = {nm: 0 for nm in names}
        ref_id = [0]

        def gen_loop(depth: int, trips: list[int], max_ivs: list[int],
                     bounded_depth: int = 0, start_coefs: list[int] = [],
                     no_bounds: bool = False) -> Loop:
            trip = draw(st.integers(2, 6))
            # triangular inner loops: effective trip a + b*k over the
            # parallel index k, never at the root, within [0, trip].  ONE
            # bounded ancestor (the quad contract); bound_level > 0
            # references an enclosing inner level and forbids bounds below
            bound = None
            bound_level = 0
            start_coef = 0
            if depth >= 1 and not no_bounds and draw(st.booleans()):
                inner_ok = [l for l in range(1, depth)
                            if start_coefs[l] == 0]
                if depth >= 2 and inner_ok and draw(st.booleans()):
                    bound_level = draw(st.sampled_from(inner_ok))
                    bound = (0, 1)
                    trip = max(trips[bound_level] - 1, 1)
                elif bounded_depth <= 1:
                    ptrip = trips[0]
                    b = draw(st.sampled_from([1, -1]))
                    if b == 1 and trip >= ptrip:
                        bound = (draw(st.integers(1, trip - (ptrip - 1))), 1)
                    elif b == -1 and trip >= ptrip - 1:
                        bound = (draw(st.integers(ptrip - 1, trip)), -1)
            trips = trips + [trip]
            if depth >= 1:
                # varying start (trmm's k in [i+1, ...)): shifts iteration
                # values (addresses), not counts
                start_coef = draw(st.sampled_from([0, 0, 1]))
            max_ivs = max_ivs + [start_coef * (trips[0] - 1 if depth else 0)
                                 + trip - 1]
            body = []
            n_items = draw(st.integers(1, 3))
            for _ in range(n_items):
                deeper = depth < 2 and draw(st.booleans())
                if deeper:
                    body.append(gen_loop(
                        depth + 1, trips, max_ivs,
                        bounded_depth + (1 if bound is not None
                                         and bound_level == 0 else 0),
                        start_coefs + [start_coef],
                        no_bounds or bound_level > 0))
                else:
                    nm = names[draw(st.integers(0, n_arrays - 1))]
                    n_terms = draw(st.integers(0, len(trips)))
                    depths = draw(
                        st.permutations(range(len(trips)))
                    )[:n_terms]
                    terms = tuple(
                        (d, draw(st.sampled_from([1, 2, trips[d]])))
                        for d in sorted(depths)
                    )
                    ref = Ref(
                        f"R{ref_id[0]}", nm,
                        addr_terms=terms,
                        addr_base=draw(st.integers(0, 3)),
                        share_span=draw(
                            st.one_of(st.none(), st.integers(1, 40))
                        ),
                    )
                    ref_id[0] += 1
                    maxes[nm] = max(maxes[nm], _max_addr(ref, max_ivs))
                    body.append(ref)
            return Loop(trip=trip, body=tuple(body), bound_coef=bound,
                        start_coef=start_coef, bound_level=bound_level)

        for _ in range(n_nests):
            # start_coefs gets one entry per ancestor level as gen_loop
            # recurses (level l's coef lands at index l)
            nests.append(gen_loop(0, [], [], 0, []))
        arrays = tuple((nm, maxes[nm] + 1) for nm in names)
        return LoopNestSpec(name="prop", arrays=arrays, nests=tuple(nests))

    return draw_spec()


def configs():
    """Random schedules: 1-4 threads, chunks 1-5, cache lines of 8, 16 or
    64 bytes."""
    from hypothesis import strategies as st

    from pluss_torch.config import SamplerConfig

    @st.composite
    def draw_config(draw):
        return SamplerConfig(
            thread_num=draw(st.sampled_from([1, 2, 3, 4])),
            chunk_size=draw(st.integers(1, 5)),
            ds=8,
            cls=draw(st.sampled_from([8, 16, 64])),
        )

    return draw_config()


def schedules():
    """``(spec, cfg, assignment | None, start_point | None)``: random
    dynamic chunk -> thread maps and resume points on top of the random
    specs and configs."""
    from hypothesis import strategies as st

    from pluss_torch.sched import ChunkSchedule

    @st.composite
    def draw_schedule(draw):
        spec = draw(specs())
        cfg = draw(configs())
        asg = None
        if draw(st.booleans()):
            rows = []
            for nest in spec.nests:
                sched = ChunkSchedule(cfg.chunk_size, nest.trip, nest.start,
                                      nest.step, cfg.thread_num)
                rows.append(tuple(
                    draw(st.integers(0, cfg.thread_num - 1))
                    for _ in range(sched.n_chunks)
                ) if draw(st.booleans()) else None)
            asg = tuple(rows)
        sp = None
        if asg is None and draw(st.booleans()):
            nest = spec.nests[0]
            sp = nest.start + draw(st.integers(0, nest.trip - 1)) * nest.step
        return spec, cfg, asg, sp

    return draw_schedule()


# --- the property soak -------------------------------------------------------

class _Refusals:
    """Specs both sides refused with the same exception type."""

    def __init__(self):
        self.n = 0

    def same(self, reference, subject, what: str) -> None:
        """``reference()`` (the CPU's run) against ``subject()`` (the
        device's): equal results, or the same exception type from both."""
        try:
            want = reference()
        except Exception as e:  # noqa: BLE001 — the subject must match it
            try:
                subject()
            except type(e):
                self.n += 1
                return
            raise AssertionError(f"{what}: the CPU refused the spec "
                                 f"({type(e).__name__}: {e}), the device "
                                 "did not refuse it the same way") from e
        got = subject()
        if not _same(got, want):
            raise AssertionError(f"{what}: the device's result differs "
                                 "from the CPU's")


def soak(name: str, inner, budget: int, sd: int, **strats) -> None:
    """Run ``inner`` over ``budget`` examples drawn from ``strats`` under
    ``hypothesis.seed(sd)``."""
    from hypothesis import HealthCheck, given, seed, settings

    t0 = time.perf_counter()
    fn = seed(sd)(settings(
        max_examples=budget, deadline=None, database=None,
        suppress_health_check=list(HealthCheck),
    )(given(**strats)(inner)))
    fn()
    print(f"soak {name}: {budget} examples OK in "
          f"{time.perf_counter() - t0:.0f}s", flush=True)


def property_soak(budget: int, sd: int, dev) -> int:
    from hypothesis import strategies as st

    from pluss_torch import engine
    from pluss_torch.parallel.shard import shard_run

    print(f"soak seed {sd}", flush=True)
    refused = _Refusals()
    t0 = time.perf_counter()

    def run_pair(spec, cfg, **kw):
        refused.same(lambda: engine.run(spec, cfg, device="cpu", **kw),
                     lambda: engine.run(spec, cfg, device=dev, **kw),
                     f"engine.run({kw})")

    def specs_inner(spec, cfg, window):
        run_pair(spec, cfg, window_accesses=window)

    def schedules_inner(args):
        spec, cfg, asg, sp = args
        run_pair(spec, cfg, assignment=asg, start_point=sp)

    def shard_inner(spec, cfg):
        for D in (1, 2, 4):
            for dispatch in ("steal", "static"):
                refused.same(
                    lambda: engine.run(spec, cfg, device="cpu"),
                    lambda: shard_run(spec, cfg, devices=[dev] * D,
                                      dispatch=dispatch),
                    f"shard_run(D={D}, {dispatch})")

    soak("specs", specs_inner, budget, sd, spec=specs(), cfg=configs(),
         window=st.sampled_from([None, 64, 256]))
    soak("schedules", schedules_inner, max(1, (2 * budget) // 3), sd + 1,
         args=schedules())
    soak("shard", shard_inner, max(1, budget // 3), sd + 2, spec=specs(),
         cfg=configs())
    print(f"property soak: {budget} examples on {dev}, {refused.n} "
          f"refused alike, in {time.perf_counter() - t0:.1f}s, seed {sd}; "
          f"launches {json.dumps(launches())}", flush=True)
    return 0


# --- the chaos soak ----------------------------------------------------------

def chaos_pool(dev) -> list:
    """``(model, n, SamplerConfig)`` of the chaos rounds: users' sizes on
    the card (the sort path and kernel 1, varying starts, the template
    path, partial chunks that put the template into sort windows, the
    overlays), the JAX package's pool on the host."""
    from pluss_torch.config import SamplerConfig

    if dev.type == "cpu":
        return [("gemm", 16, SamplerConfig(cls=8)),
                ("syrk", 12, SamplerConfig(cls=8)),
                ("mvt", 16, SamplerConfig()),
                ("gemm", 13, SamplerConfig(thread_num=2, chunk_size=3))]
    return [("mvt", 4000, SamplerConfig()),
            ("trmm", 1000, SamplerConfig()),
            ("gemm", 1024, SamplerConfig()),
            ("gemm", 512, SamplerConfig(thread_num=2, chunk_size=3)),
            ("syrk", 500, SamplerConfig())]


def chaos(n_rounds: int, sd: int, dev) -> int:
    import random
    import shutil
    import tempfile

    # the plan cache points at a throwaway dir and stays ENABLED: without
    # it every injected corrupt_cache fault would be a no-op.  The dir
    # goes at the end; the telemetry stream and the sweep journal stay
    tmp = tempfile.mkdtemp(prefix="pluss_torch_chaos_")
    cache = os.path.join(tmp, "plan_cache")
    os.environ.pop("PLUSS_NO_PLAN_CACHE", None)
    os.environ["PLUSS_PLAN_CACHE_DIR"] = cache
    from pluss_torch import engine, obs
    from pluss_torch.models import REGISTRY
    from pluss_torch.resilience import FaultPlan, PlussError, faults
    from pluss_torch.resilience import run_resilient

    # the summary below (faults fired vs ladder rungs taken) is read off
    # the live counters, so it can never drift from what the injector and
    # the ladder recorded
    if not obs.enabled():
        obs.configure(os.path.join(tmp, "chaos_telemetry.jsonl"))
    prebuild(dev)
    pool = chaos_pool(dev)
    rng = random.Random(sd)
    failures = 0
    cleans: dict[int, object] = {}
    t_soak = time.perf_counter()
    for i in range(n_rounds):
        k = rng.randrange(len(pool))
        name, n, cfg = pool[k]
        plan = FaultPlan.random(sd + i, n_faults=rng.randint(1, 3))
        spec = REGISTRY[name](n)
        if k not in cleans:
            cleans[k] = engine.run(spec, cfg, device=dev)
        clean = cleans[k]
        # the plan comes from the disk cache, where corrupt_cache fires
        engine._plan_cached.cache_clear()
        faults.install(plan)
        t0 = time.perf_counter()
        res = None
        try:
            res = run_resilient(spec, cfg, device=dev)
            ok = _same(res, clean)
            status = "bit-exact" if ok else "MISMATCH"
            if not ok:
                failures += 1
        except PlussError as e:
            # a classified failure is an acceptable outcome (a plan whose
            # faults outnumber the retry budget, a failed kernel build on
            # the card); a RAW exception below is not
            status = f"classified {type(e).__name__}"
        except BaseException as e:  # noqa: BLE001 — this IS the assertion
            status = f"RAW ESCAPE {type(e).__name__}: {e}"
            failures += 1
        finally:
            faults.install(None)
        deg = ",".join(res.degradations) if res is not None else ""
        print(f"chaos[{i}] {name}{n} plan={plan.describe()}: {status}"
              + (f" (degraded: {deg})" if deg else "")
              + f" in {time.perf_counter() - t0:.1f}s", flush=True)
    failures += _chaos_sweep_kill(sd, dev, os.path.join(tmp, "sweep.jsonl"))
    shutil.rmtree(cache, ignore_errors=True)
    c = obs.counters()

    def breakdown(prefix: str) -> str:
        parts = [f"{k[len(prefix):]}={int(v)}" for k, v in sorted(c.items())
                 if k.startswith(prefix)]
        return " (" + ",".join(parts) + ")" if parts else ""

    tel = obs.active()
    print("chaos telemetry: "
          f"{int(c.get('resilience.faults_fired', 0))} fault(s) fired"
          f"{breakdown('resilience.faults_fired.')} vs "
          f"{int(c.get('resilience.rungs_taken', 0))} ladder rung(s) taken"
          f"{breakdown('resilience.rungs_taken.')}, "
          f"{int(c.get('resilience.retries', 0))} plain retr(y/ies)"
          + (f"; event stream at {tel.path}" if tel else ""), flush=True)
    obs.flush_metrics()
    print(f"chaos soak: {n_rounds} rounds, {failures} failure(s), seed {sd}"
          f" on {dev}, in {time.perf_counter() - t_soak:.1f}s; launches "
          f"{json.dumps(launches())}", flush=True)
    return 1 if failures else 0


def _chaos_sweep_kill(sd: int, dev, jr_path: str) -> int:
    """Kill a sweep worker process mid-sweep, then assert journaled
    recovery: the resumed device-group sweep restores every journaled
    point (no recomputation of finished work), computes only the rest,
    and its curves equal a clean serial sweep's.  Returns the failure
    count (0 = pass)."""
    import subprocess

    from pluss_torch import obs, sweep as sweep_mod
    from pluss_torch.config import SamplerConfig
    from pluss_torch.models import REGISTRY
    from pluss_torch.resilience.journal import Journal

    ts, cks = (1, 2, 4, 8), (2, 4)
    n = 16 if dev.type == "cpu" else 256
    total = len(ts) * len(cks)
    env = dict(os.environ)
    env.pop("PLUSS_FAULT_PLAN", None)
    env.pop("PLUSS_TELEMETRY", None)   # the child must not truncate ours
    proc = subprocess.Popen(
        [sys.executable, "-m", "pluss_torch.cli", "sweep",
         *(["--cpu"] if dev.type == "cpu" else []),
         "--model", "gemm", "--n", str(n),
         "--sweep-threads", ",".join(map(str, ts)),
         "--sweep-chunks", ",".join(map(str, cks)),
         "--journal", jr_path, "--resume", "--device-groups", "2"],
        cwd=REPO, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    # wait for >= 2 journaled points, then SIGKILL: a worker death in the
    # realistic shape (no cleanup, mid-flight points lost)
    try:
        deadline = time.time() + 240
        while time.time() < deadline:
            try:
                with open(jr_path) as fh:
                    if sum(1 for _ in fh) >= 2:
                        break
            except OSError:
                pass
            if proc.poll() is not None:
                break
            time.sleep(0.05)
        killed = proc.poll() is None
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    if not killed:
        print("chaos sweep-kill: sweep finished before the kill landed; "
              "recovery still asserted on the full journal", flush=True)
    finished = len(Journal(jr_path))
    spec = REGISTRY["gemm"](n)
    c0 = obs.counters()
    pts = sweep_mod.sweep(spec, ts, cks, SamplerConfig(), journal=jr_path,
                          resume=True, device_groups=2, device=dev)
    c1 = obs.counters()
    restored = int(c1.get("sweep.points_restored", 0)
                   - c0.get("sweep.points_restored", 0))
    ran = int(c1.get("sweep.points_run", 0) - c0.get("sweep.points_run", 0))
    clean = sweep_mod.sweep(spec, ts, cks, SamplerConfig(), device=dev)
    same = all(a.curve.tolist() == b.curve.tolist()
               and a.total_refs == b.total_refs
               for a, b in zip(pts, clean))
    ok = (restored == finished and ran == total - finished and same
          and len(pts) == total)
    print(f"chaos sweep-kill: {finished} point(s) journaled before the "
          f"kill; resumed sweep restored {restored}, recomputed {ran} "
          f"(zero recompute of finished points: "
          f"{restored == finished and ran == total - finished}), curves "
          f"{'bit-identical' if same else 'DIVERGED'} vs clean serial",
          flush=True)
    if not ok:
        print("chaos sweep-kill: FAIL", flush=True)
    return 0 if ok else 1


# --- the serve soak ----------------------------------------------------------

def serve_pool(dev, trace_path: str) -> tuple[list[dict], str]:
    """The serve soak's request pool and its ``--warm`` entry (pool[0]'s
    shape): users' sizes on the card, the JAX package's on the host."""
    from pluss_torch.models import REGISTRY
    from pluss_torch.spec_codec import spec_to_json

    n_inline = 13 if dev.type == "cpu" else 1000
    inline = spec_to_json(REGISTRY["gemm"](n_inline))
    inline["name"] = f"tenant_gemm{n_inline}"
    if dev.type == "cpu":
        pool = [{"model": "gemm", "n": 16, "threads": 2, "chunk": 2},
                {"model": "mvt", "n": 16, "threads": 4, "chunk": 4},
                {"model": "syrk", "n": 12, "threads": 2, "chunk": 4}]
    else:
        pool = [{"model": "gemm", "n": 1024, "threads": 4, "chunk": 4},
                {"model": "mvt", "n": 4000, "threads": 4, "chunk": 4},
                {"model": "syrk", "n": 1000, "threads": 2, "chunk": 4}]
    pool += [{"spec": inline, "threads": 2, "chunk": 2},
             {"trace": trace_path}]
    p0 = pool[0]
    return pool, f"{p0['model']}:{p0['n']}:{p0['threads']}:{p0['chunk']}"


def write_trace(path: str, dev, sd: int) -> None:
    """The trace request's file, from the seed: 2^24 refs uniform over
    2^20 cache lines of 64 bytes on the card (one address cluster, one
    batch of the d24v wire), 20,000 refs over 4096 bytes on the host."""
    import numpy as np

    rng = np.random.default_rng(sd)
    if dev.type == "cpu":
        rng.integers(0, 4096, 20_000).astype("<u8").tofile(path)
    else:
        (rng.integers(0, 1 << 20, 1 << 24) << 6).astype("<u8").tofile(path)


def serve(n_requests: int, sd: int, chaos: bool, telemetry: str | None,
          dev) -> int:
    import random
    import shutil
    import subprocess
    import tempfile
    import threading

    os.environ.pop("PLUSS_FAULT_PLAN", None)   # solo baselines stay clean
    tmp = tempfile.mkdtemp(prefix="pluss_torch_serve_soak_")
    # the daemon and this process's solo runs share one plan cache: a
    # model the daemon planned loads here instead of planning again
    os.environ.pop("PLUSS_NO_PLAN_CACHE", None)
    os.environ["PLUSS_PLAN_CACHE_DIR"] = os.path.join(tmp, "plan_cache")
    from pluss_torch import cri, engine, mrc, trace
    from pluss_torch.config import SamplerConfig
    from pluss_torch.models import REGISTRY
    from pluss_torch.serve import Client
    from pluss_torch.spec_codec import spec_from_json

    t_soak = time.perf_counter()
    sock = os.path.join(tmp, "serve.sock")
    tel = telemetry or os.path.join(tmp, "serve_telemetry.jsonl")
    trace_path = os.path.join(tmp, "refs.bin")
    write_trace(trace_path, dev, sd)
    pool, warm = serve_pool(dev, trace_path)
    prebuild(dev)

    max_queue = 4
    if chaos:
        from pluss_torch.resilience import FaultPlan

        fault_plan = FaultPlan.random(sd, n_faults=2).describe()
    else:
        # a fixed early OOM: an early engine dispatch of the daemon fails
        # injected and must recover through the serve ladder.  @2, not @1:
        # hit 1 is the warm first request, whose latency must stay a clean
        # measurement; the shed burst right after it takes the hit
        fault_plan = "oom@2"
    env = {**os.environ, "PLUSS_FAULT_PLAN": fault_plan}
    env.pop("PLUSS_TELEMETRY", None)   # the daemon gets --telemetry
    if dev.type == "cuda":
        # the co-tenancy advisory derives every co-tenant's static
        # prediction inside the dispatch: at the card pool's sizes that
        # host work is most of the daemon's time, so it is off here (it
        # stays on with --cpu, as in the JAX soak)
        env["PLUSS_SERVE_INTERFERENCE"] = "off"
    err_path = os.path.join(tmp, "daemon.err")
    with open(err_path, "w") as err_fh:
        daemon = subprocess.Popen(
            [sys.executable, "-m", "pluss_torch.cli", "serve", "--socket",
             sock, *(["--cpu"] if dev.type == "cpu" else []),
             "--telemetry", tel, "--max-batch", "8",
             "--max-queue", str(max_queue), "--max-delay-ms", "25",
             "--warm", warm],
            cwd=REPO, env=env, stderr=err_fh)
    print(f"serve soak seed {sd}: daemon pid {daemon.pid} on {dev}, fault "
          f"plan {fault_plan!r}, telemetry {tel}, interference advisory "
          f"{env.get('PLUSS_SERVE_INTERFERENCE', 'on')}", flush=True)

    def tail(path: str) -> str:
        with open(path) as fh:
            return fh.read()[-2000:]

    for _ in range(240):
        if os.path.exists(sock) or daemon.poll() is not None:
            break
        time.sleep(0.5)
    failures = 0
    daemon_launches: dict[str, int] = {}
    try:
        if daemon.poll() is not None or not os.path.exists(sock):
            print("serve soak: daemon failed to come up; stderr tail:")
            print(tail(err_path))
            return 1
        # ---- phase 0: warm-start SLO.  The daemon came up with --warm of
        # pool[0]'s exact shape; wait for the warmup to land, then time the
        # daemon's very FIRST request: a warmed daemon must answer it
        # within 2x the steady p50 measured at the end of the run
        # (asserted under the fixed plan only: a random chaos fault may
        # slow any request it lands on)
        warm_deadline = time.monotonic() + 120
        warm_ok = False
        while time.monotonic() < warm_deadline:
            try:
                with open(tel) as fh:
                    txt = fh.read()
            except FileNotFoundError:
                txt = ""
            if '"serve.warm_error"' in txt:
                break
            if '"serve.warm_done"' in txt:
                warm_ok = True
                break
            if daemon.poll() is not None:
                break
            time.sleep(0.2)
        if not warm_ok:
            print("serve soak: FAIL — daemon never reported warm_done")
            failures += 1
        with Client(sock) as c0:
            tq0 = time.perf_counter()
            first_resp = c0.request(dict(pool[0], output="both",
                                         id="warm-first"))
            first_ms = (time.perf_counter() - tq0) * 1e3
        if not first_resp.get("ok"):
            print(f"serve soak: FAIL — warm first request got {first_resp}")
            failures += 1

        # ---- phase 1: force a shed (typed Overloaded, never a crash)
        holder = Client(sock)
        hid = holder.send({"sleep_ms": 1200})
        time.sleep(0.2)   # let the hold reach the device loop
        with Client(sock) as burst:
            ids = [burst.send(dict(pool[0]))
                   for _ in range(max_queue + 6)]
            outcomes = [burst.recv(i) for i in ids]
        shed = [r for r in outcomes
                if not r.get("ok")
                and r.get("error", {}).get("type") == "Overloaded"]
        raw = [r for r in outcomes
               if not r.get("ok")
               and r.get("error", {}).get("type")
               not in ("Overloaded", "DeadlineExceeded")]
        # the injected fault may fire on the burst's dispatch: its
        # degradations count, and its served responses join the compare
        phase1_degraded = sum(1 for r in outcomes
                              if r.get("ok") and r.get("degradations"))
        print(f"serve soak: shed burst -> {len(shed)} Overloaded, "
              f"{sum(1 for r in outcomes if r.get('ok'))} served, "
              f"{phase1_degraded} degraded", flush=True)
        if not shed:
            print("serve soak: FAIL — burst past the admission bound "
                  "shed nothing")
            failures += 1
        if raw:
            print(f"serve soak: FAIL — untyped burst errors: {raw[:2]}")
            failures += 1
        holder.recv(hid)
        holder.close()

        # ---- phase 2: N mixed requests from concurrent clients
        rng = random.Random(sd)
        reqs = [dict(rng.choice(pool), output="both", id=f"r{i}")
                for i in range(n_requests)]
        responses: dict[str, dict] = {}
        rlock = threading.Lock()

        def worker(chunk):
            with Client(sock) as c:
                for q in chunk:
                    r = c.request(q)
                    with rlock:
                        responses[q["id"]] = r

        n_workers = min(4, max(1, n_requests))
        chunks = [reqs[i::n_workers] for i in range(n_workers)]
        threads = [threading.Thread(target=worker, args=(ch,))
                   for ch in chunks if ch]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0

        # ---- solo baselines (clean runs in this process), then compare
        solo: dict[str, dict] = {}

        def solo_payload(q) -> dict:
            cfg = SamplerConfig(thread_num=q.get("threads", 4),
                                chunk_size=q.get("chunk", 4))
            if "trace" in q:
                ri = trace.replay_file(q["trace"], "u64", cls=cfg.cls,
                                       device=dev).histogram()
            else:
                spec = REGISTRY[q["model"]](q["n"]) if "model" in q \
                    else spec_from_json(q["spec"])
                res = engine.run(spec, cfg, device=dev)
                ri = cri.distribute(res.noshare_list(), res.share_list(),
                                    cfg.thread_num)
            curve = mrc.aet_mrc(ri, cfg)
            return {"mrc": [[int(c), float(m)]
                            for c, m in mrc.dedup_lines(curve)],
                    "histogram": {str(int(k)): float(v)
                                  for k, v in sorted(ri.items())}}

        def key_of(q) -> str:
            return json.dumps({k: q[k] for k in
                               ("model", "n", "spec", "trace", "threads",
                                "chunk") if k in q}, sort_keys=True)

        degraded = phase1_degraded
        mismatches = 0
        bk = key_of(pool[0])
        solo[bk] = solo_payload(pool[0])
        if first_resp.get("ok"):
            if first_resp.get("degradations"):
                degraded += 1
            if first_resp.get("mrc") != solo[bk]["mrc"]:
                mismatches += 1
                print("serve soak: FAIL — the warm first response "
                      f"diverged (degradations="
                      f"{first_resp.get('degradations')})")
        for r in outcomes:
            if r.get("ok") and r.get("mrc") != solo[bk]["mrc"]:
                mismatches += 1
                print("serve soak: FAIL — a burst response diverged "
                      f"(degradations={r.get('degradations')})")
        for q in reqs:
            r = responses.get(q["id"])
            if r is None or not r.get("ok"):
                print(f"serve soak: FAIL — {q['id']} got {r}")
                failures += 1
                continue
            k = key_of(q)
            if k not in solo:
                solo[k] = solo_payload(q)
            if r.get("degradations"):
                degraded += 1
            if r["mrc"] != solo[k]["mrc"] \
                    or r["histogram"] != solo[k]["histogram"]:
                mismatches += 1
                print(f"serve soak: FAIL — {q['id']} diverged from the "
                      f"solo run (degradations={r.get('degradations')})")
        if mismatches:
            failures += 1
        if not chaos and not degraded:
            # the fixed oom@2 plan must have degraded SOMETHING
            print("serve soak: FAIL — injected fault degraded no request")
            failures += 1
        by_kind: dict[str, list[float]] = {}
        for q in reqs:
            r = responses.get(q["id"]) or {}
            if r.get("ok"):
                kind = (f"{q['model']}{q['n']}" if "model" in q else
                        q["spec"]["name"] if "spec" in q else "trace")
                by_kind.setdefault(kind, []).append(r["latency_ms"])
        print("serve soak: server latency ms by request: " + ", ".join(
            f"{k} x{len(v)} p50 {sorted(v)[len(v) // 2]:.1f} max "
            f"{max(v):.1f}" for k, v in sorted(by_kind.items())),
            flush=True)
        occup = len([r for r in responses.values() if r.get("ok")])
        batches = {r.get("batched") for r in responses.values()
                   if r.get("ok")}
        print(f"serve soak: {n_requests} mixed requests in {dt:.1f}s "
              f"({n_requests / dt:.1f} req/s), {occup} ok, "
              f"{degraded} degraded via the ladder, {mismatches} "
              f"divergence(s); batch occupancies seen {sorted(batches)}",
              flush=True)

        # ---- steady-state p50 of the warm entry's shape, closing the
        # phase-0 SLO: 5 serial requests over warm plans
        steadies = []
        with Client(sock) as c0:
            for _ in range(5):
                ts = time.perf_counter()
                c0.request(dict(pool[0], output="both"))
                steadies.append((time.perf_counter() - ts) * 1e3)
            daemon_launches = launches_of_counters(
                c0.request({"op": "stats"}).get("counters", {}))
        steady_p50 = sorted(steadies)[len(steadies) // 2]
        print(f"serve soak: warm first request {first_ms:.1f} ms vs "
              f"steady p50 {steady_p50:.1f} ms", flush=True)
        # floor the denominator: at trivial request cost the 2x bound
        # would be asserting on scheduler noise, not on warm-up work
        slow_first = not chaos and first_ms > 2.0 * max(steady_p50, 50.0)
        if slow_first:
            print(f"serve soak: FAIL — warmed daemon's first request "
                  f"({first_ms:.1f} ms) exceeded 2x steady p50 "
                  f"({steady_p50:.1f} ms)")
            failures += 1

        # ---- drain and stop
        with Client(sock) as c:
            c.request({"op": "shutdown"})
        rc = daemon.wait(timeout=60)
        if rc != 0:
            print(f"serve soak: FAIL — daemon exited {rc}; stderr tail:")
            print(tail(err_path))
            failures += 1
        if slow_first:
            # where the first request's time went: its span tree
            import io

            from pluss_torch.obs import stats as stats_mod

            buf = io.StringIO()
            stats_mod.main(tel, buf, sys.stderr, trace="warm-first")
            print(buf.getvalue(), flush=True)
    finally:
        if daemon.poll() is None:
            daemon.kill()
            daemon.wait()
        # the trace and the plans go; the telemetry and stderr stay
        os.unlink(trace_path)
        shutil.rmtree(os.environ["PLUSS_PLAN_CACHE_DIR"], ignore_errors=True)
    print(f"serve soak: {failures} failure(s), seed {sd} on {dev}, in "
          f"{time.perf_counter() - t_soak:.1f}s; telemetry stream at {tel};"
          f" launches {json.dumps(launches())}; daemon launches "
          f"{json.dumps(daemon_launches)}", flush=True)
    return 1 if failures else 0


# --- the entry point ---------------------------------------------------------

def main(argv: list[str] | None = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    cpu = "--cpu" in args
    args = [a for a in args if a != "--cpu"]
    if args and args[0] == "--serve":
        rest = args[1:]
        tel = None
        if "--telemetry" in rest:
            i = rest.index("--telemetry")
            tel = rest[i + 1]
            del rest[i:i + 2]
        chaos_flag = "--chaos" in rest
        rest = [a for a in rest if a != "--chaos"]
        n = int(rest[0]) if rest else 20
        sd = int(rest[1]) if len(rest) > 1 else int(time.time())
        return serve(n, sd, chaos_flag, tel, device_of(cpu))
    if args and args[0] == "--chaos":
        n = int(args[1]) if len(args) > 1 else 5
        sd = int(args[2]) if len(args) > 2 else int(time.time())
        dev = device_of(cpu)
        print(f"chaos soak seed {sd}", flush=True)
        return chaos(n, sd, dev)
    budget = int(args[0]) if args else 150
    sd = int(args[1]) if len(args) > 1 else int(time.time())
    return property_soak(budget, sd, device_of(cpu))


if __name__ == "__main__":
    sys.exit(main())
