"""One run of one cell: set-up, the measured window, the check, the line.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (see ``run.py``) lands in :func:`main`.  Everything a cell
is made of is data, found by name:

- the cell in ``BENCHMARK.json`` (``workloads``), its configuration's file
  (``configs[].file``) and its mix, ``benchmark/traffic/<traffic>.json``
  (:mod:`benchmark.traffic`).  A configuration is a loop nest (the spec
  document, the schedule, the machine numbers; :class:`Cell`), or, with
  ``"kind": "trace"``, a raw address trace (a loop nest's data references
  in program order, written by :mod:`benchmark.tracedata` in set-up;
  :class:`TraceCell`), or, with ``"kind": "serve"``, the program's daemon
  serving a pool of tenants, driven open-loop (:mod:`benchmark.serve`);
- each per-layer metric, a reader ``benchmark/metrics/<name>.py`` with
  ``read(run) -> float | None`` over the traced window (:class:`Traced`).

A metric named ``<quantity>.<part>`` reports ``<quantity>`` (its reader,
or the end-to-end number of that name) under a name of its own, so that
cells of different noise take different bounds, and their per-layer
metrics a different ``moves``.

Set-up plans and builds what the cell needs and runs one warm-up
prediction of its own shape; the window then runs predictions back to
back for ``--seconds``, the last one to its end.  Once the window has
closed, its peak memory read and the program's device memory freed, the
reference (:mod:`benchmark.reference`) recomputes the checked predictions
and :mod:`benchmark.compare` decides ``correct``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

from benchmark import compare, devtrace, tracedata, traffic

#: top-level module names the process may not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "pluss")

HERE = os.path.dirname(os.path.abspath(__file__))

#: the device trace covers the window's first predictions, at least this
#: many seconds of them (a longer one takes minutes to read back)
TRACE_S = 1.0


class Traced:
    """What a per-layer metric's reader sees of the traced run.

    The program's and the benchmark's spans and the program's counters
    cover the whole window; the device trace covers its first predictions,
    at least ``TRACE_S`` seconds of them (``traced_preds``, ``traced_s``)."""

    def __init__(self, n_preds, spans, counters, tracer, plan, mix, config):
        self.n_preds = n_preds        # predictions completed in the window
        self.spans = spans            # [(name, seconds)]: program + benchmark
        self.counters = counters      # {name: increase over the window}
        self.ops = tracer.ops         # [(device op, seconds, launches)]
        self.launched = tracer.launched   # [(device op, seconds, host ops)]
        self.busy_s = tracer.busy_s   # device busy seconds, or None
        self.traced_s = tracer.traced_s
        self.traced_preds = tracer.preds
        self.plan = plan              # the window's plan, or None (many)
        self.mix, self.config = mix, config

    def planned(self) -> list:
        """``(plan, mix, spec document, traced predictions)`` for each plan
        the traced predictions ran: one, or none where they ran many."""
        if self.plan is None:
            return []
        return [(self.plan, self.mix, self.config["spec"],
                 self.traced_preds)]

    def span_s(self, *names: str) -> float | None:
        """Seconds of the named spans summed, or None when none ran."""
        got = [s for n, s in self.spans if n in names]
        return sum(got) if got else None

    def counter(self, name: str) -> float | None:
        """The increase of the program's counter ``name`` over the window,
        or None when it never counted."""
        return self.counters.get(name)

    def device_s(self, match) -> float | None:
        """Device seconds of the traced operations whose name ``match``
        accepts, or None when none ran."""
        got = [s for n, s, _ in self.ops if match(n)]
        return sum(got) if got else None

    def device_s_under(self, ops, outside=()) -> float | None:
        """Device seconds of the traced operations launched inside a host
        operation named in ``ops`` (the launching operator or a parent)
        and inside none named in ``outside``, or None when none ran."""
        ops, outside = set(ops), set(outside)
        got = [s for _, s, host in self.launched
               if host & ops and not host & outside]
        return sum(got) if got else None


def load_bench(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_of(bench: dict, name: str, root: str) -> tuple[dict, dict, dict]:
    """(cell, configuration, mix) of the cell ``name``; files are found
    under the checkout ``root``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic",
                           cell["traffic"] + ".json")) as f:
        mix = json.load(f)
    traffic.check_mix(mix, config)
    return cell, config, mix


def is_trace(config: dict) -> bool:
    """Whether ``config`` is a raw address trace (else a loop nest)."""
    return config.get("kind") == "trace"


def is_serve(config: dict) -> bool:
    """Whether ``config`` is a served deployment (:mod:`benchmark.serve`,
    driven open-loop)."""
    return config.get("kind") == "serve"


@contextlib.contextmanager
def inputs(config: dict, seed: int, device: str = "cpu"):
    """The run's input data, made from ``seed``: for a trace configuration
    the path of its trace file, enumerated on ``device``, written under the
    temporary directory and removed on every way out; for a loop nest None
    (its input is the spec document).  The card's memory the writer took is
    freed, and its peak forgotten, before the program starts."""
    if not is_trace(config):
        yield None
        return
    fd, path = tempfile.mkstemp(prefix="benchmark-trace-", suffix=".u64")
    try:
        t0 = time.monotonic()
        with os.fdopen(fd, "wb") as f:
            tracedata.write(f, config, traffic.trace_rng(seed), device)
        if device == "cuda":
            import torch
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        print(f"benchmark: wrote the {config['refs']}-ref trace in "
              f"{time.monotonic() - t0:.3f} s", file=sys.stderr)
        yield path
    finally:
        with contextlib.suppress(FileNotFoundError):
            os.remove(path)


def metrics_of(bench: dict, cell: dict, trace: bool) -> list[dict]:
    """The metrics this cell reports: without the trace, its end-to-end
    metrics (those without a ``workloads`` list are every cell's); with
    it, the per-layer metrics whose ``workloads`` list the cell."""
    name = cell["name"]
    if not trace:
        return [m for m in bench["end_to_end"]
                if name in m.get("workloads", [name])]
    return [m for m in bench["per_layer"] if name in m["workloads"]]


def quantity(name: str) -> str:
    """The quantity a metric reports: its name up to the first dot."""
    return name.split(".")[0]


def _reader(name: str, root: str):
    path = os.path.join(root, "benchmark", "metrics",
                        quantity(name) + ".py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _env(mix: dict, root: str) -> None:
    """The program's two plan-cache settings: a fixed directory inside the
    checkout, or off."""
    if mix.get("plan_cache", True):
        os.environ["PLUSS_PLAN_CACHE_DIR"] = os.path.join(
            root, ".benchcache", "plans")
        os.environ.pop("PLUSS_NO_PLAN_CACHE", None)
    else:
        os.environ["PLUSS_NO_PLAN_CACHE"] = "1"


class Cell:
    """The system under test, driven the way one user drives it."""

    def __init__(self, config: dict, mix: dict, device: str):
        from pluss_torch import cri, engine, mrc, sampling
        from pluss_torch.config import SamplerConfig
        from pluss_torch.spec_codec import spec_from_json
        self.engine, self.sampling, self.cri, self.mrc = \
            engine, sampling, cri, mrc
        self.SamplerConfig = SamplerConfig
        self.spec = spec_from_json(config["spec"])
        self.config, self.mix, self.device = config, mix, device
        self.spans: list = []

    def close(self) -> None:
        """Nothing outlives a loop-nest prediction but the plan caches."""

    def cfg(self, p: traffic.Prediction):
        c = self.config
        return self.SamplerConfig(thread_num=p.thread_num,
                                  chunk_size=p.chunk_size, ds=c["ds"],
                                  cls=c["cls"], cache_kb=c["cache_kb"])

    def predict(self, p: traffic.Prediction, clock):
        """One prediction, to its MRC on the host.  Without the plan cache
        the process's plan memo goes too, so every prediction plans, also
        once a schedule list has wrapped."""
        span = devtrace.span
        cfg = self.cfg(p)
        if not self.mix.get("plan_cache", True):
            self.engine._plan_cached.cache_clear()
            self.sampling._plan_cached.cache_clear()
        with span("bench.predict", self.spans, clock):
            if self.mix["run"] == "sampled":
                with span("bench.sampler", self.spans, clock):
                    res = self.sampling.sampled_run(
                        self.spec, cfg, float(self.mix["rate"]),
                        p.sample_seed, mode="uniform", device=self.device)
            else:
                res = self.engine.run(self.spec, cfg, device=self.device)
            with span("bench.cri", self.spans, clock):
                rihist = self.cri.distribute(res.noshare_list(),
                                             res.share_list(), cfg.thread_num)
            with span("bench.mrc", self.spans, clock):
                curve = self.mrc.aet_mrc(rihist, cfg)
        return (res.noshare_list(),
                [{int(v): float(c) for v, c in d.items()}
                 for d in res.share_raw],
                res.max_iteration_count, rihist, curve)

    def plan(self):
        """The plan every window prediction ran, or None when they ran
        many (a schedule sweep)."""
        if self.mix.get("schedules"):
            return None
        cfg = self.cfg(traffic.warmup(self.mix, self.config, 0))
        if self.mix["run"] == "sampled":
            return self.sampling._plan_cached(self.spec, cfg, None)
        return self.engine._plan_cached(self.spec, cfg, None, None, None)


class TraceCell:
    """A trace replay, driven as ``python -m pluss_torch.cli trace FILE``
    drives it (with ``--resident-cache`` when the mix says so): the
    resilient replay on the card, its ladder without the CPU rung, then
    the MRC of its histogram.  ``path`` is the trace file set-up wrote."""

    def __init__(self, config: dict, mix: dict, device: str, path: str):
        from pluss_torch import mrc, residency
        from pluss_torch.config import SamplerConfig
        from pluss_torch.resilience import replay_file_resilient
        from pluss_torch.resilience.ladder import TRACE_LADDER
        self.mrc, self.residency = mrc, residency
        self.replay_file = replay_file_resilient
        self.rungs = tuple(r for r in TRACE_LADDER if r != "cpu_fallback")
        self.cfg = SamplerConfig(cls=config["cls"],
                                 cache_kb=config["cache_kb"])
        self.config, self.mix, self.device, self.path = \
            config, mix, device, path
        self.spans: list = []

    def close(self) -> None:
        """Drop the resident copy the store holds."""
        self.residency.store().clear()

    def predict(self, p: traffic.Prediction, clock):
        """One replay of the whole trace, to its MRC on the host."""
        span = devtrace.span
        with span("bench.predict", self.spans, clock):
            with span("bench.replay", self.spans, clock):
                rep = self.replay_file(
                    self.path, self.config["fmt"], rungs=self.rungs,
                    cls=self.cfg.cls,
                    resident_cache=bool(self.mix.get("resident_cache")),
                    device=self.device)
            if rep.degradations:
                print("benchmark: the replay degraded: "
                      + ",".join(rep.degradations), file=sys.stderr)
            with span("bench.mrc", self.spans, clock):
                rihist = rep.histogram()
                curve = self.mrc.aet_mrc(rihist, self.cfg)
        return rep.hist, rep.total_count, rep.n_lines, rihist, curve

    def plan(self):
        return None


def system(config: dict, mix: dict, device: str, data):
    """The system under test for ``config``, on its input ``data``."""
    if is_trace(config):
        return TraceCell(config, mix, device, data)
    return Cell(config, mix, device)


def reference(config: dict, mix: dict, p: traffic.Prediction, device: str,
              data=None, dtype=np.float64):
    """The reference's answer to prediction ``p`` on the input ``data``
    (:func:`inputs`): its counts (a loop nest's per-thread histograms and
    accesses, a trace's :class:`benchmark.reference.trace.Counts`), its CRI
    histogram (a trace's reuse histogram itself) and its MRC."""
    from benchmark.reference import curve, stream, trace
    if is_trace(config):
        h = trace.replay(data, config["cls"], device)
        rihist = trace.histogram(h, dtype)
        return h, rihist, curve.aet_mrc(rihist, config["cache_kb"], dtype)
    sch = stream.Schedule(p.thread_num, p.chunk_size, config["ds"],
                          config["cls"])
    if mix["run"] == "sampled":
        h = stream.sampled(config["spec"], sch, device, float(mix["rate"]),
                           p.sample_seed)
    else:
        h = stream.full(config["spec"], sch, device)
    rihist = curve.distribute(h.noshare, h.share, p.thread_num, dtype)
    return h, rihist, curve.aet_mrc(rihist, config["cache_kb"], dtype)


def check(config: dict, mix: dict, answers: list, seed: int,
          device: str, data=None) -> dict:
    """Hold every checked prediction's answer against the reference."""
    keys = [p.key for p, _ in answers]
    nums = {"counts_off": 0, "cri_gap": 0.0, "mrc_gap": 0.0}
    counts_off = compare.trace_counts_off if is_trace(config) \
        else compare.counts_off
    for key in traffic.checked(keys, mix, seed):
        p = next(p for p, _ in answers if p.key == key)
        h, rihist, curve = reference(config, mix, p, device, data)
        for q, (*counts, rih, crv) in answers:
            if q.key != key:
                continue
            nums["counts_off"] += counts_off(*counts, h)
            nums["cri_gap"] = max(nums["cri_gap"],
                                  compare.cri_gap(rih, rihist))
            nums["mrc_gap"] = max(nums["mrc_gap"],
                                  compare.mrc_gap(crv, curve))
    return {k: (v if math.isfinite(v) else 1e300) for k, v in nums.items()}


def _card() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def _port_records(path: str) -> tuple[list, dict]:
    """The program's telemetry over the window: ``(name, seconds)`` of each
    span record, and each counter's increase by name.  Counter records are
    cumulative from the session's start, which is the window's, so the
    last one of a name is its increase."""
    spans, counters = [], {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("ev") == "span":
                spans.append((rec["name"], rec["dur"]))
            elif rec.get("ev") == "counter":
                counters[rec["name"]] = rec["value"]
    return spans, counters


def run(root: str, workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda") -> dict:
    """Run one cell on ``device`` (the tests run it on the CPU); returns
    the result line's object."""
    bench = load_bench(root)
    cell, config, mix = cell_of(bench, workload, root)
    _env(mix, root)
    if is_serve(config):
        from benchmark import serve
        return serve.run(root, bench, cell, config, mix, seed, seconds,
                         trace, t_start, device)
    with inputs(config, seed, device) as data:
        return _run(root, bench, cell, config, mix, data, seed, seconds,
                    trace, t_start, device)


def _run(root, bench, cell, config, mix, data, seed, seconds, trace,
         t_start, device) -> dict:
    workload = cell["name"]
    import torch
    cuda = device == "cuda"
    clock = time.monotonic
    sut = system(config, mix, device, data)
    sut.predict(traffic.warmup(mix, config, seed), clock)
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    sut.spans.clear()
    tracer = devtrace.Tracer(TRACE_S, clock) if trace else None
    if trace:
        from pluss_torch import obs
        fd, tel = tempfile.mkstemp(prefix=f"bench-{workload}-",
                                   suffix=".jsonl")
        os.close(fd)
        obs.configure(tel)
    answers, failed, attempted, times = [], 0, 0, []
    gen = traffic.predictions(mix, config, seed)
    setup_s = clock() - t_start
    cpu0 = time.process_time()
    t0 = clock()
    while clock() - t0 < seconds:
        p = next(gen)
        attempted += 1
        if tracer:
            tracer.before(p)
        ts = clock()
        try:
            answers.append((p, sut.predict(p, clock)))
        except Exception as e:   # a failed prediction counts, and shows
            failed += 1
            print(f"prediction {p} failed: {e!r}", file=sys.stderr)
        times.append(clock() - ts)
        if tracer:
            tracer.after()
    window_s = clock() - t0
    cpu_s = time.process_time() - cpu0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    traced = None
    if trace:
        tracer.close()
        obs.shutdown()
        spans, counters = _port_records(tel)
        traced = Traced(len(answers), spans + sut.spans, counters, tracer,
                        sut.plan(), mix, config)
        os.remove(tel)
    n = len(answers)
    metrics = {}
    for m in metrics_of(bench, cell, trace):
        if trace:
            v = _reader(m["name"], root)(traced)
        else:
            v = {"setup_s": setup_s,
                 "pred_s": window_s / n if n else None,
                 "pred_p90_s": statistics.quantiles(
                     times, n=10, method="inclusive")[8]
                 if len(times) >= 2 else None,
                 "peak_gib": peak / 2**30}.get(quantity(m["name"]))
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    sut.close()
    del sut
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    nums = check(config, mix, answers, seed, device, data)
    correct = n > 0 and failed == 0 and compare.judge(nums)
    checks = {k: {"value": v, "limit": compare.LIMITS[k]}
              for k, v in nums.items()}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics,
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
    if cuda:
        out["card"] = _card()
    out["checks"] = checks
    # last, once everything that follows the window has run: the readers,
    # the reference, the card's name
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        raise SystemExit(f"benchmark: the process holds {found} after the "
                         "window; no result")
    return out


def cards() -> int:
    """The CUDA cards this process can use."""
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.monotonic() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.path.dirname(HERE)
    bench = load_bench(root)
    cell, _, _ = cell_of(bench, args.workload, root)
    if cards() < int(cell["chips"]):
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA "
              "card(s); none or too few here", file=sys.stderr)
        return 2
    out = run(root, args.workload, args.seed, args.seconds,
              bool(args.trace), t_start)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
