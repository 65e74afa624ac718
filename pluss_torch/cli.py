"""The port's CLI: the reference's run modes, the static analysis modes and
the authoring and transform modes.

    python -m pluss_torch.cli acc --model gemm --n 1024      # on the CUDA card
    python -m pluss_torch.cli acc --cpu --model gemm --n 16  # on the host
    python -m pluss_torch.cli sample --model gemm --n 1024 --rates 0.05,0.1
    python -m pluss_torch.cli trace --file t.bin --out mrc.csv
    python -m pluss_torch.cli acc --cpu --telemetry ev.jsonl
    python -m pluss_torch.cli stats ev.jsonl --check
    python -m pluss_torch.cli lint --all
    python -m pluss_torch.cli predict --all --n 16 --check   # on the card
    python -m pluss_torch.cli tune mvt --n 1000 --check --cpu
    python -m pluss_torch.cli import nest.c --run --cpu
    python -m pluss_torch.cli transform gemm --interchange 0,2 --json
    python -m pluss_torch.cli sweep --cpu --model gemm --n 16
    python -m pluss_torch.cli serve --cpu --socket /tmp/p.sock
    python -m pluss_torch.cli autotune --dry-run

- ``acc``: one timed run per backend of ``--backends`` (default
  ``vmap,shard,seq``: the engine's threads as rows of one batch, the
  sharded backend of :mod:`pluss_torch.parallel` over every card
  (``--shard-dispatch auto|steal|static``), and the engine one thread at
  a time); each prints the reference's block (timing banner, the three
  histogram dumps, "max iteration traversed").  Below each banner the
  blocks are line for line the ones ``python -m pluss.cli acc`` prints
  for the same model and backends.
- ``speed``: ``--reps`` timed runs per backend, a banner+seconds line each.
- ``mrc``: the AET miss-ratio curve of the first backend, written to
  ``--out``.
- ``sample``: subset sampling (:mod:`pluss_torch.sampling`) at each of
  ``--rates`` (``--sample-mode uniform|prefix``, ``--context`` warm-up
  windows, ``--window`` the sample span), against the full run: prints
  ``rate,walked_fraction,l2_error`` per rate, byte for byte what
  ``python -m pluss.cli sample`` prints.
- ``trace``: replay a raw address trace (``--file``, ``--fmt u64|text``)
  through the degradation ladder,
  :func:`pluss_torch.resilience.replay_file_resilient`
  (``--resident-cache`` rides the residency store; the rungs taken, if
  any, go to stderr); prints the banner, the reuse histogram and ``N
  refs over L lines; wrote MRC to <out>``, and writes the MRC to
  ``--out``.  ``--backends shard`` (explicit and alone) replays it
  sharded (:func:`pluss_torch.trace.shard_replay_file`, with
  ``--shard-dispatch`` and the ``--journal``/``--resume`` checkpoint; a
  text trace, or any trace in a ``torch.distributed`` process group,
  through :func:`pluss_torch.trace.shard_replay`).  Below the
  banner the block and the CSV are byte for byte those of ``python -m
  pluss.cli trace``.
- ``stats <events.jsonl>``: aggregate a telemetry stream (``--check``
  validates it instead, ``--trace RID`` renders one request's spans,
  ``--follow`` tails a growing stream): host code only, no card, and
  byte for byte what ``python -m pluss.cli stats`` prints.

- ``lint`` / ``analyze`` (``--model``/``--n`` or ``--all``; ``--json``,
  ``--sarif PATH``): the static analyzer (:mod:`pluss_torch.analysis`);
  ``analyze`` adds the schedule-aware passes, the footprint and MRC
  bracket, the static prediction, the cache-hierarchy read-offs
  (``--cache-kb``/``--cache-levels``/``--assoc``) and the dependence
  vectors.
- ``predict <model>|--all``: the sampling-free static MRC
  (:mod:`pluss_torch.analysis.ri`); ``--check`` runs the engine on every
  derivable model and requires bit-identical histograms.
- ``cotenancy a+b[+...]``: the co-tenancy composition
  (:mod:`pluss_torch.analysis.interference`); ``--check`` holds it against
  the host stack-distance oracle.
- ``tune <model>|--all``: the static schedule search
  (:mod:`pluss_torch.analysis.tune`) over ``--sweep-threads`` x
  ``--sweep-chunks``; ``--check`` runs the winner on the engine.
- ``tune <model> --transforms``: the same search over every proven-legal
  transform of the model (:mod:`pluss_torch.analysis.transform`); the best
  (transform, schedule) pair with its static MRC delta against the
  untransformed winner.
- ``spec dump <model>`` / ``spec load <file.json> [--run]``: the spec
  codec; ``--run`` prints the ``acc`` block of the loaded spec.
- ``import <file.py|file.c>``: derive specs from DSL or pragma-C source
  (:mod:`pluss_torch.frontend`) through the analyzer gate (``--verify``:
  the schedule-aware one); ``--json`` prints them, ``--register`` writes
  them to ``--registry-dir`` (``PLUSS_SPEC_DIR`` serves that directory
  as models), ``--predict`` prints their static predictions, ``--run``
  their ``acc`` blocks, and ``--check-model M`` requires the histograms
  and the MRC byte-identical to the registry model ``M`` at ``--n``.
- ``transform <model>`` with exactly one of ``--interchange A,B``,
  ``--tile L:S,...`` or ``--fuse A+B``: the legality proof (PL951 legal,
  PL952 illegal with the violating pair, PL953 refused) and the
  transformed spec (``--json``, ``--sarif``, ``--register``);
  ``--check`` runs the transformed spec on the engine against its
  static prediction.
- ``sweep``: the predicted miss ratios of ``--model`` under every
  (``--sweep-threads`` x ``--sweep-chunks``) schedule at
  ``--cache-lines`` (:mod:`pluss_torch.sweep`; ``--resume``/``--journal``
  journal the points and skip finished ones), then the report blocks:
  byte for byte what ``python -m pluss.cli sweep`` prints.
- ``serve`` (``--socket PATH`` or ``--port N``): the multi-tenant
  prediction daemon (:mod:`pluss_torch.serve`), with JAX's flags
  (``--warm``, ``--journal-dir``/``--recover``, ``--metrics-port``,
  ``--flight-dir``, ``--drain-timeout-s``, ``--heartbeat-dir`` ...).
- ``autotune``: calibrate the streamed replay's batch geometry on the
  device and persist it beside the plan cache
  (:mod:`pluss_torch.autotune`; ``--force``, ``--refs``); ``--dry-run``
  only validates the persisted sidecar.
- ``--verify`` on ``acc``/``speed``/``mrc``/``sample``: the
  schedule-aware analysis first; an ERROR stops the run (exit 2).

Below the banner, every block, JSON document and SARIF file of these modes
is byte for byte what ``python -m pluss.cli`` prints for the same flags.
They are host work: only ``predict --check``, ``tune --check``, ``spec
load --run``, ``import --run|--check-model`` and ``transform --check``
touch a device, the CUDA card unless ``--cpu`` is given.

``--telemetry PATH`` (or ``PLUSS_TELEMETRY``) writes the run's spans,
counters, gauges and events to PATH as JSONL
(:mod:`pluss_torch.obs`).

The timed region of ``acc``/``speed`` is the reference's: sampler + CRI
distribute (…omp.cpp:337-339), after one untimed warm-up run that builds
the kernels and initializes the device; ``trace`` times the one replay.
Runs go to the CUDA card; ``--cpu`` is the only way onto the host, and
with no card and no ``--cpu`` the CLI stops.
"""

from __future__ import annotations

import argparse
import os
import resource
import sys
import time

import torch

from pluss_torch import analysis, cri, engine, mrc, obs, sampling, trace
from pluss_torch.config import SHARE_CAP, SamplerConfig
from pluss_torch.io import RI_TITLE, acc_block, print_histogram, speed_block
from pluss_torch.models import REGISTRY


#: the sampler backends of ``acc``/``speed``/``mrc`` (the JAX CLI's)
BACKENDS = ("vmap", "shard", "seq")


def sampler_step(spec, cfg: SamplerConfig, device, window=None,
                 start_point=None, backend: str = "vmap", dispatch=None):
    """() -> (result, rihist): one sampler run of ``backend`` plus the CRI
    post-pass; ``shard`` runs over every card (on the CPU, one worker)."""
    if backend == "shard":
        from pluss_torch.parallel.shard import default_devices, shard_run

        devices = default_devices(device=device)
        run_once = lambda: shard_run(spec, cfg, devices=devices,
                                     window_accesses=window,
                                     start_point=start_point,
                                     dispatch=dispatch)
    else:
        run_once = lambda: engine.run(spec, cfg, device=device,
                                      window_accesses=window,
                                      start_point=start_point,
                                      backend=backend)

    def step():
        res = run_once()
        ri = cri.distribute(res.noshare_list(), res.share_list(),
                            cfg.thread_num)
        return res, ri

    return step


def timed(step):
    """Seconds of one step (the run ends in a copy to the host, which waits
    for the device) plus its result."""
    t0 = time.perf_counter()
    res, ri = step()
    return time.perf_counter() - t0, res, ri


def banner_of(device, backend: str = "vmap") -> str:
    base = "TORCH CUDA" if device.type == "cuda" else "TORCH CPU"
    return base if backend == "vmap" else f"{base} {backend.upper()}"


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="pluss_torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("mode", choices=("acc", "speed", "mrc", "sample", "trace",
                                    "stats", "lint", "analyze", "predict",
                                    "cotenancy", "tune", "transform",
                                    "import", "spec", "sweep", "serve",
                                    "autotune"))
    p.add_argument("target", nargs="?", default=None,
                   help="stats mode: the telemetry event stream "
                        "(events.jsonl) to aggregate; import mode: the .py "
                        "(DSL) or .c (pragma-C) source file; spec mode: "
                        "dump | load; predict/tune/transform mode: the "
                        "model; cotenancy mode: the co-scheduled workloads "
                        "as modelA+modelB[+...]")
    p.add_argument("arg2", nargs="?", default=None,
                   help="spec mode: the model to dump / the spec JSON "
                        "file to load")
    p.add_argument("--check", action="store_true",
                   help="stats mode: validate the event stream against "
                        "the telemetry schema instead of rendering it "
                        "(exit 1 on any violation); predict/tune/transform "
                        "mode: run the engine and require bit-identical "
                        "histograms; cotenancy mode: hold the composition "
                        "against the host oracle")
    p.add_argument("--all", action="store_true",
                   help="lint/analyze/predict/tune mode: every registered "
                        "model (lint/analyze at each builder's default "
                        "size) instead of --model")
    p.add_argument("--json", action="store_true",
                   help="lint/analyze/predict/cotenancy/tune mode: "
                        "machine-readable output")
    p.add_argument("--sarif", metavar="PATH", default=None,
                   help="lint/analyze/predict/cotenancy/tune mode: also "
                        "write the PLxxx findings as a SARIF 2.1.0 log")
    p.add_argument("--verify", action="store_true",
                   help="acc/speed/mrc/sample mode: run the "
                        "schedule-aware static analyzer first; ERROR "
                        "diagnostics stop the run")
    p.add_argument("--run", action="store_true",
                   help="import / spec load mode: run the spec(s) on the "
                        "engine and print the acc block")
    p.add_argument("--check-model", default=None, metavar="MODEL",
                   help="import mode: also run the registry MODEL (at --n) "
                        "and require histogram + MRC byte-identical to the "
                        "imported spec's run (exit 1 on divergence)")
    p.add_argument("--predict", action="store_true",
                   help="import mode: the static MRC prediction of each "
                        "imported spec (host work)")
    p.add_argument("--register", action="store_true",
                   help="import/transform mode: write each derived spec as "
                        "codec JSON into --registry-dir; PLUSS_SPEC_DIR "
                        "pointed there makes them registry models")
    p.add_argument("--registry-dir", default=".pluss_registry",
                   metavar="DIR",
                   help="import/transform --register target directory "
                        "(default .pluss_registry)")
    p.add_argument("--interchange", metavar="A,B", default=None,
                   help="transform mode: interchange band levels A and B "
                        "of nest 0 (e.g. 0,2)")
    p.add_argument("--tile", metavar="L:S,...", default=None,
                   help="transform mode: tile loop level L with size S (a "
                        "comma list tiles a contiguous band; each size "
                        "must divide its trip; e.g. 0:8,1:8,2:8)")
    p.add_argument("--fuse", metavar="A+B", default=None,
                   help="transform mode: fuse adjacent top-level nests A "
                        "and B (e.g. 0+1)")
    p.add_argument("--transforms", action="store_true",
                   help="tune mode: search the legal transform space too "
                        "and report the best transformed schedule with its "
                        "static MRC delta against the untransformed winner")
    p.add_argument("--cache-kb", type=int, default=None, metavar="KB",
                   help="analyze/cotenancy/tune mode: largest-cache "
                        "capacity in KB (default: the SamplerConfig "
                        "cache_kb)")
    p.add_argument("--cache-levels", default=None, metavar="KB:KB:...",
                   help="analyze/cotenancy/tune mode: declared cache "
                        "levels in KB, ascending; the last is the LLC.  "
                        "Excludes --cache-kb")
    p.add_argument("--assoc", type=int, default=None, metavar="WAYS",
                   help="analyze/cotenancy/tune mode: ways per set (0 = "
                        "fully associative; overrides PLUSS_CACHE_ASSOC)")
    p.add_argument("--sweep-threads", default="1,2,4,8",
                   help="sweep/tune mode: thread counts (comma list)")
    p.add_argument("--sweep-chunks", default="1,4,16",
                   help="sweep/tune mode: chunk sizes (comma list)")
    p.add_argument("--cache-lines", default="512,4096,40960",
                   help="sweep mode: cache sizes (lines) for the table")
    p.add_argument("--backends", default=None,
                   help="acc/speed/mrc mode: comma list of "
                        + ",".join(BACKENDS) + " (default: all three); "
                        "trace mode: exactly 'shard' replays sharded")
    p.add_argument("--shard-dispatch", default=None,
                   choices=("auto", "steal", "static"),
                   help="shard backend and sharded trace replay: chunk "
                        "dispatch mode, steal (work-stealing worker "
                        "threads; the single-process default for long "
                        "runs), static (one segment per device and one "
                        "exchange; the multi-process mode) or auto "
                        "(PLUSS_SHARD_DISPATCH).  Bit-identical either way")
    p.add_argument("--device-groups", type=int, default=None,
                   help="sweep mode: split the devices into this many "
                        "groups and run one sweep point per group (a "
                        "group of several devices runs its point "
                        "sharded; on one card the groups clamp to one); "
                        "default serial")
    p.add_argument("--share-cap", type=int, default=SHARE_CAP,
                   help="sweep mode: the JAX package's share cap, kept as "
                        "a label (the port's engine has no cap)")
    p.add_argument("--trace", default=None, metavar="RID",
                   help="stats mode: render the causal span tree of ONE "
                        "request (every span/event stamped trace=RID) "
                        "instead of the aggregate rollup")
    p.add_argument("--follow", action="store_true",
                   help="stats mode: live-tail a growing event stream, "
                        "rendering records as they land (stops at the "
                        "stream's end record or Ctrl-C)")
    p.add_argument("--telemetry", metavar="PATH", default=None,
                   help="write a structured telemetry event stream "
                        "(spans/counters/gauges as JSONL) to PATH; "
                        "equivalently set PLUSS_TELEMETRY.  Aggregate "
                        "with `python -m pluss_torch.cli stats PATH`")
    p.add_argument("--model", default="gemm", choices=sorted(REGISTRY))
    p.add_argument("--n", type=int, default=128, help="problem size")
    p.add_argument("--threads", type=int, default=4, help="simulated threads")
    p.add_argument("--chunk", type=int, default=4, help="schedule chunk size")
    p.add_argument("--window", type=int, default=None,
                   help="accesses per window per thread (trace mode: per "
                        "window of a device batch)")
    p.add_argument("--reps", type=int, default=3, help="speed-mode repetitions")
    p.add_argument("--start-point", type=int, default=None,
                   help="resume sampling from this parallel-loop iteration "
                        "value (the reference's setStartPoint)")
    p.add_argument("--rates", default="0.05,0.1,0.25,0.5,1.0",
                   help="sample-mode sampling rates (comma list)")
    p.add_argument("--sample-mode", default="uniform",
                   choices=("uniform", "prefix"),
                   help="sample-mode estimator: uniform random windows with "
                        "warm-up context, or the prefix chain")
    p.add_argument("--context", type=int, default=None,
                   help="sample-mode warm-up context windows (default: "
                        "sized to the largest share span)")
    p.add_argument("--out", default="mrc.csv",
                   help="mrc/trace-mode MRC output file")
    p.add_argument("--file", help="trace-mode input file of raw addresses")
    p.add_argument("--fmt", default="u64", choices=("u64", "text"),
                   help="trace file format (packed LE uint64 | text)")
    p.add_argument("--batch-windows", type=int, default=None,
                   help="trace mode: windows per device batch (default 16)")
    p.add_argument("--feed-workers", type=int, default=None,
                   help="trace mode: reader/encoder threads (default: most "
                        "host cores on the card, 1 on the CPU)")
    p.add_argument("--wire", default=None, choices=trace.WIRE_CHOICES,
                   help="trace mode: host-to-device encoding (default auto: "
                        "d24v on the card, pack on the CPU)")
    p.add_argument("--journal", default=None,
                   help="trace mode: checkpoint path (default "
                        "<file>.ckpt.npz with --resume); sweep mode: the "
                        "journal path (default .pluss_sweep_<model>_<n>"
                        ".jsonl with --resume)")
    p.add_argument("--resident-cache", default=None,
                   action=argparse.BooleanOptionalAction,
                   help="trace mode: keep the staged trace resident in "
                        "device memory (the residency store), so a repeat "
                        "replay in this process skips the host feed; "
                        "--no-resident-cache forces the plain streamed "
                        "path (the default for a one-shot replay)")
    p.add_argument("--resume", action="store_true",
                   help="trace mode: checkpoint while replaying and resume "
                        "from an existing checkpoint; sweep mode: journal "
                        "every finished point and skip points already "
                        "journaled")
    p.add_argument("--socket", default=None, metavar="PATH",
                   help="serve mode: unix socket path to listen on")
    p.add_argument("--port", type=int, default=None,
                   help="serve mode: TCP port to listen on (0 = ephemeral; "
                        "bound address printed on stderr)")
    p.add_argument("--host", default="127.0.0.1",
                   help="serve mode: TCP bind host (default 127.0.0.1)")
    p.add_argument("--max-queue", type=int, default=128,
                   help="serve mode: admission bound; requests past this "
                        "queue depth are shed with a typed Overloaded error")
    p.add_argument("--max-batch", type=int, default=16,
                   help="serve mode: most requests one shared dispatch "
                        "may coalesce (1 disables batching)")
    p.add_argument("--max-delay-ms", type=float, default=10.0,
                   help="serve mode: adaptive batch window, the longest "
                        "a request waits for compatible stragglers")
    p.add_argument("--default-deadline-ms", type=float, default=None,
                   help="serve mode: default per-request deadline for "
                        "requests that do not carry deadline_ms")
    p.add_argument("--heartbeat-dir", default=None, metavar="DIR",
                   help="serve mode: export the multihost heartbeat-age "
                        "gauges of the workers beating into DIR")
    p.add_argument("--num-processes", type=int, default=None,
                   help="serve mode: worker count watched under "
                        "--heartbeat-dir")
    p.add_argument("--prom-refresh-s", type=float, default=5.0,
                   help="serve mode: SLO gauge + prometheus textfile "
                        "(PLUSS_PROM) refresh period")
    p.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                   help="serve mode: live prometheus pull endpoint (GET "
                        "/metrics) on this localhost port (0 = ephemeral)")
    p.add_argument("--flight-dir", default=None, metavar="DIR",
                   help="serve mode: directory for crash flight-recorder "
                        "dumps (also PLUSS_FLIGHT_DIR; default cwd)")
    p.add_argument("--warm", default=None, metavar="MODELS",
                   help="serve mode: precompile these at daemon start "
                        "(comma-separated name[:n[:threads[:chunk]]] "
                        "entries, trace paths, or 'all')")
    p.add_argument("--journal-dir", default=None, metavar="DIR",
                   help="serve mode: crash-safe request journal directory "
                        "(also PLUSS_SERVE_JOURNAL)")
    p.add_argument("--recover", default=None, metavar="DIR",
                   help="serve mode: recover from the request journal in "
                        "DIR at startup (implies --journal-dir DIR)")
    p.add_argument("--drain-timeout-s", type=float, default=60.0,
                   help="serve mode: hard bound on shutdown drain; past "
                        "it, pending requests are answered typed retryable")
    p.add_argument("--force", action="store_true",
                   help="autotune mode: recalibrate even when a valid "
                        "geometry sidecar is persisted for this runtime")
    p.add_argument("--dry-run", action="store_true",
                   help="autotune mode: validate the persisted sidecar "
                        "and print the tuned geometry without calibrating "
                        "(exit 1 only when a sidecar fails validation)")
    p.add_argument("--refs", type=int, default=None,
                   help="autotune mode: calibration replay length in "
                        "references (default 2^20)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the host CPU instead of the CUDA card")
    args = p.parse_args(argv)

    if args.target is not None and args.mode not in (
            "stats", "import", "spec", "predict", "cotenancy", "tune",
            "transform"):
        # a stray positional stays a usage error (`lint gemm` would
        # otherwise lint the default model and report it clean)
        p.error(f"unexpected argument {args.target!r} for mode "
                f"{args.mode!r} (positional input is for stats/import/"
                "spec/predict/cotenancy/tune/transform modes only; use "
                "--model/--file)")
    if args.arg2 is not None and args.mode != "spec":
        p.error(f"unexpected argument {args.arg2!r} for mode "
                f"{args.mode!r}")
    if args.mode == "stats":
        # host aggregation of a recorded stream: no device, and no
        # telemetry session of its own
        from pluss_torch.obs import stats as stats_mod

        if not args.target:
            p.error("stats mode requires an events.jsonl path")
        if args.check and (args.trace or args.follow):
            p.error("stats --check excludes --trace/--follow")
        return stats_mod.main(args.target, sys.stdout, sys.stderr,
                              check=args.check, trace=args.trace,
                              follow_stream=args.follow)
    if args.telemetry:
        obs.configure(args.telemetry)

    def device_of() -> torch.device:
        """The device of the mode's engine runs: resolved only where one
        runs, so the host modes need no card."""
        try:
            return engine.resolve_device("cpu" if args.cpu else None)
        except RuntimeError as e:
            p.error(str(e))

    try:
        if args.mode in HOST_MODES:
            return HOST_MODES[args.mode](args, p, sys.stdout)
        if args.mode in CHECK_MODES:
            return CHECK_MODES[args.mode](args, p, sys.stdout, device_of)
        if args.mode == "autotune":
            return _autotune_main(args, p, sys.stdout, device_of)
        if args.mode == "serve":
            return _serve_main(args, p, device_of)
        device = device_of()
        cfg = SamplerConfig(thread_num=args.threads, chunk_size=args.chunk)
        return run_mode(args, p, cfg, device, sys.stdout)
    finally:
        # counters land in the stream even when the process lives on
        # (the session itself closes at exit, or at the next configure)
        obs.flush_metrics()


def run_mode(args, p, cfg: SamplerConfig, device, out) -> int:
    """The run modes (every mode but ``stats``)."""
    if args.mode == "trace":
        return trace_mode(args, p, cfg, device, out)
    spec = REGISTRY[args.model](args.n)
    if args.mode == "sweep":
        return sweep_mode(args, spec, cfg, device, out)
    if args.verify:
        n_err = _verify_spec(spec, cfg, sys.stderr)
        if n_err:
            print(f"pluss_torch: --verify found {n_err} error(s) in "
                  f"{spec.name}; refusing to run", file=sys.stderr)
            return 2
    if args.mode == "sample":
        return sample_mode(args, spec, cfg, device, out)
    backends = _backends(args, p)

    def step_of(b):
        return sampler_step(spec, cfg, device, args.window, args.start_point,
                            b, args.shard_dispatch)

    if args.mode == "acc":
        for b in backends:
            step = step_of(b)
            step()  # warm-up: kernel build and device start-up stay untimed
            dt, res, ri = timed(step)
            acc_block(banner_of(device, b), dt, res.noshare_list(),
                      res.share_list(), ri, res.max_iteration_count, out)
    elif args.mode == "speed":
        for b in backends:
            step = step_of(b)
            step()
            speed_block(banner_of(device, b),
                        [timed(step)[0] for _ in range(args.reps)], out)
    else:
        _, _, ri = timed(step_of(backends[0]))
        curve = mrc.aet_mrc(ri, cfg)
        mrc.write_mrc(args.out, curve)
        out.write(f"wrote {len(mrc.dedup_lines(curve))} MRC lines to "
                  f"{args.out} (curve over {len(curve)} cache sizes)\n")
    return 0


def _backends(args, p) -> list[str]:
    """``--backends`` as a list (default all three), each one known."""
    backends = [b.strip() for b in (args.backends or ",".join(BACKENDS))
                .split(",") if b.strip()]
    for b in backends:
        if b not in BACKENDS:
            p.error(f"unknown backend {b!r}")
    return backends


def sample_mode(args, spec, cfg: SamplerConfig, device, out) -> int:
    """The sampled-MRC error table: each rate's walked fraction and MRC L2
    error against the full run."""
    rates = [float(x) for x in args.rates.split(",") if x]
    if args.sample_mode == "prefix" and args.context is not None:
        print("pluss_torch: --context is ignored in prefix mode (the chain "
              "is its own context)", file=sys.stderr)
    tbl = sampling.mrc_error_table(spec, cfg, rates,
                                   window_accesses=args.window,
                                   context_windows=args.context,
                                   mode=args.sample_mode, device=device)
    out.write(f"{spec.name}: sampled-MRC L2 error vs full enumeration\n")
    out.write("rate,walked_fraction,l2_error\n")
    for rate, frac, err in tbl:
        out.write(f"{rate:g},{frac:.6g},{err:.6g}\n")
    return 0


def sweep_mode(args, spec, cfg: SamplerConfig, device, out) -> int:
    """Predicted MRCs across parallel schedules (:mod:`pluss_torch.sweep`):
    the table, then the report blocks, byte for byte what ``python -m
    pluss.cli sweep`` prints."""
    from pluss_torch import sweep as sweep_mod

    ts = [int(x) for x in args.sweep_threads.split(",") if x]
    cks = [int(x) for x in args.sweep_chunks.split(",") if x]
    cls_ = [int(x) for x in args.cache_lines.split(",") if x]
    journal = args.journal
    if journal is None and args.resume:
        journal = f".pluss_sweep_{args.model}_{args.n}.jsonl"
    if args.resume:
        print(f"pluss_torch: sweep journal at {journal} (resume on)",
              file=sys.stderr)
    if args.device_groups is not None and args.device_groups > 1:
        print(f"pluss_torch: sweep across {args.device_groups} device "
              "group(s), one point per group (elastic requeue on worker "
              "death)", file=sys.stderr)
    pts = sweep_mod.sweep(spec, ts, cks, cfg, args.share_cap,
                          journal=journal, resume=args.resume,
                          device_groups=args.device_groups, device=device)
    out.write(f"{spec.name}: predicted miss ratios\n")
    out.write(sweep_mod.table(pts, cls_) + "\n")
    for block in (sweep_mod.carried_levels(spec),
                  sweep_mod.schedule_analysis(spec, pts),
                  sweep_mod.prediction_block(spec, pts),
                  sweep_mod.hierarchy_block(spec, pts),
                  sweep_mod.tuned_block(spec, pts),
                  sweep_mod.transform_block(spec, pts)):
        if block:
            out.write(block + "\n")
    return 0


def _autotune_main(args, p, out, device_of) -> int:
    """``autotune [--force] [--dry-run] [--refs N]``: calibrate and persist
    the streamed replay's batch geometry for the device's runtime
    (:mod:`pluss_torch.autotune`), or with ``--dry-run`` only validate the
    persisted sidecar.  The winner feeds ``replay_file``'s defaults on
    every later run on that device (``autotune.hit`` witnesses it)."""
    from pluss_torch import autotune

    if args.force and args.dry_run:
        p.error("autotune mode: --force and --dry-run are exclusive "
                "(--dry-run never calibrates)")
    device = device_of()
    if args.dry_run:
        return autotune.dry_run(out, device=device)
    kw = {} if args.refs is None else {"n_refs": args.refs}
    doc = autotune.calibrate(force=args.force, out=sys.stderr,
                             device=device, **kw)
    geo = doc["geometry"]
    out.write("pluss autotune: winner "
              + "  ".join(f"{k}={geo[k]}" for k in sorted(geo))
              + f"  ({doc.get('refs_per_sec', 0):.0f} refs/s)\n")
    return 0


def _serve_main(args, p, device_of) -> int:
    """``serve --socket PATH | --port N``: the long-lived multi-tenant
    prediction daemon (:mod:`pluss_torch.serve`) on the card, or on the
    host with ``--cpu``; SIGTERM or a ``{"op": "shutdown"}`` line drains
    and stops it."""
    from pluss_torch.resilience.errors import PlussError
    from pluss_torch.serve import ServeConfig, Server

    if (args.socket is None) == (args.port is None):
        p.error("serve mode requires exactly one of --socket/--port")
    device = device_of()
    scfg = ServeConfig(
        max_queue=args.max_queue,
        max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms,
        default_deadline_ms=args.default_deadline_ms,
        prom_refresh_s=args.prom_refresh_s,
        heartbeat_dir=args.heartbeat_dir,
        num_processes=args.num_processes,
        warm=args.warm,
        journal_dir=args.recover or args.journal_dir,
        drain_timeout_s=args.drain_timeout_s,
        metrics_port=args.metrics_port,
        flight_dir=args.flight_dir,
        device=device,
    )
    try:
        server = Server(socket_path=args.socket, port=args.port,
                        host=args.host, config=scfg)
    except PlussError as e:
        print(f"pluss_torch serve: {e}", file=sys.stderr)
        return 2
    try:
        server.start()
    except OSError as e:
        print(f"pluss_torch serve: cannot bind {args.socket or args.port}: "
              f"{e}", file=sys.stderr)
        return 2
    print(f"pluss_torch serve: listening on {server.address} "
          f"(device={device}, max_queue={scfg.max_queue}, "
          f"max_batch={scfg.max_batch}, "
          f"max_delay_ms={scfg.max_delay_ms:g}); SIGTERM or a "
          '{"op": "shutdown"} line drains and stops', file=sys.stderr,
          flush=True)
    if server.metrics_port is not None:
        print(f"pluss_torch serve: metrics on "
              f"http://127.0.0.1:{server.metrics_port}/metrics",
              file=sys.stderr, flush=True)
    server.serve_forever()
    print("pluss_torch serve: drained and stopped", file=sys.stderr)
    return 0


def trace_mode(args, p, cfg: SamplerConfig, device, out) -> int:
    """Replay ``--file`` and print the trace block (single-clock: no CRI
    dilation, the reuse histogram feeds the AET curve directly)."""
    if not args.file:
        p.error("trace mode requires --file")
    if args.backends is not None:
        backends = _backends(args, p)
        if backends == ["shard"]:
            return shard_trace_mode(args, cfg, device, out)
        print(f"pluss_torch: trace mode ignores --backends "
              f"{','.join(backends)}; it streams on one device unless "
              "--backends is exactly 'shard' (sharded replay)",
              file=sys.stderr)
    # --journal alone arms checkpoint writing; --resume also loads one
    ckpt = None
    if args.resume or args.journal:
        ckpt = args.journal or (args.file + ".ckpt.npz")
        print(f"pluss_torch: trace checkpoint at {ckpt} "
              f"(resume {'on' if args.resume else 'off'})", file=sys.stderr)
    from pluss_torch.resilience import replay_file_resilient
    from pluss_torch.resilience.ladder import TRACE_LADDER

    # on the card the ladder stops before its CPU rung: the banner and the
    # timing below are the card's, never a host replay's
    rungs = TRACE_LADDER if device.type == "cpu" else tuple(
        r for r in TRACE_LADDER if r != "cpu_fallback")
    t0 = time.perf_counter()
    rep = replay_file_resilient(args.file, args.fmt, rungs=rungs,
                                cls=cfg.cls, window=args.window,
                                checkpoint_path=ckpt,
                                resume=args.resume,
                                batch_windows=args.batch_windows,
                                feed_workers=args.feed_workers,
                                wire=args.wire,
                                resident_cache=args.resident_cache,
                                device=device)
    dt = time.perf_counter() - t0
    # stderr: the stdout block is held byte for byte against the JAX CLI's
    if rep.degradations:
        print("pluss_torch: trace replay degraded: "
              + ",".join(rep.degradations), file=sys.stderr)
    tm = rep.timing
    peak = f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB" \
        if device.type == "cuda" else "n/a"
    print(f"pluss_torch: replayed {rep.total_count} refs in {dt:.3f} s "
          f"({rep.total_count / dt:.4g} refs/s); feed stall "
          f"{tm.get('prefetch_stall_s', 0.0):.3f} s, staging "
          f"{tm.get('h2d_s', 0.0):.3f} s, device "
          f"{tm.get('device_s', 0.0):.3f} s; feed stages (summed over "
          f"workers) read {tm.get('read_s', 0.0):.3f} s, compact "
          f"{tm.get('compact_s', 0.0):.3f} s, encode "
          f"{tm.get('encode_s', 0.0):.3f} s; wire {rep.wire}, "
          f"{rep.feed_workers} feed workers; resident cache "
          f"{tm.get('resident', 'off')}; peak device memory {peak}; "
          f"peak host RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.3f}"
          f" GiB", file=sys.stderr)
    return _trace_block(rep, dt, cfg, device, args.out, out)


def _trace_block(rep, dt: float, cfg: SamplerConfig, device, path: str,
                 out) -> int:
    """The trace block (banner, reuse histogram, refs line) of a replay,
    and its MRC written to ``path``."""
    out.write(f"{banner_of(device)} TRACE: {dt:0.6f}\n")
    print_histogram(RI_TITLE, rep.histogram(), out)
    mrc.write_mrc(path, mrc.aet_mrc(rep.histogram(), cfg))
    out.write(f"{rep.total_count} refs over {rep.n_lines} lines; "
              f"wrote MRC to {path}\n")
    return 0


def shard_trace_mode(args, cfg: SamplerConfig, device, out) -> int:
    """``trace --backends shard``: the sharded replay over every card (one
    worker on the CPU), with the JAX CLI's notices and block.  In an
    initialized ``torch.distributed`` process group each rank replays on
    its own device (:func:`pluss_torch.parallel.multihost.global_devices`)
    and a u64 trace goes through the in-memory :func:`trace.shard_replay`
    (every rank compacts the whole trace the same way); every rank prints
    the block."""
    from pluss_torch.parallel.multihost import global_devices
    from pluss_torch.parallel.shard import default_devices, group_size

    in_group = group_size() > 1
    devices = global_devices(device) if in_group \
        else default_devices(device=device)
    win = args.window or trace.TRACE_WINDOW
    if args.feed_workers is not None or args.wire is not None:
        print("pluss_torch: --feed-workers/--wire have no effect on the "
              "sharded replay", file=sys.stderr)
    t0 = time.perf_counter()
    if args.fmt == "u64" and in_group:
        if args.resume or args.journal:
            print("pluss_torch: --resume/--journal have no effect on "
                  "multi-process sharded replay", file=sys.stderr)
        if args.batch_windows is not None:
            print("pluss_torch: --batch-windows has no effect on the "
                  "in-memory sharded replay", file=sys.stderr)
        rep = trace.shard_replay(trace.load_trace(args.file, args.fmt),
                                 cls=cfg.cls, devices=devices, window=win)
    elif args.fmt == "u64":
        ckpt = None
        if args.resume or args.journal:
            ckpt = args.journal or (args.file + ".shard.ckpt")
            print(f"pluss_torch: shard-trace checkpoint at {ckpt} "
                  f"(resume {'on' if args.resume else 'off'})",
                  file=sys.stderr)
        rep = trace.shard_replay_file(
            args.file, cls=cfg.cls, devices=devices, window=win,
            batch_windows=args.batch_windows, checkpoint_path=ckpt,
            resume=args.resume, dispatch=args.shard_dispatch,
            resident_cache=args.resident_cache)
    else:
        if args.resume or args.journal:
            print("pluss_torch: --resume/--journal have no effect on "
                  f"sharded {args.fmt} traces (checkpointing is u64-only)",
                  file=sys.stderr)
        if args.batch_windows is not None:
            print("pluss_torch: --batch-windows has no effect on the "
                  "in-memory sharded replay", file=sys.stderr)
        rep = trace.shard_replay(trace.load_trace(args.file, args.fmt),
                                 cls=cfg.cls, devices=devices, window=win)
    return _trace_block(rep, time.perf_counter() - t0, cfg, device,
                        args.out, out)


# --- the static analysis modes (host work; engine runs only under --check
# and spec load --run) -------------------------------------------------------


def _footprint_doc(fp, bracket) -> dict:
    """JSON view of one model's footprint/MRC-bound report."""
    return {
        "total_lines": fp.total,
        "per_array": {a: int(n) for a, n in zip(fp.arrays, fp.per_array)},
        "per_thread_cold": [int(c) for c in fp.cold],
        "accesses": fp.accesses,
        "mrc_floor": bracket.floor,
        "mrc_plateau_bounds": [bracket.c_lo, bracket.c_hi],
        "guaranteed_reuse": bracket.guaranteed_reuse,
        "levels": [
            {"nest": lv.nest, "path": lv.path, "depth": lv.depth,
             "lines_lo": lv.lines_lo, "lines_hi": lv.lines_hi}
            for lv in fp.levels
        ],
    }


def _cache_geometry_or_usage(args, p):
    """The shared cache-geometry parse of analyze/cotenancy/tune
    (:func:`pluss_torch.model.hierarchy.cache_geometry`); malformed flags
    are usage errors."""
    from pluss_torch.model import hierarchy as hier_mod

    try:
        return hier_mod.cache_geometry(args.cache_kb, args.cache_levels,
                                       args.assoc)
    except ValueError as e:
        p.error(f"{args.mode} mode: {e}")


def _write_sarif(path, diags, mode: str) -> None:
    from pluss_torch.analysis import sarif as sarif_mod

    sarif_mod.write_sarif(path, diags)
    print(f"pluss_torch {mode}: SARIF log at {path}", file=sys.stderr)


def _analysis_main(args, p, out) -> int:
    """``lint`` (schedule-blind) or ``analyze`` (under the CLI's own
    ``--threads``/``--chunk`` and the shared cache geometry)."""
    cfg = hier = None
    if args.mode == "analyze":
        llc_kb, hier = _cache_geometry_or_usage(args, p)
        cfg = SamplerConfig(thread_num=args.threads, chunk_size=args.chunk,
                            **({} if llc_kb is None
                               else {"cache_kb": llc_kb}))
    return _lint_main(args, out, cfg, hier)


def _lint_main(args, out, cfg: SamplerConfig | None = None,
               hier=None) -> int:
    """``lint|analyze <--model X|--all> [--json]``: exit 1 when any model
    has ERROR diagnostics.  ``analyze`` (``cfg`` set) adds the placement-
    refined race verdicts (PL304/PL305), false sharing (PL5xx), the
    footprint/MRC bracket, the static prediction, the hierarchy read-offs
    and the dependence vectors."""
    import json as json_mod

    from pluss_torch.analysis import depvec as depvec_mod
    from pluss_torch.analysis import ri
    from pluss_torch.model import hierarchy as hier_mod

    if args.all:
        # each builder's default size
        targets = [(name, REGISTRY[name]()) for name in sorted(REGISTRY)]
    else:
        targets = [(args.model, REGISTRY[args.model](args.n))]
    all_diags = []
    footprints: dict[str, dict] = {}
    predictions: dict[str, dict] = {}
    hierarchies: dict[str, dict] = {}
    depvectors: dict[str, dict] = {}
    errors = 0
    for name, spec in targets:
        if cfg is None:
            diags = analysis.lint_spec(spec)
        else:
            diags, fp = analysis.analyze_spec(spec, cfg)
            footprints[spec.name] = _footprint_doc(
                fp, analysis.footprint.mrc_bracket(spec, cfg, fp))
            vecs = depvec_mod.spec_vectors(spec)
            depvectors[spec.name] = depvec_mod.doc_of(vecs)
            diags = depvec_mod.annotate_races(diags, vecs)
            rep = ri.predict(spec, cfg)
            predictions[spec.name] = ri.report_doc(rep)
            diags = diags + rep.prediction.diagnostics
            if rep.rihist is not None:
                hierarchies[spec.name] = hier_mod.hierarchy_doc(
                    rep.rihist, cfg, hier)
        all_diags += analysis.with_model(diags, spec.name)
        errors += analysis.error_count(diags)
    mode = "lint" if cfg is None else "analyze"
    if args.sarif:
        _write_sarif(args.sarif, all_diags, mode)
    if args.json:
        doc = json_mod.loads(analysis.format_json(all_diags))
        if cfg is not None:
            doc["schedule"] = {"threads": cfg.thread_num,
                               "chunk": cfg.chunk_size,
                               "ds": cfg.ds, "cls": cfg.cls}
            doc["footprint"] = footprints
            doc["prediction"] = predictions
            doc["hierarchy"] = hierarchies
            doc["depvectors"] = depvectors
        out.write(json_mod.dumps(doc, indent=1) + "\n")
    else:
        text = analysis.format_text(all_diags)
        if text:
            out.write(text + "\n")
        for name, doc in footprints.items():
            out.write(
                f"{name}: footprint {doc['total_lines']} lines "
                f"({', '.join(f'{a}={n}' for a, n in doc['per_array'].items())}); "
                f"cold/thread {doc['per_thread_cold']}; MRC floor "
                f"{doc['mrc_floor']:.6g}, plateau in "
                f"[{doc['mrc_plateau_bounds'][0]}, "
                f"{doc['mrc_plateau_bounds'][1]}]\n")
            out.write(_prediction_line(name, predictions[name]))
            if name in hierarchies:
                for line in hier_mod.render_hierarchy(hierarchies[name],
                                                      indent="    "):
                    out.write(f"  {line}\n" if line == "hierarchy:"
                              else f"{line}\n")
            for line in depvec_mod.render(depvectors[name]):
                out.write(f"  {line}\n")
        n_warn = sum(1 for d in all_diags
                     if d.severity is analysis.Severity.WARNING)
        out.write(f"pluss {mode}: {len(targets)} model(s), {errors} "
                  f"error(s), {n_warn} warning(s)\n")
    return 1 if errors else 0


def _prediction_line(name: str, doc: dict) -> str:
    """One text-report line per model from a ``ri.report_doc`` dict."""
    if not doc["derivable"]:
        codes = ",".join(sorted({d["code"]
                                 for d in doc.get("diagnostics", ())}))
        return f"{name}: prediction not derivable ({codes})\n"
    where = "unreachable"
    if "mrc_plateau_exact" in doc:
        where = (f"{doc['mrc_plateau_exact']} "
                 + ("inside" if doc["plateau_in_bracket"] else "OUTSIDE")
                 + " the bracket")
    g = f", G={doc['period_horizon']}" if "period_horizon" in doc else ""
    return (f"{name}: prediction {doc['method']}{g}, {doc['accesses']} "
            f"accesses, exact plateau {where}\n")


def _model_target(args, p) -> None:
    """predict/tune: the positional model, or --all, not both."""
    if args.target is not None and args.all:
        p.error(f"{args.mode} mode: give a model or --all, not both")
    if args.target is not None:
        if args.target not in REGISTRY:
            p.error(f"{args.mode} mode: unknown model {args.target!r}")
        args.model = args.target


def _mrc_kind(detail: dict) -> str:
    return "bit-identical" if detail["mrc_exact"] \
        else f"l2={detail['mrc_l2_error']:.2e}"


def _predict_main(args, p, out, device_of) -> int:
    """``predict <model|--all> [--json|--check|--sarif]``: the static
    per-thread histograms through CRI + AET with no engine run.
    ``--check`` then runs the engine on every derivable model (the only
    device work here) and requires bit-identical histograms (MRC within
    ``ri.MRC_EPS``)."""
    import json as json_mod

    from pluss_torch.analysis import ri

    _model_target(args, p)
    cfg = SamplerConfig(thread_num=args.threads, chunk_size=args.chunk)
    if args.all:
        targets = [(nm, REGISTRY[nm](args.n)) for nm in sorted(REGISTRY)]
    else:
        targets = [(args.model, REGISTRY[args.model](args.n))]
    docs: dict[str, dict] = {}
    reports = []
    all_diags = []
    errors = 0
    for name, spec in targets:
        rep = ri.predict(spec, cfg)
        reports.append((name, spec, rep))
        docs[spec.name] = ri.report_doc(rep)
        all_diags += analysis.with_model(rep.prediction.diagnostics,
                                         spec.name)
        errors += analysis.error_count(rep.prediction.diagnostics)
    rc = 1 if errors else 0
    if args.check:
        device = device_of()
        for name, spec, rep in reports:
            if not rep.prediction.derivable:
                print(f"pluss_torch predict: {spec.name}: check skipped "
                      "(not derivable)", file=sys.stderr)
                continue
            res = engine.run(spec, cfg, device=device)
            ok, detail = ri.check_against_engine(rep, res, cfg)
            docs[spec.name]["check"] = detail
            if not ok:
                rc = 1
                print(f"pluss_torch predict: {spec.name}: CHECK FAILED "
                      f"{detail}", file=sys.stderr)
            else:
                print(f"pluss_torch predict: {spec.name}: histograms "
                      f"bit-identical to engine.run, MRC "
                      f"{_mrc_kind(detail)}", file=sys.stderr)
    if args.sarif:
        _write_sarif(args.sarif, all_diags, "predict")
    if args.json:
        doc = {"schedule": {"threads": cfg.thread_num,
                            "chunk": cfg.chunk_size,
                            "ds": cfg.ds, "cls": cfg.cls},
               "models": docs}
        out.write(json_mod.dumps(doc, indent=1) + "\n")
    else:
        for name, spec, rep in reports:
            out.write(_prediction_line(spec.name, docs[spec.name]))
        n_derived = sum(1 for _, _, r in reports
                        if r.prediction.derivable)
        out.write(f"pluss predict: {n_derived}/{len(reports)} model(s) "
                  f"derivable, {errors} error(s)\n")
    return rc


def _cotenancy_main(args, p, out) -> int:
    """``cotenancy <a+b[+...]> [--json|--sarif|--check]``: per-workload
    degraded MRCs off the merged stream's AET clock and PL801/PL802/PL803
    verdicts.  Host work end to end: ``--check``'s oracle is a numpy
    schedule simulation."""
    import json as json_mod

    from pluss_torch.analysis import interference

    if not args.target:
        p.error("cotenancy mode requires a modelA+modelB[+...] target")
    names = [t.strip() for t in args.target.split("+")]
    if any(not t for t in names):
        p.error(f"cotenancy mode: malformed target {args.target!r} "
                "(empty workload name)")
    unknown = [t for t in names if t not in REGISTRY]
    if unknown:
        p.error(f"cotenancy mode: unknown model(s) "
                f"{', '.join(map(repr, unknown))}")
    if len(names) < 2:
        p.error("cotenancy mode: co-tenancy needs >= 2 workloads "
                f"(got {args.target!r}; join them with '+')")
    llc_kb, _hier = _cache_geometry_or_usage(args, p)
    cfg = SamplerConfig(thread_num=args.threads, chunk_size=args.chunk,
                        **({} if llc_kb is None
                           else {"cache_kb": llc_kb}))
    inputs, refusals = interference.from_models(names, cfg, args.n)
    if len(inputs) < 2:
        rep = interference.CotenancyReport(
            tuple(names), cfg.cache_kb,
            interference.interference_threshold(), [], [], [], [], {},
            refusals)
    else:
        rep = interference.compose(inputs, cfg)
        rep.diagnostics = refusals + rep.diagnostics
    rc = 1 if len(inputs) < 2 else 0
    doc = rep.doc()
    if args.check and len(inputs) >= 2:
        ok, detail = interference.check_against_oracle(rep, inputs, cfg)
        doc["check"] = detail
        for wd in detail["per_workload"]:
            status = "ok" if wd["ok"] else "CHECK FAILED"
            print(f"pluss_torch cotenancy: {wd['workload']}: {status} "
                  f"(max|err| {wd['max_abs_err']:.3g}, mae "
                  f"{wd['mae']:.3g}, edge {wd['edge_err']:.3g}, solo "
                  f"max|err| {wd['solo_max_abs_err']:.3g})",
                  file=sys.stderr)
        if not ok:
            rc = 1
    elif args.check:
        print("pluss_torch cotenancy: check skipped (fewer than 2 "
              "composable workloads)", file=sys.stderr)
    if args.sarif:
        _write_sarif(args.sarif, rep.diagnostics, "cotenancy")
    if args.json:
        doc["schedule"] = {"threads": cfg.thread_num,
                           "chunk": cfg.chunk_size,
                           "ds": cfg.ds, "cls": cfg.cls}
        out.write(json_mod.dumps(doc, indent=1) + "\n")
    else:
        for d in rep.diagnostics:
            if d.code == "PL803":
                out.write(d.format() + "\n")
        for v in rep.verdicts:
            out.write(f"{v.name}: solo {v.solo_mr:.6g} -> degraded "
                      f"{v.degraded_mr:.6g} (+{v.inflation:.6g}) "
                      f"[{v.code}] share p={v.p:.4g}\n")
        n_sev = sum(1 for v in rep.verdicts if v.code == "PL801")
        n_ref = sum(1 for d in rep.diagnostics if d.code == "PL803")
        out.write(f"pluss cotenancy: {len(names)} workload(s) at "
                  f"{rep.cache_kb} KB, threshold {rep.threshold:g}: "
                  f"{n_sev} severe, {len(rep.verdicts) - n_sev} benign, "
                  f"{n_ref} refused\n")
    return rc


def _tune_main(args, p, out, device_of) -> int:
    """``tune <model|--all> [--json|--check|--sarif]``: the static search
    over (threads, chunk, window) from --sweep-threads/
    --sweep-chunks/--window, scored on the host at the declared LLC.
    Verdicts PL901 proven-best, PL902 tie, PL903 refusal (rc 1), PL904
    the ``--check`` alarm."""
    import json as json_mod

    from pluss_torch.analysis import tune as tune_mod

    _model_target(args, p)
    llc_kb, hier = _cache_geometry_or_usage(args, p)
    try:
        ts = [int(t) for t in args.sweep_threads.split(",")]
        cks = [int(c) for c in args.sweep_chunks.split(",")]
    except ValueError:
        p.error("tune mode: malformed --sweep-threads/--sweep-chunks "
                "(want comma-separated ints)")
    cands = tune_mod.space(ts, cks, (args.window,))
    if args.transforms:
        # (transform, schedule) pairs: one model at a time (the space is
        # per spec)
        if args.all:
            p.error("tune mode: --transforms wants a single model, "
                    "not --all")
        return _tune_transforms(args, out, device_of, cands, hier)
    if args.all:
        targets = [(nm, REGISTRY[nm](args.n)) for nm in sorted(REGISTRY)]
    else:
        targets = [(args.model, REGISTRY[args.model](args.n))]
    docs: dict[str, dict] = {}
    reports = []
    all_diags = []
    rc = 0
    for name, spec in targets:
        rep = tune_mod.tune(spec, candidates=cands, hier=hier)
        reports.append((name, spec, rep))
        docs[spec.name] = rep.doc()
        all_diags += analysis.with_model(rep.diagnostics, spec.name)
        if rep.code == "PL903":
            rc = 1
    if args.check:
        device = device_of()
        for name, spec, rep in reports:
            if rep.winner is None:
                print(f"pluss_torch tune: {spec.name}: check skipped "
                      "(refused)", file=sys.stderr)
                continue
            ok, detail, diags = tune_mod.check_winner(spec, rep,
                                                      device=device)
            docs[spec.name]["check"] = detail
            all_diags += analysis.with_model(diags, spec.name)
            if not ok:
                rc = 1
                print(f"pluss_torch tune: {spec.name}: CHECK FAILED "
                      f"(PL904) {detail}", file=sys.stderr)
            else:
                print(f"pluss_torch tune: {spec.name}: winner "
                      f"{rep.winner.candidate.label()} verified against "
                      f"engine.run (histograms bit-identical, MRC "
                      f"{_mrc_kind(detail)})", file=sys.stderr)
    if args.sarif:
        _write_sarif(args.sarif, all_diags, "tune")
    if args.json:
        doc = {"target_kb": reports[0][2].target_kb,
               "hierarchy": docs[reports[0][1].name]["hierarchy"],
               "models": docs}
        out.write(json_mod.dumps(doc, indent=1) + "\n")
    else:
        for name, spec, rep in reports:
            v = rep.diagnostics[0]
            out.write(f"{spec.name}: [{v.code}] {v.message}\n")
        n_best = sum(1 for _, _, r in reports if r.code == "PL901")
        n_tie = sum(1 for _, _, r in reports if r.code == "PL902")
        n_ref = sum(1 for _, _, r in reports if r.code == "PL903")
        out.write(f"pluss tune: {len(reports)} model(s) over "
                  f"{len(cands)} candidate(s) at "
                  f"{reports[0][2].target_kb} KB LLC: {n_best} "
                  f"proven-best, {n_tie} tie(s), {n_ref} refused\n")
    return rc


def _tune_transforms(args, out, device_of, cands, hier) -> int:
    """``tune <model> --transforms``: the schedule search over every
    proven-legal interchange, hierarchy-laddered tiling and fusion of the
    model, and the best (transform, schedule) pair with its static MRC
    delta against the untransformed winner.  ``--check`` runs the winning
    TRANSFORMED spec once on the engine (the only device work here)."""
    import json as json_mod

    from pluss_torch.analysis import transform as tf
    from pluss_torch.analysis import tune as tune_mod

    spec = REGISTRY[args.model](args.n)
    rep = tf.search_transforms(spec, candidates=cands, hier=hier)
    doc = rep.doc()
    all_diags = analysis.with_model(rep.diagnostics, spec.name)
    rc = 1 if any(d.code == "PL903" for d in rep.diagnostics) else 0
    if args.check and rep.best is not None:
        ok, detail, diags = tune_mod.check_winner(
            rep.best.transform.spec, rep.best.tune, device=device_of())
        doc["check"] = detail
        all_diags += analysis.with_model(diags, spec.name)
        if not ok:
            rc = 1
            print(f"pluss_torch tune: {spec.name}: transformed winner "
                  f"CHECK FAILED (PL904) {detail}", file=sys.stderr)
        else:
            print(f"pluss_torch tune: {spec.name}: transformed winner "
                  f"{rep.best.transform.label()} + "
                  f"{rep.best.tune.winner.candidate.label()} verified "
                  f"against engine.run (histograms bit-identical, MRC "
                  f"{_mrc_kind(detail)})", file=sys.stderr)
    elif args.check:
        print(f"pluss_torch tune: {spec.name}: transform check skipped (no "
              "transform beats the untransformed winner)", file=sys.stderr)
    if args.sarif:
        _write_sarif(args.sarif, all_diags, "tune")
    if args.json:
        out.write(json_mod.dumps(doc, indent=1) + "\n")
    else:
        for d in rep.diagnostics:
            out.write(f"{spec.name}: [{d.code}] {d.message}\n")
        if rep.best is not None:
            out.write(f"pluss tune: {spec.name}: best transform "
                      f"{rep.best.transform.label()} + "
                      f"{rep.best.tune.winner.candidate.label()} "
                      f"(predicted miss {rep.best.score():.6g}, delta "
                      f"{rep.delta:+.6g}) at {rep.target_kb} KB LLC\n")
        else:
            out.write(f"pluss tune: {spec.name}: no transform beats "
                      f"the untransformed winner at {rep.target_kb} KB "
                      "LLC\n")
    return rc


def _write_registered(spec, registry_dir: str, mode: str) -> None:
    """``--register``: the spec as codec JSON in ``registry_dir``."""
    from pluss_torch import spec_codec

    os.makedirs(registry_dir, exist_ok=True)
    path = os.path.join(registry_dir, f"{spec.name}.json")
    with open(path, "w") as f:
        f.write(spec_codec.dump_spec(spec) + "\n")
    print(f"pluss_torch {mode}: registered {spec.name} -> {path} "
          f"(PLUSS_SPEC_DIR={registry_dir} serves it as a registry model)",
          file=sys.stderr)


def _transform_main(args, p, out, device_of) -> int:
    """``transform <model> (--interchange A,B | --tile L:S,... | --fuse
    A+B) [--json|--sarif|--check|--register]``: the legality proof and
    the spec-to-spec rewrite (:mod:`pluss_torch.analysis.transform`).
    Verdicts PL951 proven legal, PL952 proven illegal with the violating
    pair, PL953 refused; rc 0 only on PL951.  ``--check`` runs the
    TRANSFORMED spec once on the engine against its static prediction
    (PL954 on disagreement)."""
    import json as json_mod

    from pluss_torch.analysis import transform as tf

    if not args.target:
        p.error("transform mode requires a model (e.g. `pluss "
                "transform gemm --interchange 0,2`)")
    if args.target not in REGISTRY:
        p.error(f"transform mode: unknown model {args.target!r}")
    picked = [f for f in (args.interchange, args.tile, args.fuse)
              if f is not None]
    if len(picked) != 1:
        p.error("transform mode wants exactly one of "
                "--interchange/--tile/--fuse")
    spec = REGISTRY[args.target](args.n)
    cfg = SamplerConfig(thread_num=args.threads, chunk_size=args.chunk)
    try:
        if args.interchange is not None:
            a, b = tf.parse_interchange(args.interchange)
            rep = tf.interchange(spec, a, b)
        elif args.tile is not None:
            rep = tf.tile(spec, tf.parse_tile(args.tile))
        else:
            na, nb = tf.parse_fuse(args.fuse)
            rep = tf.fuse(spec, na, nb)
    except ValueError as e:
        p.error(f"transform mode: {e}")
    doc = rep.doc()
    diags = analysis.with_model(rep.diagnostics, spec.name)
    rc = 0 if rep.code == "PL951" else 1
    if args.check:
        if rep.spec is None:
            print(f"pluss_torch transform: {spec.name}: check skipped "
                  f"({rep.code}: no transformed spec)", file=sys.stderr)
        else:
            ok, detail, cdiags = tf.check_transform(rep, cfg,
                                                    device=device_of())
            doc["check"] = detail
            diags += analysis.with_model(cdiags, spec.name)
            if detail.get("skipped"):
                print(f"pluss_torch transform: {rep.spec.name}: check "
                      f"skipped (prediction refused: {detail['codes']})",
                      file=sys.stderr)
            elif not ok:
                rc = 1
                print(f"pluss_torch transform: {rep.spec.name}: CHECK "
                      f"FAILED (PL954) {detail}", file=sys.stderr)
            else:
                print(f"pluss_torch transform: {rep.spec.name}: verified "
                      f"against engine.run (histograms bit-identical, MRC "
                      f"{_mrc_kind(detail)})", file=sys.stderr)
    if args.register and rep.spec is not None:
        _write_registered(rep.spec, args.registry_dir, "transform")
    if args.sarif:
        _write_sarif(args.sarif, diags, "transform")
    if args.json:
        out.write(json_mod.dumps(doc, indent=1) + "\n")
    else:
        for d in diags:
            out.write(d.format() + "\n")
        tail = f" -> {rep.spec.name}" if rep.spec is not None else ""
        out.write(f"pluss transform: {spec.name}: {rep.label()}"
                  f"{tail} [{rep.code}]\n")
    return rc


def _check_against_model(args, cfg: SamplerConfig, res, ri, spec,
                         ref) -> int:
    """The import bit-identity gate: the registry model at ``--n``, same
    schedule, must give byte-identical histograms and MRC.  ``ref`` is the
    model's ``(result, curve)``, run once by the caller."""
    import numpy as np

    ref_res, ref_curve = ref
    same_hist = (res.noshare_list() == ref_res.noshare_list()
                 and res.share_list() == ref_res.share_list())
    same_mrc = np.array_equal(mrc.aet_mrc(ri, cfg), ref_curve)
    if same_hist and same_mrc:
        print(f"pluss_torch import: {spec.name}: histogram + MRC byte-"
              f"identical to registry {args.check_model}({args.n})",
              file=sys.stderr)
        return 0
    print(f"pluss_torch import: {spec.name}: DIVERGES from registry "
          f"{args.check_model}({args.n}) "
          f"(histograms {'==' if same_hist else '!='}, "
          f"MRC {'==' if same_mrc else '!='})", file=sys.stderr)
    return 1


def _import_main(args, p, out, device_of) -> int:
    """``import <file.py|file.c> [--json|--register|--predict|--run|
    --check-model M]``: derive specs from DSL or pragma-C source through
    the analyzer gate (:func:`pluss_torch.frontend.import_path`).  Host
    work unless ``--run``/``--check-model`` asks for an engine run."""
    import json as json_mod

    from pluss_torch import frontend, spec_codec

    if not args.target:
        p.error("import mode requires a source file (.py DSL or "
                ".c pragma-C)")
    if args.check_model is not None and args.check_model not in REGISTRY:
        p.error(f"--check-model: unknown model {args.check_model!r}")
    cfg = SamplerConfig(thread_num=args.threads, chunk_size=args.chunk)
    try:
        # --verify upgrades the gate to the schedule-aware analysis under
        # the CLI's own (--threads, --chunk)
        pairs = frontend.import_path(args.target,
                                     cfg if args.verify else None)
    except frontend.FrontendError as e:
        # PL6xx grammar findings, or the analyzer's own diagnostics when
        # the gate refused a grammatical source
        for d in e.diagnostics:
            print(d.format(), file=sys.stderr)
        print(f"pluss_torch import: {args.target}: rejected ({e.code})",
              file=sys.stderr)
        return 1
    for spec, diags in pairs:
        text = analysis.format_text(diags)
        if text:      # warnings only: errors raised above
            print(text, file=sys.stderr)
    print(f"pluss_torch import: {args.target}: {len(pairs)} spec(s) "
          f"derived, analyzer-clean ({', '.join(s.name for s, _ in pairs)})",
          file=sys.stderr)
    if args.json:
        docs = [spec_codec.spec_to_json(s) for s, _ in pairs]
        out.write(json_mod.dumps(docs[0] if len(docs) == 1 else docs,
                                 indent=1) + "\n")
    if args.register:
        for spec, _ in pairs:
            _write_registered(spec, args.registry_dir, "import")
    rc = 0
    if args.predict:
        from pluss_torch.analysis import ri

        for spec, _ in pairs:
            rep = ri.predict(spec, cfg)
            out.write(_prediction_line(spec.name, ri.report_doc(rep)))
            rc |= 1 if analysis.error_count(
                rep.prediction.diagnostics) else 0
    if args.run or args.check_model:
        device = device_of()
        ref = None
        if args.check_model:   # the model runs once, not once per spec
            ref_res, ref_ri = sampler_step(
                REGISTRY[args.check_model](args.n), cfg, device,
                args.window, args.start_point)()
            ref = (ref_res, mrc.aet_mrc(ref_ri, cfg))
        for spec, _ in pairs:
            res, ri_ = _run_spec_block(spec, cfg, args, device, out)
            if ref is not None:
                rc |= _check_against_model(args, cfg, res, ri_, spec, ref)
    return rc


def _verify_spec(spec, cfg: SamplerConfig, out_err) -> int:
    """The ``--verify`` pre-pass: the schedule-aware analysis under the
    run's own schedule, before any engine work.  Returns the number of
    ERROR diagnostics; findings go to stderr, so the blocks on stdout stay
    diffable."""
    diags, _ = analysis.analyze_spec(spec, cfg)
    diags = analysis.with_model(diags, spec.name)
    text = analysis.format_text(diags)
    if text:
        out_err.write(text + "\n")
    return analysis.error_count(diags)


def _run_spec_block(spec, cfg: SamplerConfig, args, device, out):
    """One acc block (warm-up, then a timed run and the three histogram
    dumps) of a loaded spec, under the banner ``<device> IMPORT <name>``."""
    step = sampler_step(spec, cfg, device, args.window, args.start_point)
    step()
    dt, res, ri = timed(step)
    acc_block(f"{banner_of(device)} IMPORT {spec.name}", dt,
              res.noshare_list(), res.share_list(), ri,
              res.max_iteration_count, out)
    return res, ri


def _spec_main(args, p, out, device_of) -> int:
    """``spec dump <model>`` / ``spec load <file.json> [--run]``."""
    from pluss_torch import spec_codec
    from pluss_torch.resilience.errors import InvalidRequest
    from pluss_torch.spec import loop_size

    verb = args.target
    if verb not in ("dump", "load"):
        p.error("spec mode: `pluss spec dump <model>` or "
                "`pluss spec load <file.json> [--run]`")
    if verb == "dump":
        if not args.arg2:
            p.error("spec dump requires a model name "
                    "(`pluss spec dump <model> [--n N]`)")
        model = args.arg2
        if model not in REGISTRY:
            p.error(f"spec dump: unknown model {model!r}")
        out.write(spec_codec.dump_spec(REGISTRY[model](args.n)) + "\n")
        return 0
    if not args.arg2:
        p.error("spec load requires a spec JSON file path")
    try:
        spec = spec_codec.load_spec_file(args.arg2)
    except InvalidRequest as e:
        print(f"pluss_torch spec load: {e}", file=sys.stderr)
        return 1
    # a loaded spec passes the same lint gate as any other
    diags = analysis.with_model(analysis.lint_spec(spec), spec.name)
    text = analysis.format_text(diags)
    if text:
        print(text, file=sys.stderr)
    if analysis.error_count(diags):
        print(f"pluss_torch spec load: {spec.name} rejected by the static "
              "analyzer", file=sys.stderr)
        return 1
    if args.run:
        cfg = SamplerConfig(thread_num=args.threads, chunk_size=args.chunk)
        _run_spec_block(spec, cfg, args, device_of(), out)
    else:
        total = sum(loop_size(n) for n in spec.nests)
        out.write(f"{spec.name}: {len(spec.nests)} nest(s), "
                  f"{len(spec.arrays)} array(s), {total} accesses; "
                  "lint clean\n")
    return 0


#: the modes that run on the host only and touch no device
HOST_MODES = {"lint": _analysis_main, "analyze": _analysis_main,
              "cotenancy": _cotenancy_main}

#: the modes that resolve a device only where an engine run needs one
#: (``--check``, ``spec load --run``, ``import --run|--check-model``)
CHECK_MODES = {"predict": _predict_main, "tune": _tune_main,
               "spec": _spec_main, "transform": _transform_main,
               "import": _import_main}


if __name__ == "__main__":
    sys.exit(main())
