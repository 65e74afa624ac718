"""`acc` / `speed` / `mrc` / `sample` / `trace` / `stats` CLI of the port — the reference's run modes.

    python -m pluss_torch.cli acc --model gemm --n 1024      # on the CUDA card
    python -m pluss_torch.cli acc --cpu --model gemm --n 16  # on the host
    python -m pluss_torch.cli sample --model gemm --n 1024 --rates 0.05,0.1
    python -m pluss_torch.cli trace --file t.bin --out mrc.csv
    python -m pluss_torch.cli acc --cpu --telemetry ev.jsonl
    python -m pluss_torch.cli stats ev.jsonl --check

- ``acc``: one timed run; prints the reference's block (timing banner, the
  three histogram dumps, "max iteration traversed").  Below the banner the
  block is line for line the one ``python -m pluss.cli acc --backends vmap``
  prints for the same model.
- ``speed``: ``--reps`` timed runs, a banner+seconds line each.
- ``mrc``: the AET miss-ratio curve, written to ``--out``.
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
  ``--out``.  Below the banner the block and the CSV are byte
  for byte those of ``python -m pluss.cli trace``.
- ``stats <events.jsonl>``: aggregate a telemetry stream (``--check``
  validates it instead, ``--trace RID`` renders one request's spans,
  ``--follow`` tails a growing stream): host code only, no card, and
  byte for byte what ``python -m pluss.cli stats`` prints.

``--telemetry PATH`` (or ``PLUSS_TELEMETRY``) writes the run's spans,
counters, gauges and events to PATH as JSONL
(:mod:`pluss_torch.obs`).

The timed region of ``acc``/``speed`` is the reference's: sampler + CRI
distribute (…omp.cpp:337-339), after one untimed warm-up run that builds
the kernels and initializes the device; ``trace`` times the one replay.  Runs go to the CUDA card; ``--cpu`` is the only
way onto the host, and with no card and no ``--cpu`` the CLI stops.
"""

from __future__ import annotations

import argparse
import resource
import sys
import time

import torch

from pluss_torch import cri, engine, mrc, obs, sampling, trace
from pluss_torch.config import SamplerConfig
from pluss_torch.io import RI_TITLE, acc_block, print_histogram, speed_block
from pluss_torch.models import REGISTRY


def sampler_step(spec, cfg: SamplerConfig, device, window=None,
                 start_point=None):
    """() -> (result, rihist): one sampler run plus the CRI post-pass."""
    def step():
        res = engine.run(spec, cfg, device=device, window_accesses=window,
                         start_point=start_point)
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


def banner_of(device) -> str:
    return "TORCH CUDA" if device.type == "cuda" else "TORCH CPU"


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="pluss_torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("mode", choices=("acc", "speed", "mrc", "sample", "trace",
                                    "stats"))
    p.add_argument("target", nargs="?", default=None,
                   help="stats mode: the telemetry event stream "
                        "(events.jsonl) to aggregate")
    p.add_argument("--check", action="store_true",
                   help="stats mode: validate the event stream against "
                        "the telemetry schema instead of rendering it "
                        "(exit 1 on any violation)")
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
                        "<file>.ckpt.npz with --resume)")
    p.add_argument("--resident-cache", default=None,
                   action=argparse.BooleanOptionalAction,
                   help="trace mode: keep the staged trace resident in "
                        "device memory (the residency store), so a repeat "
                        "replay in this process skips the host feed; "
                        "--no-resident-cache forces the plain streamed "
                        "path (the default for a one-shot replay)")
    p.add_argument("--resume", action="store_true",
                   help="trace mode: checkpoint while replaying and resume "
                        "from an existing checkpoint")
    p.add_argument("--cpu", action="store_true",
                   help="run on the host CPU instead of the CUDA card")
    args = p.parse_args(argv)

    if args.target is not None and args.mode != "stats":
        p.error(f"unexpected argument {args.target!r} for mode "
                f"{args.mode!r} (positional input is for stats mode only)")
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
    try:
        device = engine.resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        p.error(str(e))
    cfg = SamplerConfig(thread_num=args.threads, chunk_size=args.chunk)
    try:
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
    if args.mode == "sample":
        return sample_mode(args, spec, cfg, device, out)
    step = sampler_step(spec, cfg, device, args.window, args.start_point)
    if args.mode == "acc":
        step()  # warm-up: kernel build and device start-up stay untimed
        dt, res, ri = timed(step)
        acc_block(banner_of(device), dt, res.noshare_list(), res.share_list(),
                  ri, res.max_iteration_count, out)
    elif args.mode == "speed":
        step()
        speed_block(banner_of(device),
                    [timed(step)[0] for _ in range(args.reps)], out)
    else:
        _, _, ri = timed(step)
        curve = mrc.aet_mrc(ri, cfg)
        mrc.write_mrc(args.out, curve)
        out.write(f"wrote {len(mrc.dedup_lines(curve))} MRC lines to "
                  f"{args.out} (curve over {len(curve)} cache sizes)\n")
    return 0


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


def trace_mode(args, p, cfg: SamplerConfig, device, out) -> int:
    """Replay ``--file`` and print the trace block (single-clock: no CRI
    dilation, the reuse histogram feeds the AET curve directly)."""
    if not args.file:
        p.error("trace mode requires --file")
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
    out.write(f"{banner_of(device)} TRACE: {dt:0.6f}\n")
    print_histogram(RI_TITLE, rep.histogram(), out)
    mrc.write_mrc(args.out, mrc.aet_mrc(rep.histogram(), cfg))
    out.write(f"{rep.total_count} refs over {rep.n_lines} lines; "
              f"wrote MRC to {args.out}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
