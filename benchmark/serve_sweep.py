"""The sustained rate of a served cell: open-loop windows at rising rates.

    python3 benchmark/serve_sweep.py --workload serve-pool.open \\
        --rates 0.5:6:0.25 --seconds 51 --seed 0

Sets the cell up once, as a run does (the daemon, one connection per
tenant, one warm-up request each), then runs one open-loop window per rate
(:func:`benchmark.traffic.arrivals` at that rate, the cell's other mix
numbers), each after the last has been answered, and prints a JSON line a
window.  A rate is sustained when no request was shed or failed, the
answered rate (answers over the larger of the window and the time to the
last answer) is within 2% of the offered one, and the request due last was
answered within 5 s of the window's end.  The sweep stops after
``--stop-after`` rates in a row that are not.  The cell's mix takes a
fraction of the highest rate sustained (PERF.md); the benchmark's runs
never run this.  Needs the card.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark.run import ALLOCATOR  # noqa: E402

if __name__ == "__main__" and any(os.environ.get(k) != v
                                  for k, v in ALLOCATOR.items()):
    os.environ.update(ALLOCATOR)
    os.execv(sys.executable, [sys.executable] + sys.argv)

import contextlib  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

from benchmark import harness, serve, traffic  # noqa: E402


def window(pool, tenants, mix, seed, seconds, clock) -> dict:
    """One window at ``mix``'s rate; what it offered and answered."""
    from pluss_torch import obs
    sched = traffic.arrivals(mix, len(tenants), seed, seconds)
    win = serve.Window(pool.conns, [t["request"] for t in tenants], sched,
                       float(mix.get("timeout_s", 120)), clock)
    c0 = obs.counters()
    win.run()
    win.join()
    c1 = obs.counters()
    answered, failed = win.outcome()
    times = sorted(late for _, late, _ in answered)
    last = max(range(len(sched)), key=lambda i: sched[i][0])
    t_last = win.got.get(win.ids[last], (None,))[0]
    span = max(seconds, win.t_close - win.t0)
    got = len(answered) / span
    batches = c1.get("serve.batches", 0) - c0.get("serve.batches", 0)
    members = c1.get("serve.batched_requests", 0) \
        - c0.get("serve.batched_requests", 0)
    lag = None if t_last is None else t_last - (win.t0 + seconds)
    q = statistics.quantiles(times, n=100, method="inclusive") \
        if len(times) >= 2 else [None] * 99
    return {"rate_per_s": mix["rate_per_s"], "requests": len(sched),
            "offered_per_s": len(sched) / seconds,
            "answered_per_s": got, "failed": len(failed),
            "last_due_answered_after_end_s": lag,
            "sustained": not failed and got >= 0.98 * len(sched) / seconds
            and lag is not None and lag <= 5.0,
            "p50_s": q[49], "p90_s": q[89], "p99_s": q[98],
            "max_s": times[-1] if times else None,
            "batch_occupancy": members / batches if batches else None,
            "sender_late_s": win.sender_late_s(),
            "window_s": win.t_close - win.t0}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="benchmark/serve_sweep.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True,
                    help="first:last:step or a comma list, requests a "
                    "second")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stop-after", type=int, default=2)
    args = ap.parse_args(argv)
    root = os.path.dirname(harness.HERE)
    bench = harness.load_bench(root)
    cell, config, mix = harness.cell_of(bench, args.workload, root)
    if not harness.is_serve(config) or harness.cards() < int(cell["chips"]):
        print("benchmark: a served cell on the card(s) it asks for",
              file=sys.stderr)
        return 2
    harness._env(mix, root)
    if ":" in args.rates:
        first, last, step = (float(x) for x in args.rates.split(":"))
        rates = [round(first + i * step, 6)
                 for i in range(int(round((last - first) / step)) + 1)]
    else:
        rates = [float(x) for x in args.rates.split(",")]
    clock = time.monotonic
    t0 = clock()
    with contextlib.ExitStack() as stack:
        tmp = tempfile.mkdtemp(prefix="bench-sweep-")
        stack.callback(shutil.rmtree, tmp, True)
        pool = serve.Pool(config, "cuda", tmp, root)
        stack.callback(pool.close, 5.0)
        pool.warm(timeout_s=900.0)
        print(json.dumps({"setup_s": clock() - t0, "card": harness._card()}),
              flush=True)
        misses = 0
        for rate in rates:
            got = window(pool, config["tenants"], dict(mix, rate_per_s=rate),
                         args.seed, args.seconds, clock)
            print(json.dumps(got), flush=True)
            misses = 0 if got["sustained"] else misses + 1
            if misses >= args.stop_after:
                break
    return 0


if __name__ == "__main__":
    sys.exit(main())
