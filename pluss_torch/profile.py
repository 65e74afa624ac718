"""Where one sampler run's, or one trace replay's, time goes on the CUDA card.

    python -m pluss_torch.profile --model mvt --n 4000
    python -m pluss_torch.profile --trace trace.bin
    python -m pluss_torch.profile --resident trace.bin

Prints one JSON object per model: the plan's window paths
(``engine.plan_path``), the host plan's seconds, the wall
seconds of the device part (``engine._execute``, which ends in the copy of
the result to the host) and its refs/s and peak device memory, the device
busy seconds (the sum of every kernel,
copy and memset the run put on the card, from ``torch.profiler``), the
idle share ``1 - busy/wall``, the device's top operations by time, and
the device time and launches of each of the port's own kernels.
The profiled run follows one unprofiled warm-up run (kernel build,
allocator growth).

With ``--trace FILE``, one object per file for ``trace.replay_file`` with
its defaults: wall seconds, refs/s, device busy seconds and idle share,
the replay's own main-thread split (feed stall, staging, device dispatch
and final wait), the peak device memory, the top device operations and
the port's kernels.
The warm-up replays one batch.

With ``--resident FILE``, the same for ``trace.replay_staged`` of the
file's d24v pack (``pack_cached``, written next to the file) staged into
device memory: the pack and staging seconds, then the profiled replay
after one unprofiled one.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from pluss_torch import engine, trace
from pluss_torch.config import SamplerConfig
from pluss_torch.models import REGISTRY
from pluss_torch.obs import xprof

#: symbol prefixes of the port's CUDA kernels (pluss_torch/csrc/*.cu)
PORT_KERNELS = ("carried_event_hist", "masked_hist", "d24v_")


def profiled(fn, top: int):
    """``fn()`` under ``torch.profiler``, ending in a device sync: its
    result, wall seconds, device busy seconds (None when the profiler saw
    no device time), top device operations and the port's kernels among
    all of them (device seconds and launches by symbol prefix)."""
    with xprof.profiler() as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = [(e.key, e.self_device_time_total / 1e6, e.count)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    ops.sort(key=lambda o: -o[1])
    busy = sum(o[1] for o in ops) if ops else None
    kernels = {}
    for k, s, c in ops:
        for sym in PORT_KERNELS:
            if sym in k:
                got = kernels.setdefault(sym, {"s": 0.0, "count": 0})
                got["s"] += s
                got["count"] += c
    return out, wall, busy, [{"name": k[:90], "s": s, "count": c}
                             for k, s, c in ops[:top]], kernels


def profile_run(spec, cfg: SamplerConfig, top: int = 8) -> dict:
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    pl = engine.plan(spec, cfg)
    plan_s = time.perf_counter() - t0
    engine._execute(pl, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, wall, busy, ops, kernels = profiled(lambda: engine._execute(pl, dev),
                                           top)
    return {
        "model": spec.name, "refs": pl.total_count,
        "path": engine.plan_path(pl), "plan_s": plan_s,
        "device_part_wall_s": wall,
        "refs_per_s": pl.total_count / wall,
        "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
        "device_busy_s": busy,
        "device_idle_share": None if busy is None else 1 - busy / wall,
        "top_device_ops": ops, "port_kernels": kernels,
    }


def profile_trace(path: str, top: int = 8) -> dict:
    trace.replay_file(path, limit_refs=trace.WINDOWS_PER_BATCH
                      * trace.TRACE_WINDOW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rep, wall, busy, ops, kernels = profiled(
        lambda: trace.replay_file(path), top)
    return {
        "trace": os.path.basename(path), "refs": rep.total_count,
        "wall_s": wall, "refs_per_s": rep.total_count / wall,
        "device_busy_s": busy,
        "device_idle_share": None if busy is None else 1 - busy / wall,
        "split": rep.timing, "wire": rep.wire,
        "feed_workers": rep.feed_workers, "n_lines": rep.n_lines,
        "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
        "top_device_ops": ops, "port_kernels": kernels,
    }


def profile_resident(path: str, top: int = 8) -> dict:
    t0 = time.perf_counter()
    meta, _, packed = trace.pack_cached(path, wire="d24v")
    pack_s = time.perf_counter() - t0
    resident, n_run, info = trace.stage_resident(packed, meta)
    trace.replay_staged(resident, meta["n_lines"], n_run)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rep, wall, busy, ops, kernels = profiled(
        lambda: trace.replay_staged(resident, meta["n_lines"], n_run,
                                    clock0=1), top)
    return {
        "resident": os.path.basename(path), "refs": rep.total_count,
        "pack_s": pack_s, **info, "wall_s": wall,
        "refs_per_s": rep.total_count / wall, "device_busy_s": busy,
        "device_idle_share": None if busy is None else 1 - busy / wall,
        "n_lines": rep.n_lines,
        "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
        "top_device_ops": ops, "port_kernels": kernels,
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="pluss_torch.profile",
                                description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model", action="append", choices=sorted(REGISTRY),
                   help="model to profile (repeatable; default gemm)")
    p.add_argument("--n", type=int, action="append",
                   help="problem size, one per --model (default 1024)")
    p.add_argument("--trace", action="append", default=[],
                   help="u64 trace file to replay (repeatable)")
    p.add_argument("--resident", action="append", default=[],
                   help="u64 trace file to pack, stage and replay from "
                        "device memory (repeatable)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        p.error("no CUDA device is available")
    models = args.model or ([] if args.trace or args.resident else ["gemm"])
    sizes = args.n or [1024] * len(models)
    if len(sizes) != len(models):
        p.error("give one --n per --model")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    for m, n in zip(models, sizes):
        print(json.dumps({"card": card,
                          **profile_run(REGISTRY[m](n), SamplerConfig())}),
              flush=True)
    for path in args.trace:
        print(json.dumps({"card": card, **profile_trace(path)}), flush=True)
    for path in args.resident:
        print(json.dumps({"card": card, **profile_resident(path)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
