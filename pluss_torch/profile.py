"""Where one sampler run's time goes on the CUDA card.

    python -m pluss_torch.profile --model mvt --n 4000

Prints one JSON object per model: the host plan's seconds, the wall
seconds of the device part (``engine._execute``, which ends in the copy of
the result to the host), the device busy seconds (the sum of every kernel,
copy and memset the run put on the card, from ``torch.profiler``), the
idle share ``1 - busy/wall``, and the device's top operations by time.
The profiled run follows one unprofiled warm-up run (kernel build,
allocator growth).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from pluss_torch import engine
from pluss_torch.config import SamplerConfig
from pluss_torch.models import REGISTRY


def profile_run(spec, cfg: SamplerConfig, top: int = 8) -> dict:
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    pl = engine.plan(spec, cfg)
    plan_s = time.perf_counter() - t0
    engine._execute(pl, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine._execute(pl, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = [(e.key, e.self_device_time_total / 1e6, e.count)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    ops.sort(key=lambda o: -o[1])
    busy = sum(o[1] for o in ops)
    return {
        "model": spec.name, "refs": pl.total_count, "plan_s": plan_s,
        "device_part_wall_s": wall,
        "device_busy_s": busy if ops else None,
        "device_idle_share": 1 - busy / wall if ops else None,
        "top_device_ops": [{"name": k[:90], "s": s, "count": c}
                           for k, s, c in ops[:top]],
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="pluss_torch.profile",
                                description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model", action="append", choices=sorted(REGISTRY),
                   help="model to profile (repeatable; default gemm)")
    p.add_argument("--n", type=int, action="append",
                   help="problem size, one per --model (default 1024)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        p.error("no CUDA device is available")
    models = args.model or ["gemm"]
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
