"""`acc` / `speed` / `mrc` CLI of the port — the reference's run modes.

    python -m pluss_torch.cli acc --model gemm --n 1024      # on the CUDA card
    python -m pluss_torch.cli acc --cpu --model gemm --n 16  # on the host

- ``acc``: one timed run; prints the reference's block (timing banner, the
  three histogram dumps, "max iteration traversed").  Below the banner the
  block is line for line the one ``python -m pluss.cli acc --backends vmap``
  prints for the same model.
- ``speed``: ``--reps`` timed runs, a banner+seconds line each.
- ``mrc``: the AET miss-ratio curve, written to ``--out``.

The timed region is the reference's: sampler + CRI distribute
(…omp.cpp:337-339), after one untimed warm-up run that builds the kernels
and initializes the device.  Runs go to the CUDA card; ``--cpu`` is the only
way onto the host, and with no card and no ``--cpu`` the CLI stops.
"""

from __future__ import annotations

import argparse
import sys
import time

from pluss_torch import cri, engine, mrc
from pluss_torch.config import SamplerConfig
from pluss_torch.io import acc_block, speed_block
from pluss_torch.models import REGISTRY


def sampler_step(spec, cfg: SamplerConfig, device, window=None):
    """() -> (result, rihist): one sampler run plus the CRI post-pass."""
    def step():
        res = engine.run(spec, cfg, device=device, window_accesses=window)
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
    p.add_argument("mode", choices=("acc", "speed", "mrc"))
    p.add_argument("--model", default="gemm", choices=sorted(REGISTRY))
    p.add_argument("--n", type=int, default=128, help="problem size")
    p.add_argument("--threads", type=int, default=4, help="simulated threads")
    p.add_argument("--chunk", type=int, default=4, help="schedule chunk size")
    p.add_argument("--window", type=int, default=None,
                   help="accesses per window per thread")
    p.add_argument("--reps", type=int, default=3, help="speed-mode repetitions")
    p.add_argument("--out", default="mrc.csv", help="mrc-mode output file")
    p.add_argument("--cpu", action="store_true",
                   help="run on the host CPU instead of the CUDA card")
    args = p.parse_args(argv)

    try:
        device = engine.resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        p.error(str(e))
    spec = REGISTRY[args.model](args.n)
    cfg = SamplerConfig(thread_num=args.threads, chunk_size=args.chunk)
    step = sampler_step(spec, cfg, device, args.window)
    out = sys.stdout
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


if __name__ == "__main__":
    sys.exit(main())
