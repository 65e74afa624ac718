#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives ``pluss_torch``'s main path on the card — ``engine.run`` ->
``cri.distribute`` -> ``mrc.aet_mrc`` -> the ``acc`` block — and holds every
kernel of that path against its plain torch version.  Each phase prints one
JSON line; any failed check raises, so the script exits non-zero and prints
no result line.  Phases:

1. build: compile the kernel from ``pluss_torch/csrc`` with ``nvcc`` and
   report the seconds and ptxas resources;
2. kernel: the carried-event histogram kernel vs its plain version on
   random ghost-merged sorted windows at the main path's shape
   (mvt-4000's sort window, T=4), int32 and int64 positions, bit for bit;
   kernel, plain and ``torch.sort`` times beside the bound;
3. gemm128: the analytical goldens, exact (template path);
4. gemm1024: the north star (template path, 4,297,064,448 refs);
5. mvt4000: template + sort windows, through the kernel in every window;
   then again with the plain version in place of the kernel (an argument
   of the engine's internals), which must agree exactly; then a small mvt
   with ragged windows, card vs CPU, exactly;
6. cli: ``python -m pluss_torch.cli acc`` on the card, in process;
7. the kernels line, the card's name and power limit, and the result line.

The event-kernel launch count is set to 0 just before each of phases 3-5's
main runs and read just after it, and must equal the plan's number of
sort-path windows (0 for GEMM, every window for mvt-4000); the comparison
launches of phase 2 and the cross-checks of phase 5 are not counted.
Exits non-zero, printing no result, when there is no CUDA device or when
run outside the repository.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import time

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` runs, after
    one warm-up run, by CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_windows(T: int, n_real: int, n_lines: int, span: int, seed: int):
    """Ghost-merged, sorted ``[T, n_real + n_lines]`` windows shaped like a
    main-path sort window: ``n_real`` accesses per row at distinct positions
    from ``win_start`` on, over ``n_lines`` lines; one ghost per line (a
    third never touched, pos -1; the rest carried from before the window);
    a third of the accesses carry a share span; a few are invalid."""
    import torch

    from pluss_torch.ops.reuse import sort_stream

    g = torch.Generator(device="cuda").manual_seed(seed)
    win_start = 1 << 26
    kw = dict(device="cuda", generator=g)
    line = torch.randint(0, n_lines, (T, n_real), dtype=torch.int32, **kw)
    pos = win_start + torch.argsort(
        torch.rand((T, n_real), **kw), dim=1).to(torch.int32)
    spn = torch.where(torch.rand((T, n_real), **kw) < 1 / 3, span, 0) \
        .to(torch.int32)
    valid = torch.rand((T, n_real), **kw) < 0.999
    gpos = torch.randint(0, win_start, (T, n_lines), dtype=torch.int32, **kw)
    gpos = torch.where(torch.rand((T, n_lines), **kw) < 1 / 3, -1, gpos)
    gline = torch.arange(n_lines, dtype=torch.int32,
                         device="cuda").expand(T, n_lines)
    return sort_stream(
        torch.cat([line, gline], 1), torch.cat([pos, gpos], 1),
        torch.cat([spn, torch.zeros_like(gpos)], 1),
        torch.cat([valid, torch.ones_like(gline, dtype=torch.bool)], 1)), \
        torch.full((T,), win_start, dtype=torch.int32, device="cuda")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pluss_torch import cli, cri, engine, mrc
    from pluss_torch.config import SamplerConfig
    from pluss_torch.io import acc_block, merge_share
    from pluss_torch.models import gemm, mvt
    from pluss_torch.ops import build
    from pluss_torch.ops.event_hist import (event_histogram,
                                            event_histogram_plain)
    from pluss_torch.spec import share_span_formula

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    cfg = SamplerConfig()

    # 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    ptxas = build.build("event_hist")
    emit({"phase": "build", "kernel": "event_hist",
          "seconds": time.perf_counter() - t0, "ptxas": ptxas, "ok": True})

    # 2. kernel vs plain at the main path's shape ----------------------------
    # nest 0's ragged window sorts every ref of the nest plus one ghost per
    # line of the arrays they touch
    spec = mvt(4000)
    n0 = engine.plan(spec, cfg).nests[0]
    n_real = n0.window_rounds * cfg.chunk_size * n0.body
    n_lines = sum(c for _, c in engine._array_ranges(n0.refs, spec, cfg))
    (key_s, pos_s, span_s, valid_s), ws = random_windows(
        cfg.thread_num, n_real, n_lines, share_span_formula(4000), seed=0)
    T, L = key_s.shape
    kern = {"T": T, "L": L}
    max_err = 0
    for tag, pdt in (("", torch.int32), ("_int64", torch.int64)):
        args = (key_s, pos_s.to(pdt), span_s, valid_s, ws.to(pdt))
        got = event_histogram(*args)
        want = event_histogram_plain(*args)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"kernel != plain ({pdt})")
        check(int(want.sum()) > 0, "random windows produced no events")
        pos_bytes = 4 if pdt == torch.int32 else 8
        kern.update({
            f"ms{tag}": cuda_ms(lambda: event_histogram(*args), 20),
            f"plain_ms{tag}": cuda_ms(lambda: event_histogram_plain(*args), 3),
            f"bound_ms{tag}": (T * L * (4 + pos_bytes + 4 + 1)
                               + T * 49 * 8) / HBM_BYTES_PER_S * 1e3,
        })
    packed = key_s.to(torch.int64) << 32
    kern["sort_ms"] = cuda_ms(lambda: torch.sort(packed, dim=1), 5)
    del key_s, pos_s, span_s, valid_s, packed
    emit({"phase": "kernel", **kern, "max_abs_err": max_err, "ok": True})

    # 3-5. the main path, each run with the launch count read around it ----
    def sort_windows(pl) -> int:
        """Sort-path windows of a plan, one kernel launch each: every
        window without the template, and the template windows of a nest
        whose template-ineligible arrays still sort."""
        n = 0
        for np_ in pl.nests:
            ultra = np_.ultra_windows()
            n += int((~ultra).sum()) + (int(ultra.sum()) if np_.var_refs else 0)
        return n

    def acc_run(spec, label):
        torch.cuda.reset_peak_memory_stats()
        event_histogram.launches = 0
        t0 = time.perf_counter()
        res = engine.run(spec, cfg)
        t1 = time.perf_counter()
        launches = event_histogram.launches
        peak = torch.cuda.max_memory_allocated()
        ri = cri.distribute(res.noshare_list(), res.share_list(),
                            cfg.thread_num)
        curve = mrc.aet_mrc(ri, cfg)
        buf = io.StringIO()
        acc_block(label, t1 - t0, res.noshare_list(), res.share_list(), ri,
                  res.max_iteration_count, buf)
        t2 = time.perf_counter()
        check(curve[0] == 1.0, f"{label}: MRC[0] != 1")
        check(bool((curve[1:] <= curve[:-1]).all()),
              f"{label}: MRC increases")
        check(bool(np.isfinite(curve).all()), f"{label}: MRC not finite")
        t3 = time.perf_counter()
        pl = engine.plan(spec, cfg)
        plan_s = time.perf_counter() - t3
        want = sort_windows(pl)
        check(launches == want, f"{label}: {launches} event-kernel launches, "
              f"the plan has {want} sort windows")
        return res, pl, {
            "engine_s": t1 - t0, "plan_s": plan_s, "cri_mrc_s": t2 - t1,
            "refs": res.max_iteration_count,
            "refs_per_s": res.max_iteration_count / (t1 - t0),
            "mrc_len": len(curve), "event_kernel_launches": launches,
            "sort_windows": want, "peak_device_gib": peak / 2**30}

    launches = {}
    res128, _, m128 = acc_run(gemm(128), "gemm128")
    launches["gemm128"] = m128["event_kernel_launches"]
    check(res128.max_iteration_count == 8421376, "gemm128 refs")
    check(cri.merge(res128.noshare_list())
          == {-1: 12288, 1: 2127872, 2: 2097152, 4: 1835008, 256: 260096,
              512: 1835008}, "gemm128 noshare golden")
    check(merge_share(res128.share_list()) == {62194: 253952},
          "gemm128 share golden")
    emit({"phase": "gemm128", **m128, "goldens": True, "ok": True})

    res1k, _, m1k = acc_run(gemm(1024), "gemm1024")
    launches["gemm1024"] = m1k["event_kernel_launches"]
    check(res1k.max_iteration_count == 4297064448, "gemm1024 refs")
    check(launches["gemm1024"] == 0, "gemm1024 left the template path")
    emit({"phase": "gemm1024", **m1k, "path": "template", "ok": True})

    resm, pl, mm = acc_run(mvt(4000), "mvt4000")
    launches["mvt4000"] = mm["event_kernel_launches"]
    check(resm.max_iteration_count == 128_000_000, "mvt4000 refs")
    check(launches["mvt4000"] == 2 * 2,
          "mvt4000 did not launch the event kernel in each of its 2 nests "
          "x 2 windows")
    t0 = time.perf_counter()
    plain = engine._execute(pl, dev, event_hist=event_histogram_plain)
    mm["plain_engine_s"] = mm["plan_s"] + time.perf_counter() - t0
    check(bool((plain.noshare_dense == resm.noshare_dense).all())
          and plain.share_raw == resm.share_raw,
          "mvt4000: kernel run != plain-version run")
    small = engine.plan(mvt(250), cfg, window_accesses=1 << 14)
    ultra = small.nests[0].ultra_windows()
    check(bool(ultra.any()) and not bool(ultra.all()),
          "mvt250 plan lacks mixed template/sort windows")
    on_card = engine._execute(small, dev)
    on_cpu = engine._execute(small, torch.device("cpu"))
    check(bool((on_card.noshare_dense == on_cpu.noshare_dense).all())
          and on_card.share_raw == on_cpu.share_raw,
          "mvt250: card != CPU")
    emit({"phase": "mvt4000", **mm, "path": "template+sort",
          "plain_match": True, "small_card_vs_cpu": True, "ok": True})

    # 6. the CLI entry point on the card ------------------------------------
    buf = io.StringIO()
    stdout, sys.stdout = sys.stdout, buf
    try:
        rc = cli.main(["acc", "--model", "gemm", "--n", "128"])
    finally:
        sys.stdout = stdout
    lines = buf.getvalue().splitlines()
    check(rc == 0 and lines[0].startswith("TORCH CUDA: ")
          and lines[-3:] == ["max iteration traversed", "8421376", ""],
          "cli acc block")
    emit({"phase": "cli", "lines": len(lines), "ok": True})

    # 7. kernels line, card, result ------------------------------------------
    emit({"kernels": [{
        "name": "carried_event_hist", "route": "cuda",
        "source": "pluss_torch/csrc/event_hist.cu",
        "replaces": "pluss/ops/pallas_events.py:208",
        "launches": sum(launches.values()), "launches_by_path": launches,
        "match": True, "max_abs_err": max_err,
        "ms": kern["ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": "bytes",
        "library_ms": None}]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
