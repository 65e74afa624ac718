#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives ``pluss_torch``'s two main paths on the card — the sampler
(``engine.run`` -> ``cri.distribute`` -> ``mrc.aet_mrc`` -> the ``acc``
block) and the streamed trace replay (``trace.replay_file`` -> the
``trace`` block) — and holds every kernel of those paths against its plain
torch version.  Each phase prints one JSON line; any failed check raises,
so the script exits non-zero and prints no result line.  Phases:

1. build: compile the three kernels from ``pluss_torch/csrc`` with one
   ``nvcc`` each, all at once; report each one's seconds and ptxas lines;
2. kernel: the carried-event histogram kernel vs its plain version on
   random ghost-merged sorted windows at the main path's shape
   (mvt-4000's sort window, T=4), int32 and int64 positions, bit for bit;
   kernel, plain and ``torch.sort`` times beside the bound;
3. masked_hist: the masked event histogram kernel vs its plain version on
   one 2^24-entry trace batch of random events, int32 and int64 reuse,
   ``include_cold`` both ways, bit for bit; times beside the bound;
4. d24v_decode: the wire decode kernel vs its plain version and the
   original ids on a 2^24-id stream mixing raw blocks of widths 1-6, delta
   blocks of widths 0-5, descending runs and raw resets of delta chains;
   then vs its plain version on random width maps and payloads (delta
   blocks of every width 0-7, block sums that wrap 32 bits);
5. gemm128: the analytical goldens, exact (template path);
6. gemm1024: the north star (template path, 4,297,064,448 refs);
7. mvt4000: template + sort windows, through the kernel in every window;
   then again with the plain version in place of the kernel (an argument
   of the engine's internals), which must agree exactly; then a small mvt
   with ragged windows, card vs CPU, exactly;
8. cli: ``python -m pluss_torch.cli acc`` on the card, in process;
9. trace: a 2^28-ref trace (``pluss_torch.tracegen.smoke_trace``: 2^27
   hot/warm refs, then 8 sequential sweeps over a second memory region)
   replayed with ``replay_file``'s defaults (d24v wire, feed pool; 16
   batches of 2^24), held against an independent golden (a replay of the
   hot/warm part alone plus the sweeps' hand-worked histogram), a rerun
   with the plain versions forced, the ``pack`` wire, a checkpoint/resume
   split, and (on a 2^24-ref prefix) the CPU;
10. trace_cli: ``python -m pluss_torch.cli trace`` on the card, in process;
11. the kernels line, the card's name and power limit, and the result line.

Every kernel launch count is set to 0 just before each main-path run
(phases 5-7 and 9-10's first replay) and read just after it: the event
kernel must launch once per sort-path window of the plan (0 for GEMM,
every window for mvt-4000); the masked histogram and the decode once per
trace batch.  The comparison launches of phases 2-4 and the cross-checks
of phases 7 and 9 are not counted.  Exits non-zero, printing no result,
when there is no CUDA device or when run outside the repository.
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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


def random_events(n: int, reuse_bits: int, seed: int):
    """One trace batch of classified events on the card: log-uniform
    reuses below ``2**reuse_bits`` (int32 or int64; a few zero or
    negative), with ``is_evt``, ``share`` and ``cold`` masks."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(device="cuda", generator=g)
    dt = torch.int32 if reuse_bits <= 31 else torch.int64
    e = torch.randint(0, reuse_bits, (n,), **kw).to(torch.int64)
    reuse = ((torch.ones(n, dtype=torch.int64, device="cuda") << e)
             + torch.randint(-3, 1 << 10, (n,), **kw)).to(dt)
    reuse = torch.where(torch.rand(n, **kw) < 0.01, -reuse, reuse)
    is_evt = torch.rand(n, **kw) < 0.9
    share = torch.rand(n, **kw) < 0.05
    cold = ~is_evt & (torch.rand(n, **kw) < 0.5)
    return reuse, is_evt, share, cold


def mixed_d24v_ids(n_blocks: int, seed: int):
    """int32 ids whose d24v encoding mixes raw blocks of widths 1-6, delta
    blocks of widths 0-5 (the encoder never picks delta at 6 nibbles: raw
    wins the tie), descending runs, sequential runs, and raw blocks that
    reset a delta chain."""
    import numpy as np

    B = 1024
    rng = np.random.default_rng(seed)
    blocks = []
    while len(blocks) < n_blocks:
        for k in range(1, 7):                       # raw, width k
            v = rng.integers(0, 16**k, B)
            v[rng.integers(0, B)] = 16**k - 1
            blocks.append(v)
        high = int(rng.integers(1 << 22, (1 << 24) - (1 << 21)))
        v = rng.integers(0, 1 << 24, B)             # raw, ends the chain
        v[-1] = high
        blocks.append(v)
        for w in range(6):                          # delta, width w
            a = rng.integers(0, max(1, 16**w // 4), B)
            blocks.append(high + a - (a[0] if w == 0 else 0))
            high = int(blocks[-1][-1])
        blocks.append(high - 3 * np.arange(1, B + 1))   # descending run
        high = int(blocks[-1][-1])
        blocks.append(high + np.arange(1, B + 1))       # sequential run
    return np.concatenate(blocks[:n_blocks]).astype(np.int32)


def random_wire(n_blocks: int, seed: int):
    """A random d24v wire: every width-map value (widths 0-7, raw or
    delta) and a random payload of the length the map needs.  Not an
    encoder's output: it drives the decode through every branch, and its
    delta sums wrap 32 bits."""
    import numpy as np
    import torch

    from pluss_torch.ops import wirecodec

    rng = np.random.default_rng(seed)
    k = rng.integers(0, 8, n_blocks)
    wm = (k | np.where(rng.random(n_blocks) < 0.3, wirecodec.RAW_MODE, 0)) \
        .astype(np.uint8)
    payload = rng.integers(0, 256, wirecodec.pad_len(
        wirecodec.used_bytes(wm)), dtype=np.uint8)
    return (torch.from_numpy(payload).cuda(), torch.from_numpy(wm).cuda())


def counted(fn):
    """Run ``fn()`` with every kernel's launch count set to 0 just before
    it; return its result and the counts read just after it."""
    from pluss_torch.ops.decode import decode_d24v
    from pluss_torch.ops.event_hist import event_histogram, masked_histogram

    wrappers = {"carried_event_hist": event_histogram,
                "masked_hist": masked_histogram, "d24v_decode": decode_d24v}
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    return out, {name: w.launches for name, w in wrappers.items()}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pluss_torch import cli, cri, engine, mrc
    from pluss_torch.config import NBINS, SamplerConfig
    from pluss_torch.io import acc_block, merge_share
    from pluss_torch.models import gemm, mvt
    from pluss_torch.ops import build, wirecodec
    from pluss_torch.ops.decode import decode_d24v
    from pluss_torch.ops.event_hist import (event_histogram,
                                            event_histogram_plain,
                                            masked_histogram,
                                            masked_histogram_plain)
    from pluss_torch.spec import share_span_formula

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    cfg = SamplerConfig()
    # launches of each kernel on each main-path run
    by_path: dict[str, dict[str, int]] = {}

    # 1. build ---------------------------------------------------------------
    names = ("event_hist", "masked_hist", "d24v_decode")
    t0 = time.perf_counter()
    built = build.build(*names)
    emit({"phase": "build", "kernels": built,
          "seconds": time.perf_counter() - t0, "ok": True})

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

    # 3. masked event histogram vs plain at one trace batch (2^24) ----------
    n = 1 << 24
    mh = {"n": n}
    mh_err = 0
    for tag, bits in (("", 31), ("_int64", 52)):
        ev = random_events(n, bits, seed=bits)
        for cold_on in (True, False):
            got = masked_histogram(*ev, include_cold=cold_on)
            want = masked_histogram_plain(*ev, include_cold=cold_on)
            torch.cuda.synchronize()
            mh_err = max(mh_err, int((got - want).abs().max()))
            check(torch.equal(got, want),
                  f"masked_hist != plain ({ev[0].dtype}, cold={cold_on})")
            check(int(want[1:].sum()) > 0 and (int(want[0]) > 0) == cold_on,
                  "random events missed the bins")
        mh.update({
            f"ms{tag}": cuda_ms(lambda: masked_histogram(*ev), 20),
            f"plain_ms{tag}": cuda_ms(lambda: masked_histogram_plain(*ev), 3),
            f"bound_ms{tag}": (n * (ev[0].element_size() + 3) + NBINS * 8)
            / HBM_BYTES_PER_S * 1e3,
        })
        del ev
    emit({"phase": "masked_hist", **mh, "max_abs_err": mh_err, "ok": True})

    # 4. d24v decode vs plain and the ids, at one trace batch (2^24 ids) ----
    ids = mixed_d24v_ids(n // wirecodec.BLOCK, seed=1)
    payload_np, wm_np = wirecodec.encode_d24v(ids)
    kinds = np.unique(wm_np)
    check({k | wirecodec.RAW_MODE for k in range(1, 7)} <= set(kinds.tolist())
          and set(range(6)) <= set(kinds.tolist()),
          f"mixed stream lacks block kinds: {kinds.tolist()}")
    payload = torch.from_numpy(payload_np).cuda()
    wm = torch.from_numpy(wm_np).cuda()
    got = decode_d24v(payload, wm)
    want = wirecodec.decode_d24v_plain(payload, wm)
    torch.cuda.synchronize()
    dec_err = int((got.long() - want.long()).abs().max())
    check(torch.equal(got, want), "d24v_decode != plain (mixed stream)")
    check(torch.equal(got[:n].cpu(), torch.from_numpy(ids)),
          "d24v_decode != the encoded ids")
    dec = {"n": n, "blocks": int(wm.numel()),
           "wm_kinds": kinds.tolist(),
           "payload_bytes": int(payload.numel()),
           "ms": cuda_ms(lambda: decode_d24v(payload, wm), 20),
           "plain_ms": cuda_ms(
               lambda: wirecodec.decode_d24v_plain(payload, wm), 3),
           "bound_ms": (wirecodec.used_bytes(wm_np) + wm.numel() + 4 * n)
           / HBM_BYTES_PER_S * 1e3}
    rp, rw = random_wire(n // wirecodec.BLOCK, seed=2)
    got = decode_d24v(rp, rw)
    want = wirecodec.decode_d24v_plain(rp, rw)
    torch.cuda.synchronize()
    dec_err = max(dec_err, int((got.long() - want.long()).abs().max()))
    check(torch.equal(got, want), "d24v_decode != plain (random wire)")
    del got, want, rp, rw
    emit({"phase": "d24v_decode", **dec, "random_wire_match": True,
          "max_abs_err": dec_err, "ok": True})

    # 5-7. the sampler's main path, each run with the counts read around it
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
        t0 = time.perf_counter()
        res, counts = counted(lambda: engine.run(spec, cfg))
        t1 = time.perf_counter()
        by_path[label] = counts
        launches = counts["carried_event_hist"]
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

    res128, _, m128 = acc_run(gemm(128), "gemm128")
    check(res128.max_iteration_count == 8421376, "gemm128 refs")
    check(cri.merge(res128.noshare_list())
          == {-1: 12288, 1: 2127872, 2: 2097152, 4: 1835008, 256: 260096,
              512: 1835008}, "gemm128 noshare golden")
    check(merge_share(res128.share_list()) == {62194: 253952},
          "gemm128 share golden")
    emit({"phase": "gemm128", **m128, "goldens": True, "ok": True})

    res1k, _, m1k = acc_run(gemm(1024), "gemm1024")
    check(res1k.max_iteration_count == 4297064448, "gemm1024 refs")
    check(m1k["event_kernel_launches"] == 0,
          "gemm1024 left the template path")
    emit({"phase": "gemm1024", **m1k, "path": "template", "ok": True})

    resm, pl, mm = acc_run(mvt(4000), "mvt4000")
    check(resm.max_iteration_count == 128_000_000, "mvt4000 refs")
    check(mm["event_kernel_launches"] == 2 * 2,
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

    # 8. the CLI entry point on the card ------------------------------------
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

    # 9-10. the trace replay's main path, on a 2^28-ref trace ---------------
    tmp = tempfile.mkdtemp(prefix="pluss_torch_smoke_")
    try:
        trace_phases(tmp, by_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 11. kernels line, card, result -----------------------------------------
    def launches_of(name):
        return {path: c[name] for path, c in by_path.items()}

    def row(name, source, replaces, m, err):
        lb = launches_of(name)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(lb.values()),
                "launches_by_path": lb, "match": True, "max_abs_err": err,
                "ms": m["ms"], "plain_ms": m["plain_ms"],
                "bound_ms": m["bound_ms"], "bound_by": "bytes",
                "library_ms": None}

    emit({"kernels": [
        row("carried_event_hist", "pluss_torch/csrc/event_hist.cu",
            "pluss/ops/pallas_events.py:208", kern, max_err),
        row("masked_hist", "pluss_torch/csrc/masked_hist.cu",
            "pluss/ops/pallas_events.py:263", mh, mh_err),
        row("d24v_decode", "pluss_torch/csrc/d24v_decode.cu",
            "pluss/ops/pallas_decode.py:130", dec, dec_err)]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def trace_phases(tmp: str, by_path: dict):
    """Phases 9 and 10: the streamed replay on the card, and its CLI."""
    import numpy as np
    import torch

    from pluss_torch import cli, trace, tracegen
    from pluss_torch.trace import PLAIN

    path = os.path.join(tmp, "smoke.bin")
    t0 = time.perf_counter()
    layout = tracegen.smoke_trace(path, seed=0)
    gen_s = time.perf_counter() - t0
    n = layout["refs"]
    batch = trace.WINDOWS_PER_BATCH * trace.TRACE_WINDOW
    n_batches = -(-n // batch)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rep, counts = counted(lambda: trace.replay_file(path))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    by_path["trace"] = counts
    check(rep.total_count == n == 1 << 28, f"trace refs {rep.total_count}")
    check(counts["masked_hist"] == counts["d24v_decode"] == n_batches == 16,
          f"trace launches {counts}, {n_batches} batches")
    check(rep.wire == "d24v" and rep.feed_workers > 1, "trace defaults")

    def same(other, what):
        check(np.array_equal(other.hist, rep.hist)
              and other.total_count == rep.total_count
              and other.n_lines == rep.n_lines, f"trace: {what}")

    # an independent golden: part A alone + part B worked out by hand
    part_a = trace.replay_file(path, limit_refs=layout["part_a_refs"])
    check(np.array_equal(rep.hist, part_a.hist + layout["part_b_hist"]),
          "trace != part A replay + part B's hand-worked histogram")
    t1 = time.perf_counter()
    same(trace.replay_file(path, _kernels=PLAIN), "plain versions")
    plain_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    same(trace.replay_file(path, wire="pack"), "pack wire")
    pack_s = time.perf_counter() - t1

    # checkpoint/resume: a read fault at batch 9 stops the first leg after
    # the checkpoint at batch 8 (the first batch of the sweeps' region)
    ckpt = os.path.join(tmp, "smoke.ckpt.npz")
    reader = trace._extent_reader

    def faulty_reader(p, batch_, n_):
        read = reader(p, batch_, n_)

        def read_or_fail(b):
            if b == 9:
                raise OSError("read fault injected at batch 9")
            return read(b)
        return read_or_fail

    trace._extent_reader = faulty_reader
    try:
        trace.replay_file(path, checkpoint_path=ckpt, checkpoint_every=4)
        check(False, "the injected read fault did not stop the replay")
    except OSError:
        pass
    finally:
        trace._extent_reader = reader
    with np.load(ckpt) as z:
        check(int(z["b_next"]) == 8, "checkpoint not at batch 8")
    same(trace.replay_file(path, checkpoint_path=ckpt, resume=True),
         "checkpoint/resume split")

    prefix = trace.replay_file(path, limit_refs=batch)
    t1 = time.perf_counter()
    on_cpu = trace.replay_file(path, limit_refs=batch, device="cpu")
    cpu_s = time.perf_counter() - t1
    check(np.array_equal(prefix.hist, on_cpu.hist)
          and prefix.n_lines == on_cpu.n_lines, "trace prefix: card != CPU")
    tm = rep.timing
    emit({"phase": "trace", "refs": n, "batches": n_batches,
          "gen_s": gen_s, "free_disk_gib": shutil.disk_usage(tmp).free / 2**30,
          "wall_s": wall, "refs_per_s": n / wall,
          **{k: tm[k] for k in ("prefetch_stall_s", "h2d_s", "device_s",
                                "grow_s", "read_s", "compact_s", "encode_s",
                                "h2d_bytes", "growths")},
          "wire": rep.wire, "feed_workers": rep.feed_workers,
          "n_lines": rep.n_lines, "peak_device_gib": peak / 2**30,
          "launches": counts, "golden": True, "plain_s": plain_s,
          "plain_match": True, "pack_s": pack_s, "pack_match": True,
          "resume_match": True, "prefix_cpu_s": cpu_s,
          "prefix_card_vs_cpu": True, "ok": True})

    small = os.path.join(tmp, "small.bin")
    tracegen.synth_trace(small, 1 << 22, seed=3)
    buf = io.StringIO()
    stdout, sys.stdout = sys.stdout, buf
    try:
        (rc, counts) = counted(lambda: cli.main(
            ["trace", "--file", small, "--out",
             os.path.join(tmp, "mrc.csv")]))
    finally:
        sys.stdout = stdout
    by_path["trace_cli"] = counts
    lines = buf.getvalue().splitlines()
    check(rc == 0 and lines[0].startswith("TORCH CUDA TRACE: ")
          and lines[1] == "Start to dump reuse time"
          and re.fullmatch(r"4194304 refs over \d+ lines; wrote MRC to .*",
                           lines[-1]) is not None
          and counts["masked_hist"] == counts["d24v_decode"] == 1,
          f"cli trace block / launches {counts}")
    emit({"phase": "trace_cli", "lines": len(lines), "launches": counts,
          "ok": True})


if __name__ == "__main__":
    sys.exit(main())
