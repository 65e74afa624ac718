#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives ``pluss_torch``'s two main paths on the card — the sampler
(``engine.run`` -> ``cri.distribute`` -> ``mrc.aet_mrc`` -> the ``acc``
block; with its overlays, sliced runs and ``sampling.sampled_run``) and
the trace replay (``trace.replay_file`` -> the ``trace`` block, streamed
and through the residency store; ``pack_file`` -> ``stage_resident`` ->
``replay_staged``) — and holds every kernel of those paths against its
plain torch version.  Each phase prints one JSON line; any failed check
raises, so the script exits non-zero and prints no result line.  Phases:

1. build: compile the three kernels from ``pluss_torch/csrc`` with one
   ``nvcc`` each, all at once; report each one's seconds and ptxas lines;
2. kernel: the carried-event histogram kernel vs its plain version on
   random ghost-merged sorted windows at the main paths' shapes
   (mvt-4000's sort window, T=4, int32 and int64 positions; cholesky-
   2000's largest window, int64 positions past 2^32), bit for bit; kernel,
   plain and ``torch.sort`` (at cholesky's shape the window's two-pass
   stable ``sort_stream``) times beside the bound;
3. masked_hist: the masked event histogram kernel vs its plain version on
   one 2^24-entry trace batch of random events, int32 and int64 reuse,
   ``include_cold`` both ways, bit for bit; wrapper times (CUDA events),
   the kernel's device time (``torch.profiler``) and the plain version's
   beside the bound;
4. d24v_decode: the wire decode kernel vs its plain version and the
   original ids on a 2^24-id stream mixing raw blocks of widths 1-6, delta
   blocks of widths 0-5, descending runs and raw resets of delta chains,
   timed as in phase 3; then vs its plain version on random width maps and
   payloads (delta blocks of every width 0-7, block sums that wrap 32
   bits);
5. gemm128: the analytical goldens, exact (template path);
6. gemm1024: the north star (template path, 4,297,064,448 refs);
7. mvt4000: template + sort windows, through the kernel in every window;
   then again with the plain version in place of the kernel (an argument
   of the engine's internals), which must agree exactly; then a small mvt
   with ragged windows, card vs CPU, exactly;
8. cholesky2000: PolyBench LARGE cholesky (quad nest, 5,339,333,000
   refs, int64 positions, 125 sort windows in 4 size buckets, kernel 1
   in every one); then again with the plain version in place of the
   kernel (at n=1000 when the script's time would not allow n=2000);
9. trmm1000: varying starts, int32 positions, a sort in each of its 63
   windows;
10. syrk_tri1000: every array on the row-private / sweep-group closed
    forms: no sort and no kernel launch;
11-12. syrk1000, syr2k1000: the interleave overlays (62 of 63 windows
    take the O(lines) closed form, kernel 1 only in the ragged last
    one), the plan timed cold and then warm from a disk plan cache in a
    temp dir; held bit for bit against the same plan built without
    overlays, whose overlaid arrays sort in every window;
13. sliced: cholesky-2000 in thread batches of 2 and 1, equal to phase
    8's full run (kernel 1 once per window per batch); trmm-1000 with the
    device budget set to a quarter of its need, which the auto-dispatch
    ladder reroutes to one thread at a time, equal to phase 9's run; peak
    device memory against each budget;
14. sample: GEMM-1024 subset sampling, uniform at rates 0.05, 0.1 and
    0.25 (3, 6 and 16 of 64 windows, each warmed by one context window)
    and prefix at 0.05, each equal to a rerun with kernel 1's plain
    version; the walked fraction and the MRC L2 error against phase 6's
    full run; GEMM-128 sampled on the card and the CPU, exactly;
15. families: every one of the 29 registry families at n=16, on the card
    and on the CPU, exactly (syrk and syr2k on their overlays);
16. cli: ``python -m pluss_torch.cli acc`` on the card, in process;
17. trace: a 2^28-ref trace (``pluss_torch.tracegen.smoke_trace``: 2^27
   hot/warm refs, then 8 sequential sweeps over a second memory region)
   replayed with ``replay_file``'s defaults (d24v wire, feed pool; 16
   batches of 2^24), held against an independent golden (a replay of the
   hot/warm part alone plus the sweeps' hand-worked histogram), a rerun
   with the plain versions forced, the ``pack`` wire, a checkpoint/resume
   split, and (on a 2^24-ref prefix) the CPU; kernels 2 and 3 are also
   held against their plain versions and timed on the inputs the replay
   fed them for one real batch of each part (part A: raw 6-nibble d24v
   blocks; part B: mostly 1-nibble delta blocks), captured in the part-A
   golden replay and in the resumed leg;
18. trace_cli: ``python -m pluss_torch.cli trace`` on the card, in process;
19. resident: phase 17's trace packed on the d24v wire (and on u24 for
    its first batch, staged and replayed against the streamed prefix),
    staged into device memory (kernel 3 once per record, 16) and replayed
    from there three times at ``clock0`` 0, 1 and 2 (kernel 2 once per
    batch, 16), then again with the plain versions (the same staged bytes
    and histogram), on the legacy per-window scan (kernel 2 once per
    window, 256), and through ``replay_file(resident_cache=True)``: a cold
    stage-through whose published bytes equal the direct staging, a warm
    hit with no copy and no decode, and a budget of 1024 bytes that
    streams and publishes nothing; each equal to phase 17's replay;
20. the kernels line, the card's name and power limit, and the result line.

Every kernel launch count is set to 0 just before each main-path run
(phases 5-16, 17-18's first replay and phase 19's staging, first staged
replay, legacy scan, stage-through and hit) and read just after it: the
event kernel must launch once per plan window that sorts something (0 for
GEMM and syrk_tri, every window for mvt-4000, cholesky and trmm, the last
window of syrk and syr2k), per thread batch in a sliced run, and once
per counted sampled window; the masked
histogram and the decode once per trace batch (a resident replay: the
histogram once per batch, or per window on the legacy scan, and no
decode; staging a d24v pack: the decode once per record).  Every sampler
run must conserve its accesses (cold + no-share events + share events = refs).
The comparison launches of phases 2-4 and the cross-checks of phases 7,
8, 11-12, 14, 17 and 19 are not counted.  Exits non-zero, printing no
result, when there is no CUDA device or when run outside the repository.
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


def device_ms(fn, reps: int, prefix: str) -> tuple:
    """Per-call device milliseconds of ``fn()`` over ``reps`` calls after
    one warm-up, by ``torch.profiler``: the kernels whose symbol contains
    ``prefix`` (summed over a call's passes, as ``pluss_torch.profile``
    reads ``port_kernels``), and every device operation of the calls
    (kernels, memsets, copies).  The profiler now and then hands back no
    device events for a window: that window is profiled again, up to
    three times, and then both times are None (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ours = every = 0.0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                every += e.self_device_time_total
                if prefix in e.key:
                    ours += e.self_device_time_total
        if ours > 0:
            return ours / reps / 1e3, every / reps / 1e3
    return None, None


def random_unsorted(T: int, n_real: int, n_lines: int, span: int,
                    seed: int, pos64: bool = False):
    """Unsorted ``(line, pos, span, valid)`` rows shaped like a main-path
    sort window, and ``win_start [T]``: ``n_real`` accesses per row at
    distinct positions from ``win_start`` on, over ``n_lines`` lines; one
    ghost per line (a third never touched, pos -1; the rest carried from
    before the window); a third of the accesses carry a share span; a few
    are invalid.  ``pos64``: int64 positions shifted past 2^32, as a
    stream with more than 2^31 accesses per thread has them."""
    import torch

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
    pos = torch.cat([pos, gpos], 1)
    ws = torch.full((T,), win_start, dtype=torch.int32, device="cuda")
    if pos64:
        pos = torch.where(pos >= 0, pos.to(torch.int64) + (1 << 32), -1)
        ws = ws.to(torch.int64) + (1 << 32)
    return (torch.cat([line, gline], 1), pos,
            torch.cat([spn, torch.zeros_like(gpos)], 1),
            torch.cat([valid, torch.ones_like(gline, dtype=torch.bool)], 1)), ws


def random_windows(T: int, n_real: int, n_lines: int, span: int, seed: int,
                   pos64: bool = False):
    """:func:`random_unsorted`'s rows ghost-merged and sorted by (line,
    pos), as ``engine._sort_window`` hands them to the kernel."""
    from pluss_torch.ops.reuse import sort_stream

    rows, ws = random_unsorted(T, n_real, n_lines, span, seed, pos64)
    return sort_stream(*rows), ws


def kernel1_times(args, pos_bytes: int, tag: str = "") -> dict:
    """Kernel 1 against its plain version on sorted windows ``args``, bit
    for bit, timed beside its bytes bound."""
    import torch

    from pluss_torch.ops.event_hist import (event_histogram,
                                            event_histogram_plain)

    got = event_histogram(*args)
    want = event_histogram_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"kernel != plain ({args[1].dtype}{tag})")
    check(int(want.sum()) > 0, "random windows produced no events")
    T, L = args[0].shape
    return {
        f"ms{tag}": cuda_ms(lambda: event_histogram(*args), 20),
        f"device_ms{tag}": device_ms(lambda: event_histogram(*args), 20,
                                     "carried_event_hist")[0],
        f"plain_ms{tag}": cuda_ms(lambda: event_histogram_plain(*args), 3),
        f"bound_ms{tag}": (T * L * (4 + pos_bytes + 4 + 1) + T * 49 * 8)
        / HBM_BYTES_PER_S * 1e3,
        f"err{tag}": int((got - want).abs().max()),
    }


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


class FirstCall:
    """Replay kernels that run the real kernel wrappers and keep a copy of
    the inputs of each one's first call: one real batch's events and its
    d24v wire, as the main path feeds them."""

    def __init__(self):
        self.events = None
        self.wire = None

    def histogram(self, reuse, is_evt, share, cold, include_cold=True):
        from pluss_torch.ops.event_hist import masked_histogram

        if self.events is None:
            self.events = tuple(t.clone() for t in (reuse, is_evt, share,
                                                     cold))
        return masked_histogram(reuse, is_evt, share, cold, include_cold)

    def decode(self, payload, wm):
        from pluss_torch.ops.decode import decode_d24v

        if self.wire is None:
            self.wire = (payload.clone(), wm.clone())
        return decode_d24v(payload, wm)

    def kernels(self):
        from pluss_torch.trace import TraceKernels

        return TraceKernels(self.histogram, self.decode)


def time_trace_batch(cap: FirstCall) -> tuple[dict, dict]:
    """Kernels 2 and 3 on one captured trace batch, each against its plain
    version bit for bit and timed beside its bytes bound."""
    import numpy as np
    import torch

    from pluss_torch.config import NBINS
    from pluss_torch.ops import wirecodec
    from pluss_torch.ops.decode import decode_d24v
    from pluss_torch.ops.event_hist import (masked_histogram,
                                            masked_histogram_plain)

    ev = cap.events
    got, want = masked_histogram(*ev), masked_histogram_plain(*ev)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "masked_hist != plain (trace batch)")
    n = ev[0].numel()
    ms = cuda_ms(lambda: masked_histogram(*ev), 20)
    dev_ms, all_ms = device_ms(lambda: masked_histogram(*ev), 20,
                               "masked_hist")
    mh = {"n": n, "reuse_dtype": str(ev[0].dtype).removeprefix("torch."),
          "events": int(want[1:].sum()), "cold": int(want[0]),
          "nonzero_bins": int((want > 0).sum()),
          "max_abs_err": int((got - want).abs().max()),
          "ms": ms, "device_ms": dev_ms, "device_all_ms": all_ms,
          "plain_ms": cuda_ms(lambda: masked_histogram_plain(*ev), 3),
          "bound_ms": (n * (ev[0].element_size() + 3) + NBINS * 8)
          / HBM_BYTES_PER_S * 1e3}
    payload, wm = cap.wire
    got = decode_d24v(payload, wm)
    want = wirecodec.decode_d24v_plain(payload, wm)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "d24v_decode != plain (trace batch)")
    wm_np = wm.cpu().numpy()
    kinds, counts = np.unique(wm_np, return_counts=True)
    ms = cuda_ms(lambda: decode_d24v(payload, wm), 20)
    dev_ms, all_ms = device_ms(lambda: decode_d24v(payload, wm), 20, "d24v_")
    dec = {"blocks": int(wm.numel()),
           "wm_kinds": dict(zip(map(int, kinds), map(int, counts))),
           "payload_bytes": int(payload.numel()),
           "max_abs_err": int((got.long() - want.long()).abs().max()),
           "ms": ms, "device_ms": dev_ms, "device_all_ms": all_ms,
           "plain_ms": cuda_ms(
               lambda: wirecodec.decode_d24v_plain(payload, wm), 3),
           "bound_ms": (wirecodec.used_bytes(wm_np) + wm.numel()
                        + 4 * got.numel()) / HBM_BYTES_PER_S * 1e3}
    return mh, dec


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
    from pluss_torch.models import (REGISTRY, cholesky, gemm, mvt, syr2k,
                                    syrk, syrk_triangular, trmm)
    from pluss_torch.ops import build, wirecodec
    from pluss_torch.ops.decode import decode_d24v
    from pluss_torch.ops.event_hist import (event_histogram_plain,
                                            masked_histogram,
                                            masked_histogram_plain)
    from pluss_torch.ops.reuse import sort_stream
    from pluss_torch.spec import share_span_formula

    t_start = time.perf_counter()
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

    # 2. kernel vs plain at the main paths' shapes --------------------------
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
    for tag, pdt in (("", torch.int32), ("_int64", torch.int64)):
        kern.update(kernel1_times(
            (key_s, pos_s.to(pdt), span_s, valid_s, ws.to(pdt)),
            4 if pdt == torch.int32 else 8, tag))
    packed = key_s.to(torch.int64) << 32
    kern["sort_ms"] = cuda_ms(lambda: torch.sort(packed, dim=1), 5)
    del key_s, pos_s, span_s, valid_s, packed
    # cholesky-2000's largest window (its last size bucket), int64
    # positions; the window's two-pass stable sort timed on its unsorted
    # rows
    spec = cholesky(2000)
    c0 = engine.plan(spec, cfg).nests[0]
    brefs = c0.tri_buckets[-1][1]
    n_real = c0.window_rounds * cfg.chunk_size * sum(
        int(np.prod(fr.trips[1:])) for fr in brefs)
    n_lines = sum(c for _, c in engine._array_ranges(c0.refs, spec, cfg))
    rows, ws = random_unsorted(cfg.thread_num, n_real, n_lines,
                               share_span_formula(2000), seed=4, pos64=True)
    chol = {"T": cfg.thread_num, "L": rows[0].shape[1]}
    chol["sort_ms"] = cuda_ms(lambda: sort_stream(*rows), 3)
    srt = sort_stream(*rows)
    del rows
    chol.update(kernel1_times((*srt, ws), 8, "_int64"))
    del srt
    max_err = max(kern.pop("err"), kern.pop("err_int64"),
                  chol.pop("err_int64"))
    kern["cholesky2000_window"] = chol
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
        ms = cuda_ms(lambda: masked_histogram(*ev), 20)
        dev_ms, all_ms = device_ms(lambda: masked_histogram(*ev), 20,
                                   "masked_hist")
        mh.update({
            f"ms{tag}": ms, f"device_ms{tag}": dev_ms,
            f"device_all_ms{tag}": all_ms,
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
           **dict(zip(("device_ms", "device_all_ms"), device_ms(
               lambda: decode_d24v(payload, wm), 20, "d24v_"))),
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

    # 5-16. the sampler's main path, each run with the counts read around it
    def sort_windows(pl) -> int:
        """Sort-path windows of a plan, one kernel launch each: every
        window off the template path that has refs left to sort (a bounded
        nest whose arrays are all closed-form sorts nothing), and the
        template windows of a nest whose arrays without a template or an
        overlay still sort."""
        n = 0
        for np_ in pl.nests:
            ultra = np_.ultra_windows()
            n += int((~ultra).sum()) * bool(np_.refs) \
                + int(ultra.sum()) * bool(np_.var_refs_novl)
        return n

    def conserved(res) -> bool:
        """Every access is one cold miss, one no-share event or one share
        event."""
        return int(res.noshare_dense.sum()) + sum(
            sum(d.values()) for d in res.share_raw) \
            == res.max_iteration_count

    def acc_run(spec, label):
        # the plan alone first, cold: the run re-plans, with only the quad
        # nests' size tables memoized
        t3 = time.perf_counter()
        pl = engine.plan(spec, cfg)
        plan_s = time.perf_counter() - t3
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
        check(conserved(res), f"{label}: accesses not conserved")
        want = sort_windows(pl)
        check(launches == want, f"{label}: {launches} event-kernel launches, "
              f"the plan has {want} sort windows")
        n_lines = spec.total_lines(cfg)
        est = max(engine.sort_window_bytes(np_, cfg, pl.pos_dtype, n_lines)
                  for np_ in pl.nests) * cfg.thread_num
        return res, pl, {
            "engine_s": t1 - t0, "plan_s": plan_s, "cri_mrc_s": t2 - t1,
            "refs": res.max_iteration_count,
            "refs_per_s": res.max_iteration_count / (t1 - t0),
            "pos_dtype": str(pl.pos_dtype),
            "mrc_len": len(curve), "event_kernel_launches": launches,
            "sort_windows": want, "conserved": True,
            "peak_device_gib": peak / 2**30,
            "est_sort_gib": est / 2**30}

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

    # 8. cholesky-2000: quad nest, int64 positions, kernel 1 every window
    resc, plc, mc = acc_run(cholesky(2000), "cholesky2000")
    check(resc.max_iteration_count == 5_339_333_000, "cholesky2000 refs")
    check(plc.pos_dtype == np.int64, "cholesky2000 positions not int64")
    check(mc["event_kernel_launches"] == plc.nests[0].n_windows == 125,
          "cholesky2000 did not launch the event kernel in each of its "
          "125 windows")
    # the plain-version cross-check at full size when the script's time
    # allows it, else at n=1000 (its own kernel run beside it)
    n_x = 2000 if time.perf_counter() - t_start + 1.5 * mc["engine_s"] < 450 \
        else 1000
    plx = plc if n_x == 2000 else engine.plan(cholesky(n_x), cfg)
    kern_run = resc if n_x == 2000 else engine._execute(plx, dev)
    t0 = time.perf_counter()
    plain = engine._execute(plx, dev, event_hist=event_histogram_plain)
    mc.update({"plain_n": n_x, "plain_engine_s": time.perf_counter() - t0})
    check(bool((plain.noshare_dense == kern_run.noshare_dense).all())
          and plain.share_raw == kern_run.share_raw
          and plain.max_iteration_count == kern_run.max_iteration_count,
          f"cholesky{n_x}: kernel run != plain-version run")
    del plain, kern_run
    emit({"phase": "cholesky2000", **mc, "path": "sort (quad, buckets)",
          "plain_match": True, "ok": True})

    # 9. trmm-1000: varying starts, int32 positions, a sort in every window
    rest, plt, mt = acc_run(trmm(1000), "trmm1000")
    check(rest.max_iteration_count == 2_000_000_000, "trmm1000 refs")
    check(plt.pos_dtype == np.int32, "trmm1000 positions not int32")
    check(mt["event_kernel_launches"] == 63, "trmm1000: not 63 launches")
    emit({"phase": "trmm1000", **mt, "path": "sort (buckets)", "ok": True})

    # 10. syrk_tri-1000: every array closed-form, no sort, no launch
    ress, pls, ms = acc_run(syrk_triangular(1000), "syrk_tri1000")
    check(ress.max_iteration_count == 2_003_001_000, "syrk_tri1000 refs")
    check(not pls.nests[0].refs and pls.nests[0].rpg_hist is not None
          and ms["event_kernel_launches"] == 0,
          "syrk_tri1000 left the closed-form path")
    emit({"phase": "syrk_tri1000", **ms, "path": "closed_form", "ok": True})
    del ress

    # 11-12. syrk/syr2k-1000: interleave overlays against the sort path,
    # the plans through a disk plan cache in a temp dir, cold then warm
    cache_dir = tempfile.mkdtemp(prefix="pluss_torch_plans_")
    saved = {k: os.environ.pop(k, None) for k in ("PLUSS_NO_PLAN_CACHE",
                                                 "PLUSS_PLAN_CACHE_DIR")}
    os.environ["PLUSS_PLAN_CACHE_DIR"] = cache_dir
    try:
        for spec in (syrk(1000), syr2k(1000)):
            overlay_phase(spec, cfg, dev, by_path, sort_windows, conserved)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v

    # 13. cholesky-2000 in thread batches of 2 and 1 against the full run,
    # and trmm-1000 rerouted by the auto-dispatch ladder on a quarter of
    # its budget
    sliced_phase(cfg, by_path, resc, rest, sort_windows)
    del resc, rest

    # 14. subset sampling on GEMM-1024, against the full run's MRC
    sample_phase(cfg, by_path, res1k)

    # 15. every registry family at n=16: the card against the CPU ---------
    def families():
        out = {}
        for name in sorted(REGISTRY):
            sp = REGISTRY[name](16)
            if name in ("syrk", "syr2k"):
                check(bool(engine.plan(sp, cfg).nests[0].overlays),
                      f"{name}16: no overlay")
            on_card = engine.run(sp, cfg)
            on_cpu = engine.run(sp, cfg, device="cpu")
            check(bool((on_card.noshare_dense == on_cpu.noshare_dense).all())
                  and on_card.share_raw == on_cpu.share_raw
                  and on_card.max_iteration_count
                  == on_cpu.max_iteration_count and conserved(on_card),
                  f"{name}16: card != CPU")
            out[name] = sort_windows(engine.plan(sp, cfg))
        return out

    t0 = time.perf_counter()
    fam, counts = counted(families)
    by_path["families16"] = counts
    check(counts["carried_event_hist"] == sum(fam.values()),
          f"families: {counts['carried_event_hist']} launches, "
          f"{sum(fam.values())} sort windows")
    emit({"phase": "families", "n": 16, "models": len(fam),
          "seconds": time.perf_counter() - t0, "sort_windows": fam,
          "launches": counts, "overlays": ["syr2k", "syrk"],
          "card_vs_cpu": True, "ok": True})

    # 16. the CLI entry point on the card ------------------------------------
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

    # 17-18. the trace replay's main path, on a 2^28-ref trace -------------
    tmp = tempfile.mkdtemp(prefix="pluss_torch_smoke_")
    try:
        batches, streamed = trace_phases(tmp, by_path)
        # 19. the packed, device-resident replay of the same trace
        resident_phase(tmp, streamed, by_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 20. kernels line, card, result -----------------------------------------
    def launches_of(name):
        return {path: c[name] for path, c in by_path.items()}

    def row(name, source, replaces, m, err, **extra):
        lb = launches_of(name)
        per_batch = {part: b[name] for part, b in batches.items()
                     if name in b}
        err = max([err] + [b["max_abs_err"] for b in per_batch.values()])
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(lb.values()),
                "launches_by_path": lb, "match": True, "max_abs_err": err,
                "ms": m["ms"], "device_ms": m["device_ms"],
                "plain_ms": m["plain_ms"],
                "bound_ms": m["bound_ms"], "bound_by": "bytes",
                "library_ms": None, **extra,
                **({"trace_batch": per_batch} if per_batch else {})}

    emit({"kernels": [
        row("carried_event_hist", "pluss_torch/csrc/event_hist.cu",
            "pluss/ops/pallas_events.py:208", kern, max_err,
            cholesky2000_window=kern["cholesky2000_window"]),
        row("masked_hist", "pluss_torch/csrc/masked_hist.cu",
            "pluss/ops/pallas_events.py:263", mh, mh_err),
        row("d24v_decode", "pluss_torch/csrc/d24v_decode.cu",
            "pluss/ops/pallas_decode.py:130", dec, dec_err)]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def curve_of(res, cfg):
    from pluss_torch import cri, mrc

    return mrc.aet_mrc(cri.distribute(res.noshare_list(), res.share_list(),
                                      cfg.thread_num), cfg)


def same_result(a, b) -> bool:
    import numpy as np

    return bool(np.array_equal(a.noshare_dense, b.noshare_dense)) \
        and a.share_raw == b.share_raw \
        and a.max_iteration_count == b.max_iteration_count


def overlay_phase(spec, cfg, dev, by_path, sort_windows, conserved) -> None:
    """Phases 11-12: ``engine.run`` of syrk/syr2k-1000 with interleave
    overlays (plan timed cold, then warm from the disk cache the caller
    armed), held bit for bit against the same plan built without overlays
    on the card, whose overlaid arrays sort in every window."""
    import numpy as np
    import torch

    from pluss_torch import engine

    label = f"{spec.name}"
    t0 = time.perf_counter()
    pl = engine.plan(spec, cfg)
    plan_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = engine.plan(spec, cfg)
    plan_warm = time.perf_counter() - t0
    check(len(warm.nests[0].overlays) == len(pl.nests[0].overlays) > 0,
          f"{label}: the overlays did not engage or did not cache")
    path = engine.plan_path(pl)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, counts = counted(lambda: engine.run(spec, cfg))
    engine_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    by_path[label] = counts
    check(counts["carried_event_hist"] == sort_windows(pl),
          f"{label}: {counts['carried_event_hist']} launches, "
          f"{sort_windows(pl)} sort windows")
    check(conserved(res), f"{label}: accesses not conserved")
    curve = curve_of(res, cfg)
    check(curve[0] == 1.0 and bool((curve[1:] <= curve[:-1]).all())
          and bool(np.isfinite(curve).all()), f"{label}: MRC")
    t0 = time.perf_counter()
    off = engine.plan(spec, cfg, build_overlays=False)
    off_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_off, counts_off = counted(lambda: engine._execute(off, dev))
    off_s = time.perf_counter() - t0
    check(counts_off["carried_event_hist"] == sort_windows(off)
          == off.nests[0].n_windows, f"{label}: sort-path launches")
    check(same_result(res, res_off) and conserved(res_off),
          f"{label}: overlay run != sort-path run")
    ultra = pl.nests[0].ultra_windows()
    emit({"phase": label, "path": path, "refs": res.max_iteration_count,
          "windows": int(pl.nests[0].n_windows),
          "ultra_windows": int(ultra.sum()),
          "overlays": [ov.array for ov in pl.nests[0].overlays],
          "plan_cold_s": plan_cold, "plan_warm_s": plan_warm,
          "engine_s": engine_s, "refs_per_s": res.max_iteration_count
          / engine_s, "event_kernel_launches": counts["carried_event_hist"],
          "peak_device_gib": peak / 2**30,
          "sort_path": {"path": engine.plan_path(off), "plan_s": off_plan,
                        "device_s": off_s, "engine_s": off_plan + off_s,
                        "event_kernel_launches":
                        counts_off["carried_event_hist"]},
          "match": True, "conserved": True, "ok": True})


def sliced_phase(cfg, by_path, chol_full, trmm_full, sort_windows) -> None:
    """Phase 13: ``engine.run`` of cholesky-2000 with thread batches of 2
    and 1 (kernel 1 once per window per batch), equal to the full run;
    then trmm-1000 with the device budget set to a quarter of its need,
    which the auto-dispatch ladder reroutes to one thread at a time.  Peak
    device memory against the budget each run was held to."""
    import numpy as np
    import torch

    from pluss_torch import engine
    from pluss_torch.models import cholesky, trmm

    torch.cuda.empty_cache()
    out = {}
    spec = cholesky(2000)
    pl = engine._plan_cached(spec, cfg, None, None, None)
    n_lines = spec.total_lines(cfg)
    window = max(engine.sort_window_bytes(np_, cfg, pl.pos_dtype, n_lines)
                 for np_ in pl.nests)
    for tb in (2, 1):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res, counts = counted(lambda: engine.run(spec, cfg, thread_batch=tb))
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        by_path[f"cholesky2000_tb{tb}"] = counts
        batches = -(-cfg.thread_num // tb)
        check(counts["carried_event_hist"] == sort_windows(pl) * batches,
              f"cholesky2000 tb={tb}: launches {counts}")
        check(same_result(res, chol_full),
              f"cholesky2000 tb={tb} != the full run")
        out[f"cholesky2000_tb{tb}"] = {
            "engine_s": secs, "event_kernel_launches":
            counts["carried_event_hist"], "peak_device_gib": peak / 2**30,
            "est_sort_gib": window * tb / 2**30, "match": True}
        del res
    torch.cuda.empty_cache()
    spec = trmm(1000)
    pl = engine._plan_cached(spec, cfg, None, None, None)
    need = max(engine.sort_window_bytes(np_, cfg, pl.pos_dtype,
                                        spec.total_lines(cfg))
               for np_ in pl.nests) * cfg.thread_num
    budget = need // 4
    decision = engine._auto_dispatch(pl, cfg, None, budget)
    check(decision is not None and decision[0] == 1,
          f"trmm1000: ladder decision {decision}")
    real_budget = engine.sort_budget
    engine.sort_budget = lambda dev: budget
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res, counts = counted(lambda: engine.run(spec, cfg))
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        engine.sort_budget = real_budget
    by_path["trmm1000_rerouted"] = counts
    check(counts["carried_event_hist"] == sort_windows(pl) * cfg.thread_num,
          f"trmm1000 rerouted: launches {counts}")
    check(same_result(res, trmm_full), "trmm1000 rerouted != the full run")
    out["trmm1000_rerouted"] = {
        "engine_s": secs, "thread_batch": decision[0],
        "reason": decision[1], "event_kernel_launches":
        counts["carried_event_hist"], "peak_device_gib": peak / 2**30,
        "budget_gib": budget / 2**30, "need_gib": need / 2**30,
        "peak_over_budget": peak / budget, "match": True}
    emit({"phase": "sliced", **out, "ok": True})


def sample_phase(cfg, by_path, full) -> None:
    """Phase 14: ``sampling.sampled_run`` of GEMM-1024 (64 one-round
    windows) at uniform rates that fit the card and prefix at one rate,
    each equal to the same call with kernel 1's plain version, with the
    walked fraction and the MRC L2 error against the full run; then
    GEMM-128 sampled on the card and on the CPU, exactly."""
    import numpy as np
    import torch

    from pluss_torch import sampling
    from pluss_torch.models import gemm
    from pluss_torch.ops.event_hist import event_histogram_plain

    torch.cuda.empty_cache()
    spec = gemm(1024)
    full_curve = curve_of(full, cfg)
    nw = sampling._plan_cached(spec, cfg, None).nests[0].n_windows
    rows = []
    for mode, rate in (("uniform", 0.05), ("uniform", 0.1),
                       ("uniform", 0.25), ("prefix", 0.05)):
        label = f"sample_{mode}_{rate}"
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        est, counts = counted(lambda: sampling.sampled_run(
            spec, cfg, rate, seed=0, mode=mode))
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        by_path[label] = counts
        walks = max(1, round(rate * nw)) if mode == "uniform" \
            else min(nw - 1, max(0, round(rate * nw) - 1)) + 1
        check(counts["carried_event_hist"] == walks,
              f"{label}: {counts['carried_event_hist']} launches, {walks} "
              "counted windows")
        t0 = time.perf_counter()
        plain = sampling.sampled_run(spec, cfg, rate, seed=0, mode=mode,
                                     _event_hist=event_histogram_plain)
        plain_s = time.perf_counter() - t0
        check(bool(np.array_equal(est.noshare_dense, plain.noshare_dense))
              and est.share_raw == plain.share_raw
              and est.sampled_fraction == plain.sampled_fraction,
              f"{label}: kernel != plain version")
        curve = curve_of(est, cfg)
        check(bool(np.isfinite(curve).all()) and curve[0] == 1.0,
              f"{label}: MRC")
        rows.append({"mode": mode, "rate": rate, "seconds": secs,
                     "plain_s": plain_s, "counted_windows": walks,
                     "walked_fraction": est.sampled_fraction,
                     "l2_error": sampling.mrc_l2_error(curve, full_curve),
                     "peak_device_gib": peak / 2**30,
                     "event_kernel_launches": counts["carried_event_hist"],
                     "plain_match": True})
    small = gemm(128)
    for mode in ("uniform", "prefix"):
        kw = dict(rate=0.25, seed=1, window_accesses=1, mode=mode)
        on_card = sampling.sampled_run(small, cfg, **kw)
        on_cpu = sampling.sampled_run(small, cfg, device="cpu", **kw)
        check(bool(np.array_equal(on_card.noshare_dense,
                                  on_cpu.noshare_dense))
              and on_card.share_raw == on_cpu.share_raw
              and on_card.sampled_fraction == on_cpu.sampled_fraction,
              f"gemm128 sampled ({mode}): card != CPU")
    emit({"phase": "sample", "model": "gemm1024", "windows": nw,
          "rates": rows, "gemm128_card_vs_cpu": True, "ok": True})


def trace_phases(tmp: str, by_path: dict) -> tuple:
    """Phases 17 and 18: the streamed replay on the card, and its CLI.
    Returns kernels 2 and 3's measurements on one real batch of each part
    of the trace, and the streamed replay's result."""
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
    # part A's first batch (raw d24v blocks) and, in the resumed leg below,
    # part B's first (delta blocks) are captured as the main path feeds them
    cap_a, cap_b = FirstCall(), FirstCall()
    part_a = trace.replay_file(path, limit_refs=layout["part_a_refs"],
                               _kernels=cap_a.kernels())
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
    same(trace.replay_file(path, checkpoint_path=ckpt, resume=True,
                           _kernels=cap_b.kernels()),
         "checkpoint/resume split")
    batches = {}
    for part, cap in (("part_a", cap_a), ("part_b", cap_b)):
        mh, dec = time_trace_batch(cap)
        batches[part] = {"masked_hist": mh, "d24v_decode": dec}
    del cap_a, cap_b
    emit({"phase": "trace_batch", **batches, "ok": True})

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
    return batches, rep


def resident_phase(tmp: str, rep, by_path: dict) -> None:
    """Phase 19: the 2^28-ref trace of phase 17 packed (d24v, and u24 on
    its first batch), staged into device memory (kernel 3 once per d24v
    record) and replayed from there (kernel 2 once per batch, or once per
    window on the legacy scan), then through ``replay_file``'s
    residency store: a cold stage-through, a warm hit and a tiny budget.
    Every replay must equal the streamed replay ``rep`` bit for bit."""
    import numpy as np
    import torch

    from pluss_torch import residency, trace
    from pluss_torch.trace import PLAIN

    path = os.path.join(tmp, "smoke.bin")
    batch = trace.WINDOWS_PER_BATCH * trace.TRACE_WINDOW
    n_batches = -(-rep.total_count // batch)

    def same(other, what):
        check(np.array_equal(other.hist, rep.hist)
              and other.total_count == rep.total_count
              and other.n_lines == rep.n_lines, f"resident: {what}")

    out = {"refs": rep.total_count, "batches": n_batches}
    packed = os.path.join(tmp, "smoke.d24v")
    t0 = time.perf_counter()
    meta = trace.pack_file(path, packed, wire="d24v")
    out["pack_s"] = time.perf_counter() - t0
    out["pack_bytes"] = os.path.getsize(packed)
    check(meta["fmt"] == "d24v" and meta["n"] == rep.total_count
          and meta["n_lines"] == rep.n_lines,
          f"d24v sidecar {meta['n']}/{meta['n_lines']} != streamed")
    # the u24 pack of the first batch, staged and replayed
    u24 = os.path.join(tmp, "smoke.u24")
    t0 = time.perf_counter()
    meta24 = trace.pack_file(path, u24, limit_refs=batch)
    out["pack_u24_prefix_s"] = time.perf_counter() - t0
    prefix = trace.replay_file(path, limit_refs=batch)
    check(meta24["fmt"] == "u24" and meta24["n"] == prefix.total_count
          and meta24["n_lines"] == prefix.n_lines, "u24 sidecar != streamed")
    got = trace.replay_resident(u24, meta24)
    check(np.array_equal(got.hist, prefix.hist)
          and got.n_lines == prefix.n_lines, "u24 prefix: resident != stream")

    torch.cuda.reset_peak_memory_stats()
    (resident, n_run, info), counts = counted(
        lambda: trace.stage_resident(packed, meta))
    by_path["resident_stage"] = counts
    check(counts["d24v_decode"] == n_batches == 16
          and counts["masked_hist"] == 0, f"stage launches {counts}")
    out.update(upload_s=info["upload_s"], upload_bytes=info["upload_bytes"],
               resident_gib=resident.nbytes / 2**30, stage_launches=counts)
    replay_s = []
    for clock0 in (0, 1, 2):
        got, counts = counted(lambda: trace.replay_staged(
            resident, meta["n_lines"], n_run, clock0=clock0))
        by_path.setdefault("resident_replay", counts)
        check(counts["masked_hist"] == n_batches
              and counts["d24v_decode"] == 0,
              f"resident replay launches {counts}")
        same(got, f"replay_staged clock0={clock0}")
        replay_s.append(got.timing["replay_s"])
    out.update(replay_s=replay_s, refs_per_s=n_run / min(replay_s),
               peak_device_gib=torch.cuda.max_memory_allocated() / 2**30,
               replay_launches=by_path["resident_replay"])
    # the plain versions: the same bytes staged, the same histogram
    t0 = time.perf_counter()
    plain, _, _ = trace.stage_resident(packed, meta, _kernels=PLAIN)
    check(torch.equal(plain, resident), "stage: kernel 3 != plain bytes")
    same(trace.replay_staged(plain, meta["n_lines"], n_run, _kernels=PLAIN),
         "plain versions")
    out["plain_s"] = time.perf_counter() - t0
    del plain
    # the legacy per-window scan: one kernel-2 launch per window
    got, counts = counted(lambda: trace.replay_staged(
        resident, meta["n_lines"], n_run, segmented=False))
    by_path["resident_scan"] = counts
    check(counts["masked_hist"] == n_batches * trace.WINDOWS_PER_BATCH,
          f"legacy scan launches {counts}")
    same(got, "legacy scan")
    out["scan_s"] = got.timing["replay_s"]

    # the residency store behind replay_file
    residency.reset()
    cold, counts = counted(lambda: trace.replay_file(path,
                                                     resident_cache=True))
    by_path["stage_through"] = counts
    same(cold, "stage-through (cold)")
    store = residency.store()
    check(cold.timing["resident"] == "stage_through" and len(store) == 1,
          f"stage-through: {cold.timing.get('resident')}, {len(store)}")
    key = trace._residency_key(path, cls=64, window=trace.TRACE_WINDOW,
                               bw=trace.WINDOWS_PER_BATCH,
                               precompacted=False)
    ent = store.lookup_pin(key, n_run=n_run)
    check(ent is not None and torch.equal(ent.value, resident),
          "stage-through bytes != direct staging")
    store.unpin(key)
    del ent, resident
    warm, counts = counted(lambda: trace.replay_file(path,
                                                     resident_cache=True))
    by_path["resident_hit"] = counts
    same(warm, "warm hit")
    check(warm.timing["resident"] == "hit" and warm.timing["h2d_bytes"] == 0
          and counts["d24v_decode"] == 0
          and counts["masked_hist"] == n_batches,
          f"warm hit {warm.timing}, launches {counts}")
    residency.reset(budget=1024)
    tiny = trace.replay_file(path, resident_cache=True)
    same(tiny, "tiny budget")
    check(tiny.timing["resident"] == "fallback"
          and len(residency.store()) == 0, "tiny budget published")
    residency.reset()
    out.update(cold_wall_s=cold.timing["wall_s"],
               warm_wall_s=warm.timing["wall_s"],
               tiny_wall_s=tiny.timing["wall_s"],
               stage_through_launches=by_path["stage_through"],
               hit_launches=by_path["resident_hit"],
               scan_launches=by_path["resident_scan"])
    emit({"phase": "resident", **out, "match": True, "plain_match": True,
          "scan_match": True, "stage_through_match": True, "ok": True})


if __name__ == "__main__":
    sys.exit(main())
