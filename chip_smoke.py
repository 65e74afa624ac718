#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives ``pluss_torch``'s two main paths on the card — the sampler
(``engine.run`` -> ``cri.distribute`` -> ``mrc.aet_mrc`` -> the ``acc``
block; with its overlays, sliced runs and ``sampling.sampled_run``) and
the trace replay (``trace.replay_file`` -> the ``trace`` block, streamed
and through the residency store; ``pack_file`` -> ``stage_resident`` ->
``replay_staged``) — the static analysis modes, whose cross-checks run
the sampler there, the authoring and transform modes, whose specs run
there, the autotuner, the schedule sweep and the serving daemon,
which run both paths there, and the multi-device layer, which runs both
paths sharded there (``parallel.shard_run``, ``trace.shard_replay_file``,
process groups on ``torch.distributed``), and the native C++ runtime on
the host (``pluss_torch.native``), the independent sampler the card's
results are held against — and holds every kernel of
those paths against its plain torch version.  Each phase prints one JSON line; any failed check
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
    streams part A (cut from the whole trace for the script's time) and
    publishes nothing; each equal to phase 17's replay (of part A);
20. telemetry: mvt-4000 and phase 17's replay of part A (cut from the
    whole trace for the script's time) again, with a telemetry
    session writing to a temp ``events.jsonl`` (``pluss_torch.obs``):
    each equal bit for bit to its telemetry-off run, with the same kernel
    launch counts; the stream passes ``stats --check``, its
    ``engine.refs_processed`` and ``trace.refs_replayed`` equal the refs
    run, and its ``trace replay breakdown`` lines are printed beside the
    on and off walls (off: the earlier phase's run and one more after the
    on run);
21. resilience: ``run_resilient`` (``pluss_torch.resilience``) of (a)
    mvt-4000 under ``PLUSS_FAULT_PLAN=oom`` (stamp ``shrink_window``),
    (b) trmm-1000 under ``oom,oom@2,oom@3`` (the last rung
    ``sliced_pipeline``), (c) cholesky-2000 with no fault plan in a
    process capped by ``torch.cuda.set_per_process_memory_fraction`` at
    about half of its full run's peak, so the card's own
    ``torch.OutOfMemoryError`` stops the first attempt and a later rung
    fits (the rungs limited to the card's three; the ``resilience.rung``
    events of a telemetry session name each failed attempt's raw cause,
    which must be that error, and the first must come after kernel-1
    launches, not from the plan-time budget guard), and (d) a small
    sort-path model walked down to ``cpu_fallback``, whose stamp names it
    while a later plain run still launches on the card; each equal to its
    clean run; (e) every result of phases 5-19 carries the empty stamp;
22. analysis: the static analysis modes (``pluss_torch.analysis``) and
    their engine cross-checks: (a) ``cli predict --all --n 16`` alone
    (host work: no dispatch, no launch, no device allocation), equal to
    the same command with ``--cpu``, then with ``--check --json`` on the
    card, whose document (every derivable family bit-identical to its
    engine run) equals ``--check --cpu``'s; (b) GEMM-512's closed-form
    prediction against the card's engine (template path, no kernel-1
    launch) and (c) mvt-2000's dense prediction against template + sort
    (kernel 1 once per sort window), each with its host predict and card
    engine seconds (both cut from GEMM-1024 and mvt-4000 for the script's
    time);
    (d) ``cli tune mvt --n 1000`` alone (host), then with ``--check``:
    the same search, and the winner's one engine run on the card
    verifies; (e) ``cli lint --all``, ``analyze --model gemm --n 128`` and
    ``cotenancy gemm+syrk --n 16 --check`` as host work, and ``spec dump
    gemm`` then ``spec load <file> --run``, whose block below the banner
    is phase 16's ``acc`` block;
23. frontend: the authoring and transform modes (``pluss_torch.frontend``,
    ``pluss_torch.analysis.transform``): (a) the pragma-C GEMM source at
    ``#define N 1024`` through ``cli import --run --check-model gemm``,
    byte-identical to the registry model and, below the banner, to phase
    6's block (template path, no kernel-1 launch); (b) cholesky-2000
    emitted as DSL (a file whose first line is ``from pluss import
    frontend``), imported codec-equal to the registry spec, and run once
    on the card: equal bit for bit to phase 8's run, int64 positions, 125
    launches; mvt-4000 emitted likewise through ``cli import --run
    --check-model mvt``, equal to phase 7's block (4 launches a run); (c)
    the PolyBench corpus (``frontend.polybench``, five families),
    analyzer-clean, each on the card and the CPU, exactly, conserving its
    accesses; (d) ``cli transform gemm --n 128`` (cut from 256 for the
    script's time) with ``--interchange 0,2`` and with ``--tile
    0:32,1:32,2:32``, each ``--check --json``:
    the card's engine run of the transformed spec bit-identical to its
    host prediction; ``cli tune gemm --transforms --n 64 --cache-kb 1
    --check`` (a tiled winner, its engine run verified); and ``transform
    seidel2d --n 16 --interchange 0,1 --check``, refused with PL952 with
    no dispatch, no launch and no device allocation;
24. autotune: under a temporary plan-cache directory,
    ``autotune.calibrate(force=True)`` at 2^20 refs times the port's eight
    grid points (two replays each; kernel 2 twice per point, kernel 3
    twice but on the pack point), every point's histogram bit-identical to
    the first; the winner persisted under a salt naming the card and
    ``sm_90``; a second ``calibrate()`` short-circuits on one
    ``autotune.hit``; ``replay_file`` with no geometry kwargs replays under
    the tuned values, the same histogram; ``cli autotune --dry-run``
    exits 0, and 1 on a doctored salt (``autotune.stale``);
25. sweep: ``sweep.sweep(mvt(4000), (1, 2, 4), (4,), journal=...)``, each
    point equal to a solo ``engine.run`` + ``cri.distribute`` +
    ``mrc.aet_mrc`` (kernel 1: 16 + 8 + 4 launches); resumed, no launch
    and every point stamped ``journal``; ``device_groups=2``, one group
    on one card, equal points; ``cli sweep --model gemm --n 64`` on the
    card prints what ``--cpu`` prints;
26. serve: an in-process daemon on a unix socket in a temp dir, warmed
    with mvt-4000 and GEMM-1024, with a journal, a flight dir and a
    metrics endpoint: (a) four pipelined mvt-4000 requests differing in
    ``cache_kb``/``output`` share one dispatch (``batched`` 4, kernel 1 four
    times), each equal to phase 7's run (a first round of the same four
    primes admission's price memo and the plans); (b) GEMM-1024 as a model and as a
    pragma-C ``source`` request, phase 6's histogram and MRC, no launch;
    (c) two trace requests on phase 17's trace: a stage-through (kernels 3
    and 2 sixteen times each), then a resident hit (kernel 2 sixteen
    times, kernel 3 none), each equal to phase 17's replay; no degradation
    in (a)-(c) and no brown-out; (d) ``dispatch_fail@1,dispatch_fail@2``
    open the breaker (threshold 2): a GEMM-64 request browns out on the
    CPU, stamped ``cpu_brownout`` and equal to the card's run, a trace
    request is shed ``Overloaded`` with ``retry_after_ms``, and the probe
    after the cooldown closes the breaker; (e) ``hang@1`` on a daemon with
    a 2 s dispatch timeout is abandoned and answered typed, its flight
    dump passing ``stats --check``; (f) ``{"op": "metrics"}`` equals ``GET
    /metrics``, a ``{"op": "shutdown"}`` line drains the daemon, every
    journaled request is done, and the event stream passes ``stats
    --check`` with ``stats --trace a0`` resolving admit → queue → dispatch
    → demux; each request's latency and the SLO p50/p99 are printed
    beside the card line;
27. shard: the multi-device layer (``pluss_torch.parallel``): (a)
    cholesky-2000 through ``shard_run``, steal with one worker and with
    four workers on ``cuda:0`` (kernel 2 once per thread and window) and
    static with one device on the legacy windows (kernel 1 once per
    window), each equal to phase 8's run; (b) cholesky-700 (cut from 1000
    for the script's time) at four workers under steal seeds 0 and 1:
    equal results, different chunk -> worker maps; (c) part A of phase
    17's trace (its first 2^27 refs, written to a file of its own; the
    whole trace until the script's time limit called for a cut) through
    ``shard_replay_file``, steal at four workers and static at one device
    (kernel 2 eight times each), equal to phase 17's replay of part A;
    (d) two gloo ranks sharing the
    card (``torch.distributed`` through a file rendezvous), static
    ``shard_run`` of trmm-1000 equal to ``engine.run``, and a world of one
    under NCCL; (e) ``run_resilient(backend="shard")`` of mvt-4000 under
    ``shard_oom@1``, recovered on ``shrink_window``, equal to phase 7's
    run; (f) ``cli acc --model gemm --n 128`` with the default backends
    (vmap, shard, seq): three blocks, each phase 16's below its banner,
    and ``stats`` of its telemetry shows the ``shard scale-out:`` block;
28. native: the card's engine and replay against the port's native C++
    runtime (``pluss_torch/cpp``, built into ``pluss_torch/_build/``; it
    runs on the host, not the card): (a) its library and ``pluss_cpp``
    binary built at once, with each one's seconds; (b) ``pluss_cpp acc
    128`` prints phase 16's block below the banner; (c) all 29 families
    at n=16, the card's ``engine.run`` against ``native.run`` (per-thread
    histograms and access counts exactly, CRI keys exactly and values
    within 1e-11 relative, the MRC within L2 1e-12); (d) mvt-4000 (kernel
    1: 4) and cholesky-1000 (PolyBench LARGE is 2000: its native run is
    predicted from cholesky-1000's time and taken only under 60 s) the
    same way; (e) trmm-500 (cut from 1000 for the script's time) through
    ``write_spec_file`` and ``pluss_cpp acc --spec``, the card's block
    below the banner (kernel 1 once per window); (f)
    ``native.replay`` of phase 17's first 2^24 refs against the card's
    ``replay_file`` of them (phase 17's) and of their line ids written as
    a precompacted trace (kernels 2 and 3 once); (g) on those ids, two
    gloo ranks sharing the card and NCCL at world
    1: ``shard_replay`` and ``shard_replay_file(precompacted=True)`` equal
    to the single-device ``replay_file`` bit for bit (kernel 2 once per
    rank each), and ``cli trace --backends shard`` on the raw prefix equal
    below the banner to the in-memory sharded block (world 2) or the
    single-process block (world 1); the native seconds beside the card's,
    with the card's name and power limit and the host CPU;
29. soak: one ``ri.derive`` at each of the serve soak's placement sizes
    on the card and at the next size of its ladder (the placement cut's
    reason, host seconds); then the port's soak harness (``python -m
    pluss_torch.soak``) on the card, each mode a subprocess with its
    fixed seed printed (the serve soak first, alone until it has passed
    its crash/recover phase; then the property and chaos soaks beside its
    placement and observability phases), after the kernels were built
    here (phase 1), so the subprocesses load that build: (a) the property soak at 60 examples (random specs card ==
    CPU, random schedules, ``shard_run`` over 1, 2 and 4 copies of the
    card, steal and static); (b) the chaos soak at 6 rounds on
    mvt-4000, trmm-1000, GEMM-1024, GEMM-512 and syrk-500 plus the
    sweep kill at GEMM-256; (c) the serve soak at 16 requests with
    ``--telemetry``, then its later phases, each on the card: six
    requests for a fresh 2^24-ref trace at window 2^18 (cold, then
    resident hits at least 5x faster), a journaled daemon SIGKILLed with
    three requests queued and a ``--recover`` daemon replaying them (3
    recovered, at most 2 device dispatches), the placement arms on and
    off (at the cut sizes of ``soak.PLACEMENT_N``; choices >= 1 and 0),
    and the observability daemon (breaker, flight dump, four traced ids
    resolved, none browned out), then ``python -m pluss_torch.cli stats
    --check`` on the first daemon's stream (``cli.main`` in this
    process).  Each must exit 0; kernel 1 must launch in all three (in
    (c) in its daemons), kernel 2 in (a) and in (c)'s daemons (the trace
    requests), kernel 3 in (c)'s daemons (the d24v wire); each mode's
    seconds and launches, and (c)'s later phases' numbers, on the
    phase's line;
30. the kernels line, the card's name and power limit, and the result line.

Every kernel launch count is set to 0 just before each main-path run
(phases 5-16, 17-18's first replay, phase 19's staging, first staged
replay, legacy scan, stage-through and hit, every run of phases 20-21,
phase 22's ``--check``, engine and ``spec load --run`` runs, phase
23's ``import``, engine, corpus, ``transform`` and ``tune`` runs, each
of phase 24's calibration points and its tuned replay, phase 25's
sweeps and CLI run, phase 26's requests (a)-(d), and each of phase 27's
runs but the ranks of (d), which count their own, and each of phase 28's
card runs but the ranks of (g), which count their own; phase 29's soak
processes and the serve soak's daemons count their own)
and read just after it: the
event kernel must launch once per plan window that sorts something (0 for
GEMM and syrk_tri, every window for mvt-4000, cholesky and trmm, the last
window of syrk and syr2k), per thread batch in a sliced run, and once
per counted sampled window; the masked
histogram and the decode once per trace batch (a resident replay: the
histogram once per batch, or per window on the legacy scan, and no
decode; staging a d24v pack: the decode once per record; a sharded
run: the masked histogram once per thread and segmented window, the event
kernel once per legacy window, the masked histogram once per sharded
replay chunk or step).  Every sampler
run must conserve its accesses (cold + no-share events + share events = refs).
The comparison launches of phases 2-4 and the cross-checks of phases 7,
8, 11-12, 14, 17 and 19 are not counted.  Exits non-zero, printing no
result, when there is no CUDA device or when run outside the repository.
"""

from __future__ import annotations

import contextlib
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


#: the script's start, for the elapsed seconds on every phase line
T_START = time.perf_counter()


def emit(obj: dict) -> None:
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


#: (label, degradations) of every main-path result of phases 5-19: a plain
#: run never degrades, so each stamp must be empty (phase 21 (e))
STAMPS: list[tuple[str, tuple]] = []


def clean(label: str, res):
    """Record ``res``'s resilience stamp, which must be empty; return it."""
    STAMPS.append((label, res.degradations))
    check(res.degradations == (), f"{label}: stamped {res.degradations}")
    return res


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
        clean(label, res)
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
            on_card = clean(f"{name}16", engine.run(sp, cfg))
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
        rc = cli.main(["acc", "--backends", "vmap", "--model", "gemm",
                       "--n", "128"])
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
        batches, streamed, prefix, part_a = trace_phases(tmp, by_path)
        # 19. the packed, device-resident replay of the same trace
        resident_phase(tmp, streamed, by_path, prefix, part_a)
        # 20. the mvt-4000 run and the streamed replay under telemetry
        telemetry_phase(tmp, cfg, by_path, resm, by_path["mvt4000"], part_a)
        # 21. the degradation ladder: injected faults, a genuine card OOM,
        # the CPU rung, and the empty stamps of every earlier phase
        resilience_phase(tmp, cfg, by_path, resm, rest, resc,
                         mc["peak_device_gib"])
        del rest

        # 22. the static analysis modes and their engine cross-checks
        analysis_phase(cfg, by_path, sort_windows, lines)

        # 23. the authoring and transform modes, their specs on the card
        frontend_phase(cfg, by_path, sort_windows, conserved, res1k, resm,
                       resc)

        # 24. the autotuner, its winner persisted for this card
        autotune_phase(by_path, os.path.join(tmp, "smoke.bin"), part_a)
        # 25. the schedule sweep, journaled and resumed
        sweep_phase(cfg, by_path, sort_windows)
        # 26. the serving daemon, on phase 17's trace among others
        serve_lines = serve_phase(tmp, cfg, by_path, streamed, resm, res1k)
        # 27. the multi-device layer: shard_run, the sharded replay,
        # process groups, the shard ladder and the CLI's three backends
        shard_phase(tmp, cfg, by_path, resc, part_a, resm, lines)
        # 28. the card's engine and replay against the native C++ runtime
        native_phase(tmp, cfg, by_path, lines, resc, prefix, sort_windows)
        # 29. the soak harness: property, chaos and serve soaks
        soak_phase(tmp, by_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 30. kernels line, card, result -----------------------------------------
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
    for line in serve_lines:
        print(line, flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


#: one rank of phase 27 (d): a process group of ``world`` ranks through a
#: file rendezvous, static ``shard_run`` of trmm-1000 on this rank's card,
#: the result (rank 0) and the exchange's route to a JSON file
_SHARD_RANK = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from pluss_torch.config import SamplerConfig
from pluss_torch.models import trmm
from pluss_torch.ops.event_hist import masked_histogram
from pluss_torch.parallel import multihost
from pluss_torch.parallel.shard import shard_run
rendezvous, world, rank, backend, out = sys.argv[2:7]
world, rank = int(world), int(rank)
t0 = time.perf_counter()
multihost.initialize(rendezvous, world, rank, device="cuda", backend=backend)
init_s = time.perf_counter() - t0
probe = None
if backend == "gloo":
    # whether this build's gloo moves CUDA tensors itself (the exchange
    # stages gloo's tensors through host memory either way)
    try:
        x = torch.full((1,), rank, device="cuda", dtype=torch.int64)
        y = torch.empty(world, device="cuda", dtype=torch.int64)
        dist.all_gather_into_tensor(y, x)
        probe = y.cpu().tolist() == list(range(world))
    except Exception as e:
        probe = f"{type(e).__name__}: {str(e)[:200]}"
masked_histogram.launches = 0
t0 = time.perf_counter()
res = shard_run(trmm(1000), SamplerConfig(),
                devices=multihost.global_devices("cuda"), dispatch="static")
run_s = time.perf_counter() - t0
doc = {"rank": rank, "init_s": init_s, "run_s": run_s,
       "launches": masked_histogram.launches, "gloo_cuda_allgather": probe,
       "stats": res.dispatch_stats}
if rank == 0:
    doc.update(hist=res.noshare_dense.tolist(), count=res.max_iteration_count,
               share=[{str(k): v for k, v in d.items()}
                      for d in res.share_raw])
json.dump(doc, open(f"{out}.{rank}", "w"))
dist.barrier()
dist.destroy_process_group()
"""


def shard_ranks(tmp: str, world: int, backend: str, script: str = _SHARD_RANK,
                tag: str = "", args=()) -> list[dict]:
    """Run ``script`` (default :data:`_SHARD_RANK`) as ``world`` processes
    on the card through a file rendezvous in ``tmp``, each given the repo,
    the rendezvous, the world, its rank, ``backend``, its output stem and
    ``args``; every rank must exit 0 within its time limit (the rest are
    killed); returns their JSON documents."""
    import torch

    # the ranks size their sort budgets from the card's free memory: this
    # process's cached blocks go back to the card first
    torch.cuda.empty_cache()
    repo = os.path.dirname(os.path.abspath(__file__))
    rdv = os.path.join(tmp, f"rdv{tag}_{backend}_{world}")
    out = os.path.join(tmp, f"ranks{tag}_{backend}_{world}.json")
    logs = [open(os.path.join(tmp, f"rank{tag}_{backend}_{i}.log"), "w+")
            for i in range(world)]
    procs = []
    try:
        for i in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script, repo, f"file://{rdv}",
                 str(world), str(i), backend, out, *args],
                stdout=logs[i], stderr=subprocess.STDOUT))
        for p_, lg in zip(procs, logs):
            try:
                rc = p_.wait(timeout=240)
            except subprocess.TimeoutExpired:
                rc = "timeout"
            lg.seek(0)
            check(rc == 0, f"{backend} rank exited {rc}: {lg.read()[-3000:]}")
    finally:
        for p_ in procs:
            if p_.poll() is None:
                p_.kill()
                p_.wait()
        for lg in logs:
            lg.close()
    return [json.load(open(f"{out}.{i}")) for i in range(world)]


def shard_phase(tmp: str, cfg, by_path: dict, resc, part_a, resm,
                acc_lines) -> None:
    """Phase 27: the multi-device layer (``pluss_torch.parallel``) on the
    card: (a) cholesky-2000 through ``shard_run``, steal with one worker
    and with four workers on ``cuda:0`` (each under its own stream;
    kernel 2 once per thread and window) and static with one device on
    the legacy windows (kernel 1 once per window), each equal to phase 8's
    run; (b) cholesky-700 at four workers under steal seeds 0 and 1:
    equal results, different chunk -> worker maps; (c) part A of phase
    17's trace (its first 2^27 refs) through ``shard_replay_file``, steal
    at four workers and static at one device (kernel 2 once per 2^24-ref
    chunk or step, 8), each equal to phase 17's replay of part A; (d) two
    gloo ranks sharing the card, static ``shard_run`` of trmm-1000 equal
    to ``engine.run`` (with the route
    their exchange took), and a world of one under NCCL; (e)
    ``run_resilient(backend="shard")`` of mvt-4000 under ``shard_oom@1``,
    recovered on ``shrink_window`` and equal to phase 7's run; (f) ``cli
    acc --model gemm --n 128`` with the default backends: three blocks
    with the goldens, and ``stats`` of its telemetry shows the steal
    run's ``shard scale-out:`` block."""
    import numpy as np
    import torch

    from pluss_torch import engine, trace
    from pluss_torch.models import cholesky, mvt, trmm
    from pluss_torch.parallel import shard
    from pluss_torch.resilience import run_resilient

    out: dict = {}
    t_phase = time.perf_counter()
    card = torch.device("cuda", 0)
    T = cfg.thread_num

    def sort_launches(pl, per_thread: bool) -> int:
        # every shard window sorts: the plan has no overlays and no
        # row-private tables, and a template window sorts its other arrays
        n = sum(int((~np_.ultra_windows()).sum())
                + int(np_.ultra_windows().sum()) * bool(np_.var_refs)
                for np_ in pl.nests)
        return n * (T if per_thread else 1)

    # (a) cholesky-2000 three ways
    runs = (("steal1", [card], "steal", True),
            ("steal4", [card] * 4, "steal", True),
            ("static1_legacy", [card], "static", False))
    for label, devs, mode, seg in runs:
        torch.cuda.reset_peak_memory_stats()
        ms0 = torch.cuda.memory_stats()
        t0 = time.perf_counter()
        res, counts = counted(lambda: shard.shard_run(
            cholesky(2000), cfg, devices=devs, dispatch=mode,
            segmented=seg))
        dt = time.perf_counter() - t0
        ms1 = torch.cuda.memory_stats()
        clean(f"shard_cholesky_{label}", res)
        by_path[f"shard_cholesky_{label}"] = counts
        pl, _ = shard._shard_geometry(cholesky(2000), cfg, len(devs), None,
                                      None, None)
        want = sort_launches(pl, seg)
        got = counts["masked_hist" if seg else "carried_event_hist"]
        check(same_result(res, resc), f"cholesky2000 shard {label} != "
              "engine.run")
        check(got == want and counts["d24v_decode"] == 0
              and counts["carried_event_hist" if seg else "masked_hist"]
              == 0, f"cholesky2000 shard {label}: launches {counts}, the "
              f"plan wants {want}")
        out[f"cholesky2000_{label}"] = {
            "seconds": dt, "launches": counts, "windows": pl.nests[0]
            .n_windows, "stats": {k: v for k, v in res.dispatch_stats.items()
                                  if k != "ran_by"},
            "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
            "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
            # the caching allocator's calls to the driver during the run
            # (a cudaFree waits for the whole card)
            "allocator": {k: ms1.get(k, 0) - ms0.get(k, 0) for k in (
                "num_device_alloc", "num_device_free",
                "num_alloc_retries")}}

    # (b) steal seeds permute the schedule, never the result
    small = cholesky(700)
    ref = engine.run(small, cfg)
    maps = []
    t0 = time.perf_counter()
    for seed in (0, 1):
        res, counts = counted(lambda: shard.shard_run(
            small, cfg, devices=[card] * 4, dispatch="steal",
            steal_seed=seed))
        by_path[f"shard_cholesky700_seed{seed}"] = counts
        check(same_result(res, ref), f"cholesky700 seed {seed} != engine")
        maps.append(res.dispatch_stats["ran_by"])
    check(maps[0] != maps[1], "steal seeds 0 and 1 ran the same schedule")
    out["cholesky700_seeds"] = {"seconds": time.perf_counter() - t0,
                                 "chunks": len(maps[0]),
                                 "moved": sum(maps[0][c] != maps[1][c]
                                              for c in maps[0])}

    # (c) part A of the 2^28-ref trace, sharded
    path = os.path.join(tmp, "part_a.bin")
    np.fromfile(os.path.join(tmp, "smoke.bin"), dtype="<u8",
                count=part_a.total_count).tofile(path)
    geo = dict(window=trace.TRACE_WINDOW, batch_windows=16)
    chunks = part_a.total_count // (16 * trace.TRACE_WINDOW)
    for label, devs, mode in (("steal4", [card] * 4, "steal"),
                              ("static1", [card], "static")):
        t0 = time.perf_counter()
        rep, counts = counted(lambda: trace.shard_replay_file(
            path, devices=devs, dispatch=mode, **geo))
        dt = time.perf_counter() - t0
        by_path[f"shard_trace_{label}"] = counts
        check(np.array_equal(rep.hist, part_a.hist)
              and rep.total_count == part_a.total_count,
              f"shard_replay_file {label} != replay_file of part A")
        check(counts["masked_hist"] == chunks == 8
              and counts["d24v_decode"] == 0
              and counts["carried_event_hist"] == 0,
              f"shard_replay_file {label}: launches {counts}")
        out[f"trace_{label}"] = {"seconds": dt, "launches": counts,
                                 "refs_per_s": rep.total_count / dt}
    os.unlink(path)

    # (d) processes: two gloo ranks on the one card, NCCL at world 1
    want = engine.run(trmm(1000), cfg)
    # what the card holds before the ranks start (``shard_ranks`` returns
    # this process's cached blocks to the card first)
    out["card_gib_before_ranks"] = {
        "free": torch.cuda.mem_get_info()[0] / 2**30,
        "allocated_here": torch.cuda.memory_allocated() / 2**30,
        "reserved_here": torch.cuda.memory_reserved() / 2**30}
    t0 = time.perf_counter()
    for backend, world in (("gloo", 2), ("nccl", 1)):
        docs = shard_ranks(tmp, world, backend)
        got = docs[0]
        check(got["count"] == want.max_iteration_count
              and got["hist"] == want.noshare_dense.tolist()
              and got["share"] == [{str(k): v for k, v in d.items()}
                                   for d in want.share_raw],
              f"{backend} x{world} static shard_run != engine.run")
        check(all(d["launches"] > 0 for d in docs),
              f"{backend}: a rank launched no kernel")
        out[f"trmm1000_{backend}{world}"] = {
            "ranks": [{k: d[k] for k in ("rank", "init_s", "run_s",
                                         "launches", "gloo_cuda_allgather")}
                      for d in docs],
            "exchange": "nccl, device tensors" if backend == "nccl"
            else "gloo, staged through host memory"}
    out["processes_s"] = time.perf_counter() - t0

    # (e) the shard ladder under an injected OOM
    saved = os.environ.get("PLUSS_FAULT_PLAN")
    os.environ["PLUSS_FAULT_PLAN"] = "shard_oom@1"
    try:
        t0 = time.perf_counter()
        res, counts = counted(lambda: run_resilient(mvt(4000), cfg,
                                                    backend="shard"))
    finally:
        os.environ.pop("PLUSS_FAULT_PLAN")
        if saved is not None:
            os.environ["PLUSS_FAULT_PLAN"] = saved
    by_path["shard_ladder"] = counts
    check(res.degradations == ("shrink_window",) and same_result(res, resm),
          f"shard ladder: stamped {res.degradations}")
    out["ladder_mvt4000"] = {"seconds": time.perf_counter() - t0,
                             "degradations": list(res.degradations),
                             "launches": counts}

    # (f) the CLI's three blocks and the steal telemetry
    ev = os.path.join(tmp, "shard_events.jsonl")
    t0 = time.perf_counter()
    (rc, so, se), counts = counted(lambda: cli_call(
        ["acc", "--model", "gemm", "--n", "128", "--telemetry", ev]))
    by_path["shard_cli"] = counts
    check(rc == 0, f"cli acc: rc {rc}: {se[-2000:]}")
    banners = [ln.split(":")[0] for ln in so.splitlines()
               if ln.startswith("TORCH CUDA")]
    check(banners == ["TORCH CUDA", "TORCH CUDA SHARD", "TORCH CUDA SEQ"],
          f"cli acc banners {banners}")
    # each block below its banner is phase 16's (the GEMM-128 goldens)
    blocks = [b.split("\n", 1)[1] for b in so.split("TORCH CUDA")[1:]]
    check(all(b.splitlines() == acc_lines[1:] for b in blocks)
          and acc_lines[-3:] == ["max iteration traversed", "8421376", ""],
          "cli acc: a backend's block differs from phase 16's")
    from pluss_torch import obs

    obs.configure(None)
    rc, st, se = cli_call(["stats", ev])
    check(rc == 0 and "shard scale-out:" in st, f"stats: {se[-2000:]}")
    out["cli"] = {"seconds": time.perf_counter() - t0, "launches": counts,
                  "stats_lines": [ln for ln in st.splitlines()
                                  if "chunks" in ln or "busy" in ln]}
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "shard", **out, "ok": True})


#: one rank of phase 28 (g): a process group of ``world`` ranks through a
#: file rendezvous on this rank's card; the sharded replays of a
#: precompacted trace (``shard_replay`` and ``shard_replay_file``) and
#: ``cli trace --backends shard`` on the raw trace, each with its kernel-2
#: launches, to a JSON file
_REPLAY_RANK = r"""
import io, json, os, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch.distributed as dist
from pluss_torch import cli, trace
from pluss_torch.ops.event_hist import masked_histogram
from pluss_torch.parallel import multihost
rendezvous, world, rank, backend, out, ids_path, raw_path = sys.argv[2:9]
world, rank = int(world), int(rank)
multihost.initialize(rendezvous, world, rank, device="cuda", backend=backend)
devs = multihost.global_devices("cuda")
ids = np.fromfile(ids_path, dtype="<u8").astype(np.int64)
doc = {"rank": rank}
for label, fn in (
        ("shard_replay", lambda: trace.shard_replay(
            ids, devices=devs, precompacted=True)),
        ("shard_replay_file", lambda: trace.shard_replay_file(
            ids_path, devices=devs, precompacted=True))):
    masked_histogram.launches = 0
    t0 = time.perf_counter()
    rep = fn()
    doc[label] = {"seconds": time.perf_counter() - t0,
                  "launches": masked_histogram.launches,
                  "hist": rep.hist.tolist(), "refs": rep.total_count}
# each rank writes its MRC in a directory of its own, under one name
work = f"{out}.cli{rank}"
os.makedirs(work, exist_ok=True)
os.chdir(work)
buf, saved = io.StringIO(), sys.stdout
masked_histogram.launches = 0
t0 = time.perf_counter()
sys.stdout = buf
try:
    rc = cli.main(["trace", "--file", raw_path, "--backends", "shard",
                   "--out", "m.csv"])
finally:
    sys.stdout = saved
doc["cli"] = {"rc": rc, "seconds": time.perf_counter() - t0,
              "launches": masked_histogram.launches,
              "lines": buf.getvalue().splitlines(),
              "csv": open("m.csv").read()}
json.dump(doc, open(f"{out}.{rank}", "w"))
dist.barrier()
dist.destroy_process_group()
"""


def host_cpu() -> str:
    """The host CPU's model name as ``lscpu`` gives it, and
    ``/proc/cpuinfo``'s beside it when ``lscpu`` does not know it (a
    virtual machine may hide it from both)."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    name = next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                 if ln.startswith("Model name:")), "unknown")
    if name == "unknown" and os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            info = next((ln.split(":", 1)[1].strip() for ln in f
                         if ln.startswith("model name")), "unknown")
        name = f"{name} (lscpu); {info} (/proc/cpuinfo)"
    return name


def native_phase(tmp: str, cfg, by_path: dict, acc_lines, resc,
                 prefix, sort_windows) -> dict:
    """Phase 28: the card's engine and replay held against the port's
    native C++ runtime (``pluss_torch.native``, built from
    ``pluss_torch/cpp``; it runs on the host, not on the card): (a) build
    its library and ``pluss_cpp`` binary, one compiler each, at once; (b)
    ``pluss_cpp acc 128`` prints phase 16's block below the banner (the
    GEMM-128 goldens); (c) all 29 families at n=16, the card's
    ``engine.run`` against ``native.run``: per-thread no-share and share
    histograms and the access count exactly, the CRI histogram's keys
    exactly and its values within 1e-11 relative (the CRI sums in another
    order: the port's racetrack is vectorized), the MRC within
    ``mrc.l2_error`` 1e-12 (tests/test_native.py's tolerance between two
    implementations) and the native MRC against the port's AET of the
    native CRI histogram at rtol 1e-12; (d) mvt-4000 (kernel 1: 4) and
    cholesky-1000 (kernel 1 in every window) the same way, and
    cholesky-2000 (phase 8's run) too when cholesky-1000's native time
    predicts under 60 s for it; (e) trmm-500 (cut from 1000 for the
    script's time) written with ``write_spec_file`` through ``pluss_cpp
    acc --spec``: the card's block below the banner (kernel 1 once per
    plan window); (f) ``native.replay`` of phase 17's
    first 2^24 refs against the card's ``replay_file`` of them (``prefix``,
    phase 17's), and against the card's replay of their line ids written
    as a precompacted trace (kernels 2 and 3 once each); (g) on those ids,
    two gloo ranks sharing the card, then NCCL at world 1, each run
    ``shard_replay`` and ``shard_replay_file(precompacted=True)`` equal to
    the single-device ``replay_file`` of those ids bit for bit, and ``cli
    trace --backends shard`` on the raw prefix, whose block below the
    banner is the in-memory sharded replay's (the single-process block's
    histogram; the table size of the in-memory compaction, as in JAX's
    multi-process route) and at world 1 the single-process block itself.
    Returns the native and card seconds."""
    import numpy as np
    import torch

    from pluss_torch import cli, cri, engine, mrc, native, trace
    from pluss_torch.models import REGISTRY, cholesky, gemm, mvt, trmm

    t_phase = time.perf_counter()
    out: dict = {"card": card_line(), "host_cpu": host_cpu(),
                 "host_threads": os.cpu_count()}
    T = cfg.thread_num

    # (a) build
    t0 = time.perf_counter()
    built = native.build()
    out["build"] = {"seconds": time.perf_counter() - t0,
                    **{k: v["seconds"] for k, v in built.items()}}
    check(os.path.exists(native.BIN_PATH)
          and os.path.exists(native.LIB_PATH), "native build outputs")

    def pluss_cpp(*argv) -> tuple[list[str], float]:
        t1 = time.perf_counter()
        p_ = subprocess.run([native.BIN_PATH, *argv], capture_output=True,
                            text=True, timeout=600)
        dt = time.perf_counter() - t1
        check(p_.returncode == 0, f"pluss_cpp {argv}: {p_.stderr[-2000:]}")
        return p_.stdout.splitlines(), dt

    # (b) the GEMM-128 block
    nat, dt = pluss_cpp("acc", "128")
    check(nat[0].startswith("NATIVE C++: ") and nat[1:] == acc_lines[1:],
          "pluss_cpp acc 128 != phase 16's block")
    out["gemm128_acc"] = {"native_s": dt, "lines": len(nat)}

    def held(res, nat_res, label: str) -> dict:
        """The card's result against the native run's."""
        check(res.noshare_list() == nat_res.noshare_list()
              and res.share_list() == nat_res.share_list()
              and res.max_iteration_count == nat_res.max_iteration_count,
              f"{label}: card != native histograms")
        ri = cri.distribute(res.noshare_list(), res.share_list(), T)
        nri = nat_res.rihist()
        check(set(ri) == set(nri), f"{label}: CRI keys differ")
        rel = max((abs(ri[k] - nri[k]) / abs(nri[k]) for k in ri if nri[k]),
                  default=0.0)
        check(rel <= 1e-11, f"{label}: CRI off by {rel} relative")
        card_curve, nat_curve = mrc.aet_mrc(ri, cfg), nat_res.mrc()
        l2 = mrc.l2_error(card_curve, nat_curve)
        check(len(card_curve) == len(nat_curve) and l2 < 1e-12,
              f"{label}: MRC L2 {l2}")
        check(np.allclose(nat_curve, mrc.aet_mrc(nri, cfg), rtol=1e-12,
                          atol=0.0), f"{label}: native MRC != port AET")
        return {"cri_rel": rel, "mrc_l2": l2}

    def card_vs_native(spec, label: str) -> dict:
        t1 = time.perf_counter()
        res, counts = counted(lambda: engine.run(spec, cfg))
        card_s = time.perf_counter() - t1
        clean(label, res)
        by_path[label] = counts
        t1 = time.perf_counter()
        nat_res = native.run(spec, cfg)
        nat_s = time.perf_counter() - t1
        return {"card_s": card_s, "native_s": nat_s,
                "refs": res.max_iteration_count, "launches": counts,
                **held(res, nat_res, label)}

    # (c) every family at n=16
    t0 = time.perf_counter()
    fam = {"card_s": 0.0, "native_s": 0.0, "cri_rel": 0.0, "mrc_l2": 0.0}

    def families():
        for name in sorted(REGISTRY):
            sp = REGISTRY[name](16)
            t1 = time.perf_counter()
            res = clean(f"native_{name}16", engine.run(sp, cfg))
            t2 = time.perf_counter()
            nat_res = native.run(sp, cfg)
            fam["card_s"] += t2 - t1
            fam["native_s"] += time.perf_counter() - t2
            h = held(res, nat_res, f"{name}16")
            fam["cri_rel"] = max(fam["cri_rel"], h["cri_rel"])
            fam["mrc_l2"] = max(fam["mrc_l2"], h["mrc_l2"])

    _, counts = counted(families)
    by_path["native_families16"] = counts
    check(counts["carried_event_hist"] > 0, "families: kernel 1 not launched")
    out["families16"] = {"models": len(REGISTRY), "launches": counts,
                         "seconds": time.perf_counter() - t0, **fam}

    # (d) mvt-4000 and cholesky
    out["mvt4000"] = card_vs_native(mvt(4000), "native_mvt4000")
    check(out["mvt4000"]["launches"]["carried_event_hist"] == 4,
          "mvt4000: not 4 kernel-1 launches")
    chol = out["cholesky1000"] = card_vs_native(cholesky(1000),
                                                "native_cholesky1000")
    want = engine.plan(cholesky(1000), cfg).nests[0].n_windows
    check(chol["launches"]["carried_event_hist"] == want,
          f"cholesky1000: {chol['launches']}, {want} windows")
    predicted = chol["native_s"] * resc.max_iteration_count / chol["refs"]
    out["cholesky2000_native_predicted_s"] = predicted
    if predicted < 60:
        t1 = time.perf_counter()
        nat_res = native.run(cholesky(2000), cfg)
        out["cholesky2000"] = {"native_s": time.perf_counter() - t1,
                               **held(resc, nat_res, "cholesky2000")}
        del nat_res

    # (e) trmm-500 through a spec file and the binary (cut from 1000 for
    # the script's time limit: the native trmm-1000 was most of this phase)
    spec_path = os.path.join(tmp, "trmm500.spec")
    native.write_spec_file(trmm(500), spec_path)
    t1 = time.perf_counter()
    res, counts = counted(lambda: engine.run(trmm(500), cfg))
    card_s = time.perf_counter() - t1
    clean("native_trmm500", res)
    by_path["native_trmm500"] = counts
    want = sort_windows(engine.plan(trmm(500), cfg))
    check(counts["carried_event_hist"] == want > 0,
          f"trmm500: {counts}, {want} sort windows")
    nat, dt = pluss_cpp("acc", "--spec", spec_path)
    check(nat[1:] == block_of(res, cfg, "x")[1:],
          "pluss_cpp acc --spec trmm500 != the card's block")
    out["trmm500_spec"] = {"card_s": card_s, "native_s": dt,
                           "launches": counts}
    del res

    # (f) the trace replay, on phase 17's first 2^24 refs, and on their
    # line ids as a precompacted trace
    n = 1 << 24
    raw = np.fromfile(os.path.join(tmp, "smoke.bin"), dtype="<u8", count=n)
    raw_path, ids_path = (os.path.join(tmp, f) for f in ("prefix.bin",
                                                          "prefix.ids"))
    raw.tofile(raw_path)
    trace.lines_of(raw.astype(np.int64), cfg.cls).astype("<u8").tofile(
        ids_path)
    t1 = time.perf_counter()
    ref, counts = counted(lambda: trace.replay_file(ids_path,
                                                    precompacted=True))
    card_s = time.perf_counter() - t1
    clean("native_replay", ref)
    by_path["native_replay"] = counts
    check(counts["masked_hist"] == counts["d24v_decode"] == 1,
          f"replay prefix ids: {counts}")
    check(np.array_equal(ref.hist, prefix.hist)
          and ref.total_count == prefix.total_count == n,
          "precompacted prefix ids != phase 17's prefix replay")
    t1 = time.perf_counter()
    nat_rep = native.replay(raw.astype(np.int64), cfg.cls, cfg.cache_kb)
    nat_s = time.perf_counter() - t1
    check(nat_rep.rihist() == prefix.histogram()
          and nat_rep.max_iteration_count == n, "native.replay != card")
    l2 = mrc.l2_error(mrc.aet_mrc(prefix.histogram(), cfg), nat_rep.mrc())
    check(l2 < 1e-12, f"replay MRC L2 {l2}")
    out["replay2p24"] = {"card_s": card_s, "native_s": nat_s,
                         "launches": counts, "mrc_l2": l2}
    del nat_rep, raw

    # (g) the sharded replay in a process group
    cwd = os.getcwd()
    one = os.path.join(tmp, "cli_one")
    os.makedirs(one, exist_ok=True)
    os.chdir(one)
    try:
        (rc, so, se), counts = counted(lambda: cli_call(
            ["trace", "--file", raw_path, "--backends", "shard", "--out",
             "m.csv"]))
        check(rc == 0, f"cli trace --backends shard: {se[-2000:]}")
        single, single_csv = so.splitlines(), open("m.csv").read()
        mem = trace.shard_replay(trace.load_trace(raw_path),
                                 devices=[torch.device("cuda", 0)])
        buf = io.StringIO()
        cli._trace_block(mem, 0.0, cfg, torch.device("cuda", 0), "m.csv",
                         buf)
        in_memory = buf.getvalue().splitlines()
    finally:
        os.chdir(cwd)
    by_path["native_cli_single"] = counts
    check(in_memory[1:-1] == single[1:-1],
          "in-memory sharded block's histogram != the streamed block's")
    groups = {}
    t0 = time.perf_counter()
    for backend, world in (("gloo", 2), ("nccl", 1)):
        docs = shard_ranks(tmp, world, backend, _REPLAY_RANK, "_replay",
                           (ids_path, raw_path))
        want_block = single if world == 1 else in_memory
        for d in docs:
            for label in ("shard_replay", "shard_replay_file"):
                check(d[label]["hist"] == ref.hist.tolist()
                      and d[label]["refs"] == n,
                      f"{backend} x{world} rank {d['rank']}: {label} != "
                      "replay_file")
                check(d[label]["launches"] > 0,
                      f"{backend} rank {d['rank']}: {label} launched no "
                      "kernel 2")
            c = d["cli"]
            check(c["rc"] == 0 and c["lines"][1:] == want_block[1:]
                  and c["csv"] == single_csv,
                  f"{backend} x{world} rank {d['rank']}: cli trace block")
        groups[f"{backend}{world}"] = [
            {"rank": d["rank"],
             **{f"{lb}_{k}": d[lb][k] for lb in ("shard_replay",
                                                  "shard_replay_file", "cli")
                for k in ("seconds", "launches")}} for d in docs]
    out["groups"] = {"seconds": time.perf_counter() - t0, **groups,
                     "n_lines_streamed": single[-1].split()[3],
                     "n_lines_in_memory": in_memory[-1].split()[3]}
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "native", **out, "ok": True})
    return out


#: phase 29's modes: (label, arguments of ``python -m pluss_torch.soak``)
#: (the chaos rounds and serve requests cut from 8 and 24 for the script's
#: time limit; PERF.md has the measurements)
SOAKS = (("property", ["60", "2910"]),
         ("chaos", ["--chaos", "6", "2920"]),
         ("serve", ["--serve", "16", "2930", "--telemetry"]))


#: the next size up the ladder from each of ``soak.PLACEMENT_N``'s
PLACEMENT_NEXT = {"gemm": 256, "mvt": 1500, "syrk": 160}


def placement_cut() -> dict:
    """The reason for the serve soak's one cut: one ``ri.derive`` (host
    work, what the placer runs inline per new pair) at each placement
    size of the card (``soak.PLACEMENT_N``) and at the next size of its
    ladder, in seconds."""
    import torch

    from pluss_torch import soak
    from pluss_torch.analysis import ri
    from pluss_torch.config import SamplerConfig
    from pluss_torch.models import REGISTRY

    pool, _ = soak.serve_pool(torch.device("cuda", 0), "")
    out = {}
    for q in soak.placement_pool(torch.device("cuda", 0), pool):
        cfg = SamplerConfig(thread_num=q["threads"], chunk_size=q["chunk"])
        for n in (q["n"], PLACEMENT_NEXT[q["model"]]):
            t0 = time.perf_counter()
            ri.derive(REGISTRY[q["model"]](n), cfg)
            out[f"{q['model']}{n}"] = time.perf_counter() - t0
    return out


def serve_phases(stdout: str) -> dict:
    """The serve soak's later phases, read off its lines (each must be
    there): the repeated trace's cold and warm ms, the recovered count and
    the recovery daemon's dispatches, the placement choices of each arm
    with the cut sizes, and the traced ids resolved."""
    def line(pattern: str):
        m = re.search(pattern, stdout, re.M)
        check(m is not None, f"serve soak: no line {pattern!r}")
        return m.groups()

    cold, warm, ratio = map(float, line(
        r"^serve soak: repeated trace cold ([\d.]+) ms -> warm ([\d.]+) "
        r"ms \(([\d.]+)x\)$"))
    replayed, counted_, dispatches = map(int, line(
        r"^serve soak: crash/recover -> (\d+) entries replayed \((\d+) "
        r"counted\), (\d+) device dispatch"))
    placement = {}
    for arm in ("on", "off"):
        n, sizes, advisory = line(
            rf"^serve soak: placement={arm} -> 9 adversarial-mix responses "
            r"bit-identical to solo, (\d+) placement choice\(s\) \(([^;]+);"
            r" interference advisory (\w+)\)$")
        placement[arm] = {"choices": int(n), "sizes": sizes,
                          "interference_advisory": advisory}
    resolved, of, brown = map(int, line(
        r"^serve soak: obs phase -> breaker flight dump checked, (\d+) of "
        r"(\d+) traced rids resolved to span trees, /metrics == rollup, "
        r"(\d+) browned out$"))
    check(cold >= 5.0 * max(warm, 50.0) and replayed == counted_ == 3
          and 0 <= dispatches <= 2 and placement["on"]["choices"] >= 1
          and placement["off"]["choices"] == 0 and resolved == of == 4
          and brown == 0, "serve soak: a later phase's line is off")
    return {"repeated_trace": {"cold_ms": cold, "warm_ms": warm,
                               "ratio": ratio},
            "crash_recover": {"replayed": replayed, "recovered": counted_,
                              "device_dispatches": dispatches},
            "placement": placement,
            "observability": {"traced_ids_resolved": resolved,
                              "browned_out": brown}}


def soak_phase(tmp: str, by_path: dict) -> None:
    """Phase 29: the three modes of ``python -m pluss_torch.soak`` on the
    card, one subprocess each with a fixed seed, in the repository; the
    serve soak's telemetry stream then passes ``cli stats --check``.  A
    mode that exits non-zero fails the script.  Each mode's launches are
    the ones its summary line prints: the soak process's own, and for the
    serve soak its daemons' (read off each daemon's ``kernel.launches.*``
    counters before it stops, summed) beside its solo runs'; the serve
    soak's later phases are read off their lines (:func:`serve_phases`)."""
    import torch

    repo = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    out: dict = {}
    # the earlier phases' cached blocks go back to the card: the soak
    # processes size their sort windows and residency from free memory
    torch.cuda.empty_cache()

    def start(label: str, args: list[str]):
        """Start one mode, its output to files (several run at once)."""
        outs = [open(os.path.join(tmp, f"soak_{label}.{k}"), "w+")
                for k in ("out", "err")]
        proc = subprocess.Popen(
            [sys.executable, "-m", "pluss_torch.soak", *args], cwd=repo,
            stdout=outs[0], stderr=outs[1], text=True)
        return label, args, time.perf_counter(), proc, outs

    def finish(label, args, t0, proc, outs) -> None:
        try:
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        seconds = time.perf_counter() - t0
        text = []
        for fh in outs:
            fh.seek(0)
            text.append(fh.read())
            fh.close()
        stdout, stderr = text
        if label == "serve":
            serve_out.append(stdout)
        # the mode's own lines (seeds, rounds, latencies) go to stderr
        sys.stderr.write(stdout)
        check(rc == 0, f"soak {label} {args}: exit {rc}\n"
                       f"{stdout[-4000:]}\n{stderr[-4000:]}")
        summary = [ln for ln in stdout.splitlines()
                   if re.search(r"launches \{", ln)]
        check(len(summary) == 1, f"soak {label}: no summary line")
        found = re.findall(r"launches (\{[^}]*\})", summary[0])
        out[label] = {"args": args, "seconds": seconds,
                      "summary": summary[0].split("; launches")[0],
                      "launches": json.loads(found[0])}
        if len(found) > 1:
            out[label]["daemon_launches"] = json.loads(found[1])

    out["placement_derive_s"] = placement_cut()
    tel = os.path.join(tmp, "soak_serve.jsonl")
    modes = dict(SOAKS)
    serve_out: list[str] = []
    # the serve soak's warm-start and repeated-trace bounds and its wait
    # for a killed daemon's memory run alone; the property and chaos soaks
    # (no such bound) start once it has printed its crash/recover line and
    # run beside its placement and observability phases (none either)
    serve = start("serve", modes["serve"] + [tel])
    serve_stdout = os.path.join(tmp, "soak_serve.out")
    while serve[3].poll() is None:
        with open(serve_stdout) as fh:
            if "serve soak: crash/recover" in fh.read():
                break
        time.sleep(1.0)
    others = [start("property", modes["property"]),
              start("chaos", modes["chaos"])]
    for run in (serve, *others):
        finish(*run)
    out["serve"]["phases"] = serve_phases(serve_out[0])
    # `python -m pluss_torch.cli stats --check` on the stream, in this
    # process (an interpreter start costs the card's host ~8 s)
    from pluss_torch import cli

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["stats", tel, "--check"])
    check(rc == 0, f"stats --check of the serve soak's stream: exit {rc}")
    out["stats_check"] = {"seconds": time.perf_counter() - t0,
                          "line": buf.getvalue().strip()}
    prop, chaos = out["property"]["launches"], out["chaos"]["launches"]
    daemon = out["serve"]["daemon_launches"]
    by_path["soak_property"] = prop
    by_path["soak_chaos"] = chaos
    by_path["soak_serve_daemon"] = daemon
    by_path["soak_serve_solo"] = out["serve"]["launches"]
    check(prop["carried_event_hist"] > 0 and chaos["carried_event_hist"] > 0
          and daemon["carried_event_hist"] > 0,
          f"soak: kernel 1 not launched in every mode: {out}")
    check(prop["masked_hist"] > 0 and daemon["masked_hist"] > 0,
          f"soak: kernel 2 not launched in the property and serve soaks: "
          f"{out}")
    check(daemon["d24v_decode"] > 0,
          f"soak: kernel 3 not launched in the serve soak's daemon: {out}")
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "soak", **out, "ok": True})


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
    clean(label, res)
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
        clean(f"cholesky2000_tb{tb}", res)
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
    clean("trmm1000_rerouted", res)
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
        clean(label, est)
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
    of the trace, the streamed replay's result, its first batch's replay
    (the 2^24-ref prefix) and part A's replay (its first 2^27 refs)."""
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
    clean("trace", rep)
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
    # the plain versions and the pack wire on part A (cut from the whole
    # trace for the script's time limit: part B's delta blocks are held by
    # phase 4, the captured batch below and the resumed leg)
    def same_a(other, what):
        check(np.array_equal(other.hist, part_a.hist)
              and other.total_count == part_a.total_count
              and other.n_lines == part_a.n_lines, f"trace: {what}")

    t1 = time.perf_counter()
    same_a(trace.replay_file(path, limit_refs=layout["part_a_refs"],
                             _kernels=PLAIN), "plain versions on part A")
    plain_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    same_a(trace.replay_file(path, limit_refs=layout["part_a_refs"],
                             wire="pack"), "pack wire on part A")
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
          "launches": counts, "golden": True, "part_a_refs":
          layout["part_a_refs"], "plain_part_a_s": plain_s,
          "plain_match": True, "pack_part_a_s": pack_s, "pack_match": True,
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
    return batches, rep, prefix, part_a


def resident_phase(tmp: str, rep, by_path: dict, prefix, part_a) -> None:
    """Phase 19: the 2^28-ref trace of phase 17 packed (d24v, and u24 on
    its first batch), staged into device memory (kernel 3 once per d24v
    record) and replayed from there (kernel 2 once per batch, or once per
    window on the legacy scan), then through ``replay_file``'s
    residency store: a cold stage-through, a warm hit and a tiny budget
    (on part A, the first 2^27 refs: the whole trace until the script's
    time limit called for a cut).  Every replay must equal the streamed
    replay ``rep`` bit for bit (the u24 first batch: ``prefix``, phase
    17's replay of that batch; the tiny budget: ``part_a``, phase 17's
    replay of part A)."""
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
    # phase 17's replay of the same first batch
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
    same(clean("stage_through", cold), "stage-through (cold)")
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
    same(clean("resident_hit", warm), "warm hit")
    check(warm.timing["resident"] == "hit" and warm.timing["h2d_bytes"] == 0
          and counts["d24v_decode"] == 0
          and counts["masked_hist"] == n_batches,
          f"warm hit {warm.timing}, launches {counts}")
    residency.reset(budget=1024)
    tiny = clean("resident_tiny", trace.replay_file(
        path, resident_cache=True, limit_refs=part_a.total_count))
    check(np.array_equal(tiny.hist, part_a.hist)
          and tiny.total_count == part_a.total_count
          and tiny.n_lines == part_a.n_lines, "trace: tiny budget on part A")
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


def telemetry_phase(tmp: str, cfg, by_path: dict, res_off, counts_off: dict,
                    rep_off) -> None:
    """Phase 20: mvt-4000 and part A of the 2^28-ref trace (its first 2^27
    refs; the whole trace until the script's time limit called for a cut)
    with a telemetry session on, each equal bit for bit to its
    telemetry-off run (``res_off``, ``rep_off``: phase 17's replay of part
    A) with the same launch counts (the trace: kernels 2 and 3 once per
    batch, 8); the stream passes ``stats --check`` and counts the refs
    that ran.  The off walls are the earlier phase's and one more run
    after the on run (host clocks spread on a shared host: the pair, not
    one number, is the comparison)."""
    import numpy as np

    from pluss_torch import engine, obs, trace
    from pluss_torch.models import mvt
    from pluss_torch.obs import stats as stats_mod

    ev = os.path.join(tmp, "events.jsonl")
    path = os.path.join(tmp, "smoke.bin")
    n = rep_off.total_count
    n_batches = n // (trace.WINDOWS_PER_BATCH * trace.TRACE_WINDOW)
    trace_counts_off = {"carried_event_hist": 0, "masked_hist": n_batches,
                        "d24v_decode": n_batches}
    spec = mvt(4000)
    # an off run first: the plan memo may have dropped mvt-4000's plan
    # since phase 7, and the walls below compare runs, not plans
    t0 = time.perf_counter()
    check(same_result(engine.run(spec, cfg), res_off),
          "telemetry: mvt4000 off run")
    walls = {"mvt4000_off_s": [time.perf_counter() - t0],
             "mvt4000_on_s": []}
    obs.configure(ev)
    try:
        t0 = time.perf_counter()
        res, counts = counted(lambda: engine.run(spec, cfg))
        walls["mvt4000_on_s"].append(time.perf_counter() - t0)
        by_path["telemetry_mvt4000"] = counts
        check(same_result(res, res_off) and counts == counts_off,
              f"telemetry mvt4000: result or launches {counts} differ "
              f"from the telemetry-off run's {counts_off}")
        t0 = time.perf_counter()
        rep, counts = counted(lambda: trace.replay_file(path,
                                                        limit_refs=n))
        trace_on_s = time.perf_counter() - t0
        by_path["telemetry_trace"] = counts
        check(np.array_equal(rep.hist, rep_off.hist)
              and rep.total_count == rep_off.total_count
              and rep.n_lines == rep_off.n_lines
              and counts == trace_counts_off and n_batches == 8,
              f"telemetry trace: result or launches {counts} differ from "
              f"the telemetry-off run's {trace_counts_off}")
    finally:
        obs.shutdown()
    t0 = time.perf_counter()
    off = trace.replay_file(path, limit_refs=n)
    trace_off2_s = time.perf_counter() - t0
    check(np.array_equal(off.hist, rep_off.hist), "telemetry: off rerun")
    # mvt's walls alternate off/on after the first pair
    for on in (True, False, True, False):
        if on:
            obs.configure(os.path.join(tmp, "events2.jsonl"))
        try:
            t0 = time.perf_counter()
            again = engine.run(spec, cfg)
            walls[f"mvt4000_{'on' if on else 'off'}_s"].append(
                time.perf_counter() - t0)
        finally:
            obs.shutdown()
        check(same_result(again, res_off), "telemetry: mvt4000 rerun")
    out, err = io.StringIO(), io.StringIO()
    rc = stats_mod.main(ev, out, err, check=True)
    check(rc == 0, f"stats --check: {err.getvalue()}")
    recs, _, _ = stats_mod.load(ev)
    ctr = {r["name"]: r["value"] for r in recs if r.get("ev") == "counter"}
    spans = [r for r in recs if r.get("ev") == "span"]
    (replay_span,) = [r for r in spans if r["name"] == "trace.replay_file"]
    check(ctr["engine.refs_processed"] == res_off.max_iteration_count
          and ctr["trace.refs_replayed"] == rep_off.total_count,
          f"telemetry counts {ctr.get('engine.refs_processed')} / "
          f"{ctr.get('trace.refs_replayed')}")
    breakdown = stats_mod.trace_breakdown(ctr, replay_span["dur"])
    for ln in breakdown:
        print(ln, flush=True)
    emit({"phase": "telemetry", "records": len(recs), "spans": len(spans),
          "stats_check": out.getvalue().strip(), **walls,
          "trace_refs": n,
          "trace_off_s": [rep_off.timing["wall_s"], trace_off2_s],
          "trace_on_s": trace_on_s,
          "trace_span_s": replay_span["dur"],
          "engine_dispatch_s": [r["dur"] for r in spans
                                if r["name"] == "engine.dispatch"],
          "breakdown": breakdown,
          "counters": {k: ctr[k] for k in sorted(ctr)},
          "launches": {"mvt4000": by_path["telemetry_mvt4000"],
                       "trace": by_path["telemetry_trace"]},
          "match": True, "ok": True})


def resilience_phase(tmp: str, cfg, by_path: dict, resm, rest, resc,
                     chol_peak_gib: float) -> None:
    """Phase 21: the sampler's degradation ladder on the card
    (``pluss_torch.resilience.run_resilient``): injected faults (a, b), a
    genuine ``torch.OutOfMemoryError`` under a capped allocator (c), the
    CPU rung (d), and the empty stamps of phases 5-19 (e)."""
    import torch

    from pluss_torch import engine, obs
    from pluss_torch.models import cholesky, mvt, trmm
    from pluss_torch.ops.event_hist import event_histogram
    from pluss_torch.resilience import LADDER, FaultPlan, Retry, faults, \
        run_resilient

    retry = Retry(backoff_s=0.0)
    out = {}

    def ladder(label, spec, plan, want, **kw):
        faults.install(FaultPlan.parse(plan) if plan else None)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            res, counts = counted(lambda: run_resilient(
                spec, cfg, retry=retry, **kw))
        finally:
            faults.install(None)
        wall = time.perf_counter() - t0
        by_path[f"resilience_{label}"] = counts
        check(same_result(res, want), f"resilience {label}: result differs "
              "from the clean run")
        out[label] = {"fault_plan": plan, "rungs": list(res.degradations),
                      "attempts": len(res.degradations) + 1, "wall_s": wall,
                      "peak_device_gib":
                      torch.cuda.max_memory_allocated() / 2**30,
                      "launches": counts, "match": True}
        return res

    # (a) one injected OOM: the window shrinks, the result holds
    res = ladder("mvt4000", mvt(4000), "oom", resm)
    check(res.degradations == ("shrink_window",),
          f"(a) stamp {res.degradations}")
    # (b) three: the last rung is the dispatch-sliced pipeline
    res = ladder("trmm1000", trmm(1000), "oom,oom@2,oom@3", rest)
    check(res.degradations == LADDER[:3], f"(b) stamp {res.degradations}")
    # the sliced attempt ran at the twice-shrunk window, one thread at a
    # time: kernel 1 once per sort window per thread
    pl = engine._plan_cached(trmm(1000), cfg, None, None,
                             max(engine.WINDOW_TARGET // 64, 1 << 10))
    sorts = sum(int(np_.n_windows) for np_ in pl.nests if np_.refs)
    check(by_path["resilience_trmm1000"]["carried_event_hist"]
          == sorts * cfg.thread_num,
          f"(b): {by_path['resilience_trmm1000']} launches, {sorts} sort "
          "windows per thread")
    # (c) the card's own OOM: cholesky-2000 under an allocator cap of
    # about half its full run's peak; the rungs stop before the CPU.  Each
    # failed attempt's rung event is read as it is emitted, with kernel
    # 1's launches so far: (raw cause, launches before the failure)
    failed = []

    def on_record(rec):
        if rec.get("name") == "resilience.rung":
            failed.append((rec["attrs"]["cause"], event_histogram.launches))

    total = torch.cuda.get_device_properties(0).total_memory
    cap_gib = 0.55 * chol_peak_gib
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(cap_gib * 2**30 / total)
    obs.configure(os.path.join(tmp, "resilience.jsonl")).add_tap(on_record)
    try:
        res = ladder("cholesky2000_capped", cholesky(2000), "", resc,
                     rungs=LADDER[:3])
    finally:
        obs.shutdown()
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.empty_cache()
    check(len(failed) == len(res.degradations) >= 1
          and all(cause == "OutOfMemoryError" for cause, _ in failed)
          and failed[0][1] > 0,
          f"(c): the failed attempts (raw cause, kernel-1 launches so far) "
          f"{failed} are not the card's own out-of-memory errors after "
          "kernel launches")
    out["cholesky2000_capped"].update(
        cap_gib=cap_gib, full_peak_gib=chol_peak_gib,
        failed_attempts=[{"cause": c, "kernel1_launches_so_far": n}
                         for c, n in failed])
    # (d) the CPU rung on a small sort-path model: stamped, equal to the
    # card's run, and the next plain run still launches on the card
    small = cholesky(48)
    on_card, counts = counted(lambda: engine.run(small, cfg))
    check(counts["carried_event_hist"] > 0, "(d): cholesky48 sorts nothing")
    res = ladder("cholesky48_cpu", small, "oom,oom@2,oom@3,oom@4", on_card)
    check(res.degradations == LADDER and "cpu_pinned" not in
          res.degradations, f"(d) stamp {res.degradations}")
    check(by_path["resilience_cholesky48_cpu"]["carried_event_hist"] == 0,
          "(d): the CPU attempt launched a kernel")
    again, counts = counted(lambda: engine.run(small, cfg))
    check(counts["carried_event_hist"] > 0 and again.degradations == ()
          and same_result(again, on_card),
          "(d): a later run did not stay on the card")
    out["cholesky48_cpu"]["later_run_launches"] = counts
    # (e) every main-path result of phases 5-19 is stamped ()
    check(len(STAMPS) > 40 and all(st == () for _, st in STAMPS),
          f"(e): stamps {[x for x in STAMPS if x[1]]}")
    out["clean_stamps"] = len(STAMPS)
    for label in ("mvt4000", "trmm1000", "cholesky2000_capped",
                  "cholesky48_cpu"):
        o = out[label]
        print(f"resilience {label}: plan {o['fault_plan'] or '-'}; rungs "
              f"{','.join(o['rungs']) or '()'}; {o['attempts']} attempts; "
              f"{o['wall_s']:.3f} s", flush=True)
    print(f"resilience cholesky2000_capped: failed attempts (raw cause, "
          f"kernel-1 launches so far) {failed}", flush=True)
    emit({"phase": "resilience", **out, "ok": True})


def cli_call(argv):
    """(rc, stdout, stderr) of one in-process ``pluss_torch.cli`` call; a
    usage error comes back as its exit code, which the checks refuse."""
    from pluss_torch import cli

    o, e = io.StringIO(), io.StringIO()
    saved = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = o, e
    try:
        rc = cli.main(argv)
    except SystemExit as x:
        rc = x.code
    finally:
        sys.stdout, sys.stderr = saved
    return rc, o.getvalue(), e.getvalue()


def host_only_call(out: dict, label: str, argv, rc_want: int = 0):
    """One CLI call that must touch no device: no dispatch, no kernel
    launch, no device allocation; its seconds and counts go to
    ``out[label]``."""
    import torch

    from pluss_torch import engine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0, d0 = torch.cuda.memory_allocated(), engine.DEVICE_DISPATCHES
    t0 = time.perf_counter()
    (rc, so, se), counts = counted(lambda: cli_call(argv))
    dt = time.perf_counter() - t0
    check(rc == rc_want, f"{label}: rc {rc}: {se[-2000:]}")
    check(engine.DEVICE_DISPATCHES == d0 and not any(counts.values()),
          f"{label}: host mode dispatched ({counts})")
    check(torch.cuda.memory_allocated() == mem0
          and torch.cuda.max_memory_allocated() == mem0,
          f"{label}: host mode allocated device memory")
    out[label] = {"seconds": dt, "dispatches": 0, "launches": counts}
    return so, se


def predict_and_engine_s(ev: str, label: str) -> tuple[float, float]:
    """Seconds of the host prediction (the one ``ri.derive`` span) and of
    the engine run after it (the ``engine.*`` spans, first start to last
    end) in one call's telemetry stream."""
    with open(ev) as f:
        spans = [r for r in map(json.loads, f) if r.get("ev") == "span"]
    derive = [r for r in spans if r["name"] == "ri.derive"]
    eng = [r for r in spans if r["name"].startswith("engine.")]
    check(len(derive) == 1 and eng, f"{label}: spans {len(spans)}")
    host_s = derive[0]["dur"]
    engine_s = max(r["t"] + r["dur"] for r in eng) - min(r["t"] for r in eng)
    check(derive[0]["t"] + host_s <= min(r["t"] for r in eng),
          f"{label}: the prediction overlapped the engine run")
    return host_s, engine_s


def analysis_phase(cfg, by_path: dict, sort_windows, acc_lines) -> None:
    """Phase 22: the static analysis modes (:mod:`pluss_torch.analysis`,
    ``cli lint|analyze|predict|cotenancy|tune|spec``) with their engine
    cross-checks on the card.  The predictions are host work: each one is
    run counted, and must leave ``engine.DEVICE_DISPATCHES``, every
    kernel's launch count and the card's allocated memory where they
    were; only ``--check``, ``tune --check`` and ``spec load --run`` run
    the engine, on the card."""
    from pluss_torch import engine, obs
    from pluss_torch.config import SamplerConfig
    from pluss_torch.models import REGISTRY, mvt

    out: dict = {}
    t_phase = time.perf_counter()

    def host_only(label, argv):
        return host_only_call(out, label, argv)

    # (a) every family at n=16: the prediction alone (host), the same
    # command with --cpu, then --check on the card against --check --cpu
    text, _ = host_only("predict_families16", ["predict", "--all", "--n",
                                               "16"])
    rc, cpu_text, _ = cli_call(["predict", "--all", "--n", "16", "--cpu"])
    check(rc == 0 and cpu_text == text, "predict --all: card != --cpu")
    argv = ["predict", "--all", "--n", "16", "--check", "--json"]
    d0 = engine.DEVICE_DISPATCHES
    t0 = time.perf_counter()
    (rc, card_json, err), counts = counted(lambda: cli_call(argv))
    check_s = time.perf_counter() - t0
    by_path["predict_families16_check"] = counts
    dispatches = engine.DEVICE_DISPATCHES - d0
    rc_cpu, cpu_json, _ = cli_call(argv + ["--cpu"])
    doc, doc_cpu = json.loads(card_json), json.loads(cpu_json)
    models = doc["models"]
    derivable = sorted(m for m, d in models.items() if d["derivable"])
    check(rc == rc_cpu == 0 and doc == doc_cpu,
          "predict --all --check: card document != --cpu document")
    check(all(models[m]["check"]["histogram_identical"]
              and models[m]["check"]["mrc_exact"] for m in derivable),
          "predict --all --check: a family is not bit-identical")
    check(text.splitlines()[-1] == f"pluss predict: {len(derivable)}/"
          f"{len(models)} model(s) derivable, 0 error(s)",
          f"predict --all summary: {text.splitlines()[-1]}")
    want = sum(sort_windows(engine.plan(REGISTRY[nm](16), cfg))
               for nm in REGISTRY if REGISTRY[nm](16).name in derivable)
    check(counts["carried_event_hist"] == want and dispatches
          <= len(derivable), f"predict --all --check: {counts} launches "
          f"({want} sort windows), {dispatches} dispatches")
    out["predict_families16_check"] = {
        "derivable": len(derivable), "refused": len(models)
        - len(derivable), "check_seconds": check_s, "launches": counts,
        "dispatches": dispatches, "card_doc_equals_cpu": True}

    # (b, c) GEMM-512 (closed form) and mvt-2000 (dense), cut from
    # GEMM-1024 and mvt-4000 for the script's time limit (their host
    # predictions were most of this phase): ``predict --check`` through the
    # CLI, under a
    # telemetry session whose spans split the call into the host
    # prediction (``ri.derive``) and the card's engine run (the
    # ``engine.*`` spans, first start to last end)
    tmp = tempfile.mkdtemp(prefix="pluss_torch_predict_")

    def predict_check(label, model, n, method):
        ev = os.path.join(tmp, f"{label}.jsonl")
        d0 = engine.DEVICE_DISPATCHES
        try:
            (rc, so, err), counts = counted(lambda: cli_call(
                ["predict", model, "--n", str(n), "--check", "--json",
                 "--telemetry", ev]))
        finally:
            obs.shutdown()
        dispatches = engine.DEVICE_DISPATCHES - d0
        by_path[f"predict_{label}"] = counts
        check(rc == 0, f"{label}: predict --check rc {rc}: {err[-2000:]}")
        (name, d), = json.loads(so)["models"].items()
        detail = d.get("check", {})
        check(d["method"] == method, f"{label}: method {d['method']}")
        check(detail.get("histogram_identical") is True
              and "bit-identical to engine.run" in err,
              f"{label}: prediction != card engine ({detail})")
        want = {"carried_event_hist": sort_windows(
            engine.plan(REGISTRY[model](n), SamplerConfig())),
            "masked_hist": 0, "d24v_decode": 0}
        check(counts == want and dispatches <= 1,
              f"{label}: launches {counts}, the plan's {want}; "
              f"{dispatches} dispatches")
        host_s, engine_s = predict_and_engine_s(ev, label)
        mrc_v = "bit-identical" if detail["mrc_exact"] \
            else f"l2={detail['mrc_l2_error']:.2e}"
        print(f"analysis predict {label}: {d['method']}, "
              f"{d['accesses']} accesses; host predict {host_s:.3f} s, "
              f"card engine {engine_s:.3f} s; histograms bit-identical, "
              f"MRC {mrc_v}; kernel-1 launches "
              f"{counts['carried_event_hist']}", flush=True)
        out[f"predict_{label}"] = {
            "method": d["method"], "accesses": d["accesses"],
            "host_predict_s": host_s, "card_engine_s": engine_s,
            "mrc": mrc_v, "dispatches": dispatches, "launches": counts}

    try:
        predict_check("gemm512", "gemm", 512, "closed-form")
        predict_check("mvt2000", "mvt", 2000, "dense")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(by_path["predict_gemm512"]["carried_event_hist"] == 0,
          "gemm512: kernel 1 launched")
    check(by_path["predict_mvt2000"]["carried_event_hist"] > 0,
          "mvt2000: kernel 1 not launched")

    # (d) tune mvt-1000: the search alone (host), then with --check: the
    # winner's one engine run on the card verifies
    text, _ = host_only("tune_mvt1000", ["tune", "mvt", "--n", "1000",
                                         "--json"])
    d0 = engine.DEVICE_DISPATCHES
    t0 = time.perf_counter()
    (rc, tj, err), counts = counted(lambda: cli_call(
        ["tune", "mvt", "--n", "1000", "--check", "--json"]))
    tune_s = time.perf_counter() - t0
    by_path["tune_mvt1000_check"] = counts
    tdoc = json.loads(tj)
    name = next(iter(tdoc["models"]))
    m = tdoc["models"][name]
    check(rc == 0 and m["check"]["histogram_identical"]
          and "verified against engine.run" in err,
          f"tune mvt1000 --check: rc {rc}: {err[-2000:]}")
    searched = json.loads(text)["models"][name]
    check({k: v for k, v in m.items() if k != "check"} == searched,
          "tune --check searched differently")
    w = m["winner"]
    wcfg = SamplerConfig(thread_num=w["threads"], chunk_size=w["chunk"],
                         cache_kb=tdoc["target_kb"])
    want = sort_windows(engine.plan(mvt(1000), wcfg,
                                    window_accesses=w["window"]))
    check(engine.DEVICE_DISPATCHES - d0 <= 1
          and counts["carried_event_hist"] == want,
          f"tune mvt1000 --check: {counts} launches, {want} sort windows")
    out["tune_mvt1000_check"] = {
        "verdict": m["verdict"], "winner": w, "seconds": tune_s,
        "mrc_exact": m["check"]["mrc_exact"], "launches": counts}
    print(f"analysis tune mvt1000: [{m['verdict']}] winner threads="
          f"{w['threads']} chunk={w['chunk']}, search "
          f"{out['tune_mvt1000']['seconds']:.3f} s (host), with --check "
          f"{tune_s:.3f} s; kernel-1 launches "
          f"{counts['carried_event_hist']}", flush=True)

    # (e) the host-only modes in this process, and a spec through the codec
    text, _ = host_only("lint_all", ["lint", "--all"])
    check(text.splitlines()[-1].startswith(
        f"pluss lint: {len(REGISTRY)} model(s), 0 error(s)"), "lint --all")
    text, _ = host_only("analyze_gemm128", ["analyze", "--model", "gemm",
                                            "--n", "128"])
    check("gemm128: prediction closed-form" in text, "analyze gemm128")
    _, err = host_only("cotenancy_gemm_syrk16", [
        "cotenancy", "gemm+syrk", "--n", "16", "--check"])
    check(err.count(": ok (") == 2, f"cotenancy --check: {err}")
    tmp = tempfile.mkdtemp(prefix="pluss_torch_spec_")
    try:
        text, _ = host_only("spec_dump_gemm128", ["spec", "dump", "gemm"])
        path = os.path.join(tmp, "gemm128.json")
        with open(path, "w") as f:
            f.write(text)
        (rc, block, err), counts = counted(lambda: cli_call(
            ["spec", "load", path, "--run"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    by_path["spec_load_gemm128"] = counts
    lines = block.splitlines()
    check(rc == 0 and lines[0].startswith("TORCH CUDA IMPORT gemm128: ")
          and lines[1:] == acc_lines[1:],
          "spec load --run != acc for gemm128")
    out["spec_load_gemm128"] = {"lines": len(lines), "launches": counts,
                                "equals_acc": True}
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "analysis", **out, "ok": True})


def block_of(res, cfg, label: str) -> list[str]:
    """The lines of an ``acc`` block of ``res`` (its banner line aside,
    what ``cli acc`` and ``cli import --run`` print for that run)."""
    from pluss_torch import cri
    from pluss_torch.io import acc_block

    ri = cri.distribute(res.noshare_list(), res.share_list(), cfg.thread_num)
    buf = io.StringIO()
    acc_block(label, 0.0, res.noshare_list(), res.share_list(), ri,
              res.max_iteration_count, buf)
    return buf.getvalue().splitlines()


def frontend_phase(cfg, by_path: dict, sort_windows, conserved, res1k, resm,
                   resc) -> None:
    """Phase 23: the authoring and transform modes (``cli import``,
    ``cli transform``, ``cli tune --transforms``, ``pluss_torch.frontend``)
    with the specs they derive run on the card: (a) pragma-C GEMM-1024,
    (b) cholesky-2000 and mvt-4000 from DSL, (c) the PolyBench corpus,
    (d) the transforms, each against the earlier phases' runs of the same
    models, the CPU or the host prediction."""
    import numpy as np

    from pluss_torch import engine, frontend, obs, spec_codec
    from pluss_torch.analysis import transform as tf
    from pluss_torch.config import SamplerConfig
    from pluss_torch.frontend import polybench
    from pluss_torch.models import cholesky, gemm, mvt

    out: dict = {}
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="pluss_torch_frontend_")

    def imported_run(label, path, model, n, want_res, launches_per_run):
        """``cli import <path> --run --check-model <model> --n <n>``: the
        imported spec's block below the banner equals the registry model's
        earlier run, the gate says byte-identical, and each of its three
        engine runs (the model, the warm-up, the timed run) launches
        kernel 1 ``launches_per_run`` times."""
        t0 = time.perf_counter()
        (rc, block, err), counts = counted(lambda: cli_call(
            ["import", path, "--run", "--check-model", model, "--n",
             str(n)]))
        dt = time.perf_counter() - t0
        by_path[f"import_{label}"] = counts
        lines = block.splitlines()
        name = os.path.splitext(os.path.basename(path))[0]
        check(rc == 0 and f"byte-identical to registry {model}({n})" in err,
              f"import {label}: rc {rc}: {err[-2000:]}")
        check(lines[0].startswith(f"TORCH CUDA IMPORT {name}: ")
              and lines[1:] == block_of(want_res, cfg, label)[1:],
              f"import {label}: block != the registry run's")
        check(counts["carried_event_hist"] == 3 * launches_per_run,
              f"import {label}: launches {counts}")
        out[f"import_{label}"] = {"seconds": dt, "launches": counts,
                                  "runs": 3, "byte_identical": True}

    try:
        # (a) pragma-C GEMM at N=1024: the template path, no launch
        with open(polybench.gemm_source_path()) as f:
            src = f.read()
        check("#define N 128\n" in src, "gemm.ppcg_omp.c lost its define")
        path = os.path.join(tmp, "gemm1024.c")
        with open(path, "w") as f:
            f.write(src.replace("#define N 128\n", "#define N 1024\n"))
        imported_run("gemm1024_c", path, "gemm", 1024, res1k, 0)

        # (b) DSL at full width: cholesky-2000 through import_path and one
        # engine run, mvt-4000 through the CLI
        def dsl_file(spec, stem):
            text = frontend.emit_dsl(spec).split("\n", 1)[1]
            check(text.startswith("from pluss import frontend\n"),
                  "emit_dsl no longer imports the JAX package's name")
            p = os.path.join(tmp, f"{stem}.py")
            with open(p, "w") as f:
                f.write(text)
            return p

        spec = cholesky(2000)
        path = dsl_file(spec, "cholesky2000")
        t0 = time.perf_counter()
        (dspec, _), = frontend.import_path(path)
        import_s = time.perf_counter() - t0
        check(spec_codec.specs_equal(dspec, spec),
              "cholesky2000 from DSL != the registry spec")
        check(engine.plan(dspec, cfg).pos_dtype == np.int64,
              "cholesky2000 from DSL: positions not int64")
        t0 = time.perf_counter()
        res, counts = counted(lambda: engine.run(dspec, cfg))
        engine_s = time.perf_counter() - t0
        by_path["dsl_cholesky2000"] = counts
        check(same_result(res, resc) and conserved(res),
              "cholesky2000 from DSL != phase 8's run")
        check(counts["carried_event_hist"] == 125,
              f"cholesky2000 from DSL: launches {counts}")
        del res
        out["dsl_cholesky2000"] = {"import_s": import_s,
                                   "engine_s": engine_s,
                                   "pos_dtype": "int64", "launches": counts,
                                   "equals_phase8": True}
        imported_run("mvt4000_dsl", dsl_file(mvt(4000), "mvt4000"), "mvt",
                     4000, resm, 4)

        # (c) the PolyBench corpus: every family on the card and the CPU
        t0 = time.perf_counter()
        corpus = polybench.import_polybench()
        out["corpus_import_s"] = time.perf_counter() - t0
        check(sorted(corpus) == sorted(polybench.FAMILIES),
              f"corpus families {sorted(corpus)}")
        fams = {}
        for fam, sp in sorted(corpus.items()):
            on_card, counts = counted(lambda: engine.run(sp, cfg))
            on_cpu = engine.run(sp, cfg, device="cpu")
            by_path[f"corpus_{fam}"] = counts
            want = sort_windows(engine.plan(sp, cfg))
            check(same_result(on_card, on_cpu) and conserved(on_card),
                  f"corpus {fam}: card != CPU")
            check(counts["carried_event_hist"] == want,
                  f"corpus {fam}: launches {counts}, {want} sort windows")
            fams[fam] = {"refs": on_card.max_iteration_count,
                         "launches": counts["carried_event_hist"]}
        out["corpus"] = fams

        # (d) transforms of GEMM-128 (cut from 256 for the script's time
        # limit), checked on the card against the host prediction of the
        # transformed spec
        for label, flag in (("interchange02", ["--interchange", "0,2"]),
                            ("tile32", ["--tile", "0:32,1:32,2:32"])):
            ev = os.path.join(tmp, f"{label}.jsonl")
            t0 = time.perf_counter()
            try:
                (rc, so, err), counts = counted(lambda: cli_call(
                    ["transform", "gemm", "--n", "128", *flag, "--check",
                     "--json", "--telemetry", ev]))
            finally:
                obs.shutdown()
            dt = time.perf_counter() - t0
            by_path[f"transform_gemm128_{label}"] = counts
            doc = json.loads(so) if rc == 0 else {}
            detail = doc.get("check", {})
            check(rc == 0 and doc["verdict"] == "PL951"
                  and detail.get("histogram_identical") is True
                  and "verified against engine.run" in err,
                  f"transform {label}: rc {rc}: {err[-2000:]}")
            tspec = spec_codec.spec_from_json(doc["spec"])
            want = sort_windows(engine.plan(tspec, cfg))
            check(counts["carried_event_hist"] == want,
                  f"transform {label}: launches {counts}, {want} windows")
            host_s, engine_s = predict_and_engine_s(ev, label)
            out[f"transform_gemm128_{label}"] = {
                "spec": tspec.name, "seconds": dt, "host_predict_s": host_s,
                "card_engine_s": engine_s, "histogram_identical": True,
                "mrc_exact": detail["mrc_exact"], "launches": counts}
            print(f"frontend transform gemm128 {label}: {tspec.name}, host "
                  f"predict {host_s:.3f} s, card engine {engine_s:.3f} s, "
                  f"histograms bit-identical; kernel-1 launches "
                  f"{counts['carried_event_hist']}", flush=True)
        ev = os.path.join(tmp, "tune.jsonl")
        t0 = time.perf_counter()
        try:
            (rc, so, err), counts = counted(lambda: cli_call(
                ["tune", "gemm", "--transforms", "--n", "64", "--cache-kb",
                 "1", "--check", "--json", "--telemetry", ev]))
        finally:
            obs.shutdown()
        dt = time.perf_counter() - t0
        by_path["tune_transforms_gemm64"] = counts
        doc = json.loads(so) if rc == 0 else {}
        check(rc == 0 and doc.get("check", {}).get("histogram_identical")
              and "transformed winner" in err
              and "verified against engine.run" in err,
              f"tune --transforms: rc {rc}: {err[-2000:]}")
        best = doc["best_transform"]
        check(best.startswith("tile(") and best.endswith(")"),
              f"tune --transforms: the winner {best} is no tiling")
        w = doc["best"]["tune"]["winner"]
        wcfg = SamplerConfig(thread_num=w["threads"], chunk_size=w["chunk"])
        wspec = tf.tile(gemm(64), tf.parse_tile(best[5:-1])).spec
        want = sort_windows(engine.plan(wspec, wcfg,
                                        window_accesses=w["window"]))
        check(counts["carried_event_hist"] == want,
              f"tune --transforms: launches {counts}, {want} windows")
        with open(ev) as f:
            eng = [r for r in map(json.loads, f) if r.get("ev") == "span"
                   and r["name"].startswith("engine.")]
        engine_s = max(r["t"] + r["dur"] for r in eng) \
            - min(r["t"] for r in eng)
        out["tune_transforms_gemm64"] = {
            "best": best, "delta": doc["delta"], "seconds": dt,
            "search_s": dt - engine_s, "card_engine_s": engine_s,
            "launches": counts}
        print(f"frontend tune --transforms gemm64 at 1 KB: {best} + "
              f"threads={w['threads']} chunk={w['chunk']}, delta "
              f"{doc['delta']:+.6g}; host search {dt - engine_s:.3f} s, "
              f"card engine {engine_s:.3f} s; kernel-1 launches "
              f"{counts['carried_event_hist']}", flush=True)
        so, err = host_only_call(out, "transform_seidel2d16_refused", [
            "transform", "seidel2d", "--n", "16", "--interchange", "0,1",
            "--check", "--json"], rc_want=1)
        check(json.loads(so)["verdict"] == "PL952"
              and "check skipped (PL952" in err,
              f"seidel2d interchange not refused: {so[:500]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"frontend phase: {out['seconds']:.3f} s", flush=True)
    emit({"phase": "frontend", **out, "ok": True})



def _env_scope(**env):
    """Set (or, for None, unset) environment variables; returns a function
    that puts the previous values back."""
    saved = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v

    def restore():
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return restore


def autotune_phase(by_path: dict, big_path: str, part_a) -> None:
    """Phase 24: the autotuner (``pluss_torch.autotune``) on the card, under
    a temporary plan-cache directory: ``calibrate(force=True)`` at the
    default 2^20 refs, every point's histogram bit-identical to the first
    (each point's kernel-2/3 launches and wall printed), the winner
    persisted under a salt that names the card and ``sm_90``; a second
    ``calibrate()`` short-circuits with one ``autotune.hit``;
    ``replay_file`` with no geometry kwargs resolves to the tuned values
    and returns the same histogram; part A of phase 17's trace (its first
    2^27 refs; the whole 2^28 was cut for the script's time limit)
    replays under the shipped defaults (consult off), the persisted
    winner, and the shipped defaults again, each timed and equal to phase
    17's replay of part A;
    ``cli autotune --dry-run`` exits 0, and with a doctored salt exits 1
    and counts ``autotune.stale``."""
    import numpy as np
    import torch

    from pluss_torch import autotune, obs, plancache, trace

    out: dict = {}
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="pluss_torch_autotune_")
    restore = _env_scope(PLUSS_PLAN_CACHE_DIR=os.path.join(tmp, "pc"),
                         PLUSS_NO_PLAN_CACHE=None, PLUSS_AUTOTUNE=None)
    autotune.invalidate()
    obs.configure(os.path.join(tmp, "events.jsonl"))
    points: list[dict] = []
    real = autotune._time_point

    def timed_point(path, geo, device):
        t0 = time.perf_counter()
        (r, dt), counts = counted(lambda: real(path, geo, device))
        points.append({"geometry": dict(geo), "launches": counts,
                       "wall_s": time.perf_counter() - t0, "timed_s": dt,
                       "refs_per_s": r.total_count / dt,
                       "hist": np.asarray(r.hist, np.int64).copy()})
        return r, dt

    autotune._time_point = timed_point
    try:
        n_refs = 1 << 20
        dev = torch.device("cuda")
        cands = autotune._candidates(autotune._base_geometry(n_refs, dev))
        buf = io.StringIO()
        t0 = time.perf_counter()
        doc = autotune.calibrate(force=True, out=buf)
        out["calibrate_s"] = time.perf_counter() - t0
        log = buf.getvalue()
        check("disqualified" not in log and "failed" not in log,
              f"autotune points: {log}")
        check([p["geometry"] for p in points] == cands,
              "autotune did not time every grid point once")
        for p in points:
            check(np.array_equal(p["hist"], points[0]["hist"]),
                  f"autotune point {p['geometry']} changed the histogram")
            g = p["geometry"]
            n_batches = -(-n_refs // (g["batch_windows"] * g["window"]))
            want = {"carried_event_hist": 0, "masked_hist": 2 * n_batches,
                    "d24v_decode": 2 * n_batches * (g["wire"] == "d24v")}
            check(p["launches"] == want,
                  f"autotune point {g}: launches {p['launches']} != {want}")
        by_path["autotune"] = {
            k: sum(p["launches"][k] for p in points)
            for k in points[0]["launches"]}
        salt = plancache.runtime_salt()
        name = torch.cuda.get_device_name(0)
        check(doc["salt"] == salt and name in salt and "/sm_90/" in salt,
              f"autotune salt {doc['salt']!r}")
        side = autotune.sidecar_path()
        check(side is not None and os.path.exists(side)
              and json.load(open(side)) == doc,
              "autotune winner not persisted")
        geo = doc["geometry"]
        check(geo in cands and "pallas" not in geo,
              f"autotune winner {geo}")
        # a second calibrate: one consult, no point timed
        autotune.invalidate()
        hit0 = obs.counters().get("autotune.hit", 0)
        buf = io.StringIO()
        again = autotune.calibrate(out=buf)
        check(again == doc and "already persisted" in buf.getvalue()
              and len(points) == len(cands)
              and obs.counters().get("autotune.hit", 0) - hit0 == 1,
              "second calibrate did not short-circuit on one hit")
        # replay_file with no geometry kwargs: the tuned values
        path = os.path.join(tmp, "calib.u64")
        autotune._synth_trace(path, n_refs)
        rep, counts = counted(lambda: trace.replay_file(path))
        by_path["autotune_replay"] = counts
        n_batches = -(-n_refs // (geo["batch_windows"] * geo["window"]))
        check(np.array_equal(np.asarray(rep.hist, np.int64),
                             points[0]["hist"])
              and rep.wire == geo["wire"]
              and rep.feed_workers == geo["feed_workers"]
              and counts["masked_hist"] == n_batches,
              f"tuned replay: wire {rep.wire}, workers "
              f"{rep.feed_workers}, launches {counts}, winner {geo}")
        # the winner against the shipped defaults at the size users
        # replay: part A of phase 17's trace, shipped / tuned / shipped
        big: dict = {"shipped_s": [], "tuned_s": []}
        for label in ("shipped", "tuned", "shipped"):
            scope = _env_scope(PLUSS_AUTOTUNE="0" if label == "shipped"
                               else None)
            try:
                window = trace._resolve_window(None, dev)
                t0 = time.perf_counter()
                r, counts = counted(lambda: trace.replay_file(
                    big_path, limit_refs=part_a.total_count))
                big[f"{label}_s"].append(time.perf_counter() - t0)
            finally:
                scope()
            by_path[f"autotune_2^27_{label}"] = counts
            big[f"{label}_launches"] = counts
            big[f"{label}_geometry"] = {"window": window,
                                        "wire": r.wire,
                                        "feed_workers": r.feed_workers}
            check(np.array_equal(r.hist, part_a.hist)
                  and r.total_count == part_a.total_count,
                  f"part A replay under the {label} geometry != phase 17's")
        print(f"autotune 2^27 replay: shipped {big['shipped_s']} s, "
              f"tuned {big['tuned_s']} s (winner {geo})", flush=True)
        out["replay_2^27"] = big
        rc, so, se = cli_call(["autotune", "--dry-run"])
        check(rc == 0 and "valid sidecar" in so, f"dry-run: {rc} {so} {se}")
        bad = dict(doc, salt=doc["salt"].replace("/sm_90/", "/sm_00/"))
        with open(side, "w") as f:
            json.dump(bad, f)
        autotune.invalidate()
        stale0 = obs.counters().get("autotune.stale", 0)
        rc, so, se = cli_call(["autotune", "--dry-run"])
        check(rc == 1 and "failed validation" in so
              and obs.counters().get("autotune.stale", 0) - stale0 == 1,
              f"doctored salt: rc {rc}, {so} {se}")
        for i, p in enumerate(points):
            print(f"autotune point {i}: {p['geometry']} launches "
                  f"{p['launches']} wall {p['wall_s']:.3f} s "
                  f"({p['refs_per_s']:.4g} refs/s timed)", flush=True)
        out.update({"salt": salt, "winner": geo,
                    "refs_per_s": doc["refs_per_sec"],
                    "points": [{k: v for k, v in p.items() if k != "hist"}
                               for p in points],
                    "second_calibrate_hits": 1, "dry_run": 0,
                    "doctored_dry_run": 1, "tuned_replay_launches": counts})
    finally:
        autotune._time_point = real
        obs.shutdown()
        restore()
        autotune.invalidate()
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "autotune", **out, "ok": True})


def sweep_phase(cfg, by_path: dict, sort_windows) -> None:
    """Phase 25: the sweep (``pluss_torch.sweep``) on the card: mvt-4000
    at threads 1, 2 and 4 with a journal, from cold plans, each point equal to a solo
    ``engine.run`` + ``cri.distribute`` + ``mrc.aet_mrc``, kernel 1 once
    per sort window of each point's plan; the resumed sweep recomputes
    nothing (no launch, every point stamped ``journal``); ``device_groups
    =2`` clamps to one group on one card and returns equal points; ``cli
    sweep --model gemm --n 64`` on the card prints what ``--cpu``
    prints."""
    import dataclasses

    import numpy as np

    from pluss_torch import cri, engine, mrc, sweep
    from pluss_torch.models import mvt

    out: dict = {}
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="pluss_torch_sweep_")
    try:
        spec, threads = mvt(4000), (1, 2, 4)
        cfgs = [dataclasses.replace(cfg, thread_num=t, chunk_size=4)
                for t in threads]
        journal = os.path.join(tmp, "sweep.jsonl")
        kw = dict(thread_nums=threads, chunk_sizes=(4,), base_cfg=cfg)
        # cold: no plan of an earlier phase is in the memo, so each point
        # plans while the precompile thread plans the next
        engine._plan_cached.cache_clear()
        t0 = time.perf_counter()
        pts, counts = counted(lambda: sweep.sweep(spec, journal=journal,
                                                  **kw))
        out["sweep_s"] = time.perf_counter() - t0
        want = sum(sort_windows(engine._plan_cached(spec, c, None, None,
                                                    None)) for c in cfgs)
        by_path["sweep"] = counts
        check(counts["carried_event_hist"] == want
              and counts["masked_hist"] == counts["d24v_decode"] == 0,
              f"sweep launches {counts}, the plans have {want} sort windows")
        for p in pts:
            res = engine.run(spec, p.cfg)
            ri = cri.distribute(res.noshare_list(), res.share_list(),
                                p.cfg.thread_num)
            check(np.array_equal(p.curve, mrc.aet_mrc(ri, p.cfg))
                  and p.total_refs == res.max_iteration_count
                  and p.degradations == (),
                  f"sweep point T={p.cfg.thread_num} != its solo run")
        t0 = time.perf_counter()
        resumed, counts = counted(lambda: sweep.sweep(
            spec, journal=journal, resume=True, **kw))
        out["resume_s"] = time.perf_counter() - t0
        by_path["sweep_resume"] = counts
        check(not any(counts.values())
              and all(p.degradations == ("journal",) for p in resumed)
              and all(np.array_equal(a.curve, b.curve)
                      for a, b in zip(resumed, pts)),
              f"resumed sweep recomputed ({counts})")
        t0 = time.perf_counter()
        grouped, counts = counted(lambda: sweep.sweep(spec, device_groups=2,
                                                      **kw))
        out["groups_s"] = time.perf_counter() - t0
        by_path["sweep_groups"] = counts
        check(counts["carried_event_hist"] == want
              and all(np.array_equal(a.curve, b.curve)
                      and a.total_refs == b.total_refs
                      for a, b in zip(grouped, pts)),
              f"device_groups=2 sweep != serial ({counts})")
        argv = ["sweep", "--model", "gemm", "--n", "64"]
        t0 = time.perf_counter()
        (rc, card_out, err), counts = counted(lambda: cli_call(argv))
        out["cli_card_s"] = time.perf_counter() - t0
        by_path["sweep_cli"] = counts
        check(rc == 0 and "predicted miss ratios" in card_out,
              f"cli sweep: rc {rc}: {err[-2000:]}")
        t0 = time.perf_counter()
        rc, cpu_out, err = cli_call(argv + ["--cpu"])
        out["cli_cpu_s"] = time.perf_counter() - t0
        check(rc == 0 and card_out == cpu_out,
              "cli sweep on the card != --cpu")
        out.update({"model": spec.name, "threads": threads,
                    "kernel1_launches": want,
                    "curves": [float(p.miss_ratio_at(4096)) for p in pts],
                    "cli_lines": len(card_out.splitlines())})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "sweep", **out, "ok": True})


def serve_phase(tmp: str, cfg, by_path: dict, trace_rep, resm,
                res1k) -> list[str]:
    """Phase 26: the serving daemon (``pluss_torch.serve``) in process on
    a unix socket in a temp dir, warmed with mvt-4000 and GEMM-1024, with
    a journal, a flight dir and a metrics endpoint: (a) four pipelined
    mvt-4000 requests differing in ``cache_kb``/``output`` share one
    dispatch on their first arrival (each ``batched`` 4, kernel 1 four
    times), each equal to phase 7's run; (b) a GEMM-1024 model request
    and a ``source`` request
    of ``gemm.ppcg_omp.c`` at ``N 1024`` give phase 6's histogram and MRC
    with no launch; (c) two trace requests on phase 17's 2^28 trace: the
    first stages through (kernels 3 and 2 sixteen times each), the second
    is a resident hit (kernel 2 sixteen times, kernel 3 none), both equal
    to phase 17's replay; no response of (a)-(c) carries a degradation
    and ``serve.breaker.brownout`` stays 0; (d) ``dispatch_fail@1,
    dispatch_fail@2`` open the breaker (threshold 2): a GEMM-64 request
    browns out, stamped ``cpu_brownout`` and equal to the card's clean
    run, a trace request is shed ``Overloaded`` with ``retry_after_ms``,
    and after the cooldown the probe closes the breaker; (e) on a second
    daemon with a 2 s dispatch timeout, ``hang@1`` is abandoned and
    answered typed, and the flight dump passes ``stats --check``; (f)
    ``{"op": "metrics"}`` equals ``GET /metrics``, a ``{"op":
    "shutdown"}`` line drains the daemon, every journaled request is
    done, the event stream passes ``stats --check`` and ``stats --trace``
    resolves (a)'s request to admit → queue → dispatch → demux.  Returns
    the latency lines printed beside the card line."""
    import dataclasses
    import urllib.request

    import numpy as np
    import torch

    from pluss_torch import cri, engine, obs, residency
    from pluss_torch.frontend import polybench
    from pluss_torch.models import gemm
    from pluss_torch.obs import stats as stats_mod
    from pluss_torch.obs import telemetry
    from pluss_torch.resilience import faults
    from pluss_torch.resilience.faults import FaultPlan
    from pluss_torch.serve import Client, RequestJournal, ServeConfig, Server
    from pluss_torch.serve.protocol import parse_request, result_payload

    out: dict = {}
    t_phase = time.perf_counter()
    trace_path = os.path.join(tmp, "smoke.bin")
    sdir = tempfile.mkdtemp(prefix="pluss_serve_")
    events = os.path.join(sdir, "events.jsonl")
    residency.reset()   # phase 19 left this trace resident
    obs.configure(events)
    latencies: dict[str, float] = {}

    def ok(r, label, batched=None):
        latencies[label] = r.get("latency_ms")
        check(r.get("ok") and "degradations" not in r
              and (batched is None or r["batched"] == batched),
              f"serve {label}: {str(r)[:500]}")
        return r

    def want_payload(obj, res, rcfg):
        ri = cri.distribute(res.noshare_list(), res.share_list(),
                            rcfg.thread_num)
        return result_payload(parse_request(obj), ri, rcfg)

    srv = Server(socket_path=os.path.join(sdir, "s.sock"),
                 config=ServeConfig(warm="mvt:4000,gemm:1024",
                                    journal_dir=sdir, flight_dir=sdir,
                                    metrics_port=0, breaker_threshold=2,
                                    breaker_cooldown_s=2.0,
                                    max_delay_ms=50))
    srv2 = None
    srv.start()
    try:
        with Client(srv.address, timeout=900) as c:
            t0 = time.perf_counter()
            while not c.request({"op": "ready"})["ready"]:
                check(time.perf_counter() - t0 < 300, "serve never ready")
                time.sleep(0.1)
            out["warm_s"] = time.perf_counter() - t0
            # (a) four pipelined mvt-4000 requests, one dispatch
            objs = [{"id": f"a{i}", "model": "mvt", "n": 4000,
                     "cache_kb": kb, "output": o}
                    for i, (kb, o) in enumerate(((256, "mrc"), (512, "both"),
                                                 (2560, "histogram"),
                                                 (8192, "both")))]
            # first arrival: admission's price, the plan memo and the warm
            # set key without cache_kb, so the warm entry covers all four
            hold = c.send({"sleep_ms": 300})
            time.sleep(0.1)
            d0 = engine.DEVICE_DISPATCHES
            rs, counts = counted(
                lambda: [c.recv(i) for i in [c.send(dict(o)) for o in objs]])
            c.recv(hold)
            by_path["serve_a"] = counts
            check(engine.DEVICE_DISPATCHES - d0 == 1
                  and counts == {"carried_event_hist": 4, "masked_hist": 0,
                                 "d24v_decode": 0},
                  f"serve (a): {engine.DEVICE_DISPATCHES - d0} dispatches, "
                  f"launches {counts}")
            for o, r in zip(objs, rs):
                ok(r, o["id"], batched=4)
                want = want_payload(o, resm, dataclasses.replace(
                    cfg, cache_kb=o["cache_kb"]))
                check(all(r.get(k) == v for k, v in want.items())
                      and r["refs"] == resm.max_iteration_count,
                      f"serve (a) {o['id']} != phase 7's run")
            # (b) GEMM-1024 as a model request and as pragma-C source
            src = open(polybench.gemm_source_path()).read() \
                .replace("#define N 128", "#define N 1024")
            want = want_payload({"model": "gemm", "n": 1024,
                                 "output": "both"}, res1k, cfg)
            for label, obj in (("b_model", {"model": "gemm", "n": 1024}),
                               ("b_source", {"source": src, "lang": "c",
                                             "name": "gemm_src1024"})):
                obj = dict(obj, id=label, output="both")
                r, counts = counted(lambda: c.request(obj))
                by_path[f"serve_{label}"] = counts
                ok(r, label)
                check(not any(counts.values())
                      and r["histogram"] == want["histogram"]
                      and r["mrc"] == want["mrc"]
                      and r["refs"] == res1k.max_iteration_count,
                      f"serve (b) {label} != phase 6's run ({counts})")
            # (c) the 2^28 trace: stage-through, then a resident hit
            want_hist = {str(int(k)): float(v)
                         for k, v in sorted(trace_rep.histogram().items())}
            hit0 = obs.counters().get("residency.hit", 0)
            for label, want_counts in (
                    ("c_stage_through", {"carried_event_hist": 0,
                                         "masked_hist": 16,
                                         "d24v_decode": 16}),
                    ("c_hit", {"carried_event_hist": 0, "masked_hist": 16,
                               "d24v_decode": 0})):
                r, counts = counted(lambda: c.request(
                    {"id": label, "trace": trace_path,
                     "output": "histogram"}))
                by_path[f"serve_{label}"] = counts
                ok(r, label)
                check(counts == want_counts
                      and r["histogram"] == want_hist
                      and r["refs"] == trace_rep.total_count
                      and r["n_lines"] == trace_rep.n_lines,
                      f"serve (c) {label}: launches {counts}")
            check(obs.counters().get("residency.hit", 0) - hit0 == 1
                  and obs.counters().get("residency.stage_through", 0) >= 1,
                  "serve (c): no stage-through then hit")
            check(not obs.counters().get("serve.breaker.brownout"),
                  "serve (a)-(c): a brown-out happened")
            # (d) two injected device failures open the breaker
            g64 = {"model": "gemm", "n": 64, "output": "both"}
            clean64 = engine.run(gemm(64), cfg)
            want64 = want_payload(g64, clean64, cfg)
            faults.install(FaultPlan.parse(
                "dispatch_fail@1,dispatch_fail@2"))
            try:
                for i in range(2):
                    r = c.request(dict(g64, id=f"d_fail{i}"))
                    check(not r["ok"]
                          and r["error"]["type"] == "ResourceExhausted",
                          f"serve (d) injected failure {i}: {r}")
            finally:
                faults.install(None)
            check(c.request({"op": "health"})["breaker"] == "open",
                  "serve (d): the breaker did not open")
            bo, counts = counted(lambda: c.request(dict(g64, id="d_brown")))
            by_path["serve_d_brownout"] = counts
            latencies["d_brown"] = bo.get("latency_ms")
            check(bo["ok"] and bo.get("degradations") == ["cpu_brownout"]
                  and bo["histogram"] == want64["histogram"]
                  and bo["mrc"] == want64["mrc"] and not any(counts.values()),
                  f"serve (d) brown-out: {str(bo)[:300]} {counts}")
            sh = c.request({"id": "d_shed", "trace": trace_path})
            check(not sh["ok"] and sh["error"]["type"] == "Overloaded"
                  and sh["error"].get("retry_after_ms", 0) > 0,
                  f"serve (d) trace not shed: {sh}")
            time.sleep(2.0 * 1.2 + 0.3)
            pr = ok(c.request(dict(g64, id="d_probe")), "d_probe")
            check(pr["histogram"] == want64["histogram"]
                  and c.request({"op": "health"})["breaker"] == "closed",
                  "serve (d): the probe did not close the breaker")
            out["breaker"] = {k: obs.counters().get(f"serve.breaker.{k}", 0)
                              for k in ("open", "close", "brownout",
                                        "shed")}
            # (e) a hung dispatch on a daemon with a short watchdog
            restore = _env_scope(PLUSS_SERVE_DISPATCH_TIMEOUT_S="2")
            try:
                srv2 = Server(socket_path=os.path.join(sdir, "w.sock"),
                              config=ServeConfig(flight_dir=sdir))
            finally:
                restore()
            srv2.start()
            with Client(srv2.address, timeout=300) as c2:
                restore = _env_scope(PLUSS_FAULT_HANG_S="6")
                faults.install(FaultPlan.parse("hang@1"))
                try:
                    t0 = time.perf_counter()
                    hung = c2.request(dict(g64, id="e-hang"))
                    out["watchdog_answer_s"] = time.perf_counter() - t0
                finally:
                    faults.install(None)
                    restore()
                check(not hung["ok"] and hung["error"]["type"] == "Overloaded"
                      and "watchdog" in hung["error"]["message"]
                      and out["watchdog_answer_s"] < 5.0,
                      f"serve (e): {hung}")
                ok(c2.request(dict(g64, id="e_after")), "e_after")
            dump = os.path.join(sdir, "flight-e-hang.jsonl")
            t0 = time.perf_counter()
            while not os.path.exists(dump):
                check(time.perf_counter() - t0 < 30, "serve (e): no dump")
                time.sleep(0.05)
            check(stats_mod.main(dump, io.StringIO(), io.StringIO(),
                                 check=True) == 0,
                  "serve (e): the flight dump fails stats --check")
            srv2.shutdown(drain_timeout_s=60)
            # (f) the metrics plane, then a drain by control line
            for attempt in range(3):
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{srv.metrics_port}/metrics",
                        timeout=30) as resp:
                    scraped = resp.read().decode()
                verb = c.request({"op": "metrics"})["text"]
                if verb == scraped:
                    break
            check(verb == scraped and "pluss_serve_ok" in verb,
                  "serve (f): op metrics != GET /metrics")
            check(c.request({"op": "shutdown"})["draining"],
                  "serve (f): shutdown not acknowledged")
        check(srv._drained.wait(300), "serve (f): drain did not finish")
        t0 = time.perf_counter()
        while os.path.exists(srv.socket_path):
            check(time.perf_counter() - t0 < 60, "serve (f): not stopped")
            time.sleep(0.05)
        check(not RequestJournal(os.path.join(
            sdir, "serve_journal.jsonl")).unanswered(),
            "serve (f): journaled requests left open")
        p50, p99 = srv.latency.quantile(0.5), srv.latency.quantile(0.99)
        telemetry.shutdown()
        check(stats_mod.main(events, io.StringIO(), io.StringIO(),
                             check=True) == 0,
              "serve (f): the event stream fails stats --check")
        buf = io.StringIO()
        check(stats_mod.main(events, buf, io.StringIO(), trace="a0") == 0,
              "serve (f): stats --trace a0 failed")
        tree = buf.getvalue()
        for needle in ("trace a0:", "admission.verdict", "serve.admit",
                       "serve.queue_wait", "serve.batch", "serve.demux"):
            check(needle in tree, f"serve (f): {needle} not in {tree}")
    finally:
        faults.install(None)
        for s_ in (srv, srv2):
            if s_ is not None:
                s_.shutdown(drain_timeout_s=60)
        obs.shutdown()
        residency.reset()
        shutil.rmtree(sdir, ignore_errors=True)
    out.update({"latency_ms": latencies, "slo_p50_ms": p50,
                "slo_p99_ms": p99})
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "serve", **out, "ok": True})
    return [f"serve latency_ms {json.dumps(latencies)}",
            f"serve SLO p50 {p50} ms, p99 {p99} ms"]



if __name__ == "__main__":
    sys.exit(main())
