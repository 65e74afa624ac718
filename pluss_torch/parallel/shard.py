"""Device-sharded sampling: the stream's round windows over several devices.

The port's counterpart of ``pluss/parallel/shard.py``.  Each simulated
thread's access stream is cut into round windows (the engine's windows,
on a grid of ``S`` windows per device), every device sorts its windows
locally, and the only cross-device state is a dense per-line boundary
table:

- each scope (a device's segment, or a chunk of windows) ends with its
  ``tail_pos[line]``, the last position it saw of each line;
- an access with no predecessor in its scope is captured as a HEAD, not
  counted as a cold miss;
- the heads of a scope resolve against the running max over the tails of
  every earlier scope (in global clock order: nest, then segment), which
  is the carried table the single-device scan threads through its windows:
  a reuse, a share event, or a cold miss;
- the histograms sum.

Two dispatch modes drive the same window bodies (``dispatch=``,
``PLUSS_SHARD_DISPATCH``, ``--shard-dispatch``):

- ``static``: segment ``d`` owns windows ``d*S .. d*S+S-1`` of every nest,
  and the heads settle in one exchange.  The exchange has two forms: in
  one process the D segments are stacked, resolved against a running max
  over earlier segments and summed; in a process group
  (``torch.distributed``, one segment per rank and device) the tails go
  through ``all_gather_into_tensor`` and the histograms through
  ``all_reduce``.  The only mode across processes.
- ``steal`` (``auto``'s pick on one process at 2^23 refs and more): the
  windows split into about four chunks per device, a host-side
  work-stealing dispatcher (:mod:`pluss_torch.parallel.steal`) hands them
  to one worker thread per listed device, and the host merges the chunk
  boundaries in canonical stream order, so the steal schedule never
  reaches the result.

A device list may name one device more than once: each entry is a worker
(``["cpu"] * 8`` on the host; four workers on ``cuda:0`` each run under
their own CUDA stream).  Windows run through the segmented kernel
(:func:`pluss_torch.ops.reuse.batch_events`, one thread's window per call,
kernel 2 for its histogram) by default; ``segmented=False`` takes the
legacy ghost-merged window (:func:`pluss_torch.engine._sort_window`, all
threads at once, kernel 1), bit-identical.

Departures from the JAX package, by design:

- a one-device list runs the shard path too (the JAX package hands it to
  ``engine.run``): the windows keep the engine's bound either way, and the
  dispatch, the boundary merge and the kernels run on one card;
- no share cap (the port's share uniques are exact), so there is no
  ``ShareCapExceeded`` retry;
- the JAX package turns its Pallas kernels off inside ``shard_map``; the
  port launches its kernels under both dispatch modes;
- no XLA executable cache: a chunk function is a plain function over the
  nest's device arrays, cached on the plan (``_chunk_fns``).
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from pluss_torch import engine, obs
from pluss_torch.config import DEFAULT, NBINS, SamplerConfig
from pluss_torch.engine import (SamplerResult, StreamPlan, add_static_share,
                                merge_share_windows, natural_n_windows,
                                shard_plan_cached)
from pluss_torch.ops.event_hist import event_histogram as carried_histogram
from pluss_torch.ops.reuse import (batch_events, bin_histogram,
                                   event_histogram, log2_bin, share_keys,
                                   share_mask, share_unique)
from pluss_torch.spec import LoopNestSpec
from pluss_torch.utils.envknob import env_bool, env_choice, env_int

#: dispatch-mode selector (``dispatch=`` / ``PLUSS_SHARD_DISPATCH`` /
#: ``--shard-dispatch``): ``steal``, ``static``, or ``auto`` (steal on one
#: process for a long run, static otherwise)
DISPATCH_CHOICES = ("auto", "steal", "static")


def default_devices(n: int | None = None, device=None) -> list:
    """The device list of a sharded run: the first ``n`` CUDA cards
    (default every card), or ``n`` workers on ``device`` when it is the
    CPU (default one).  ``device`` resolves as every entry point's does:
    the card unless the caller asks for the CPU."""
    dev = engine.resolve_device(device)
    if dev.type != "cuda":
        return [dev] * (n or 1)
    count = torch.cuda.device_count()
    n = n or count
    if n > count:
        raise ValueError(f"requested {n} devices, only {count} visible")
    return [torch.device("cuda", i) for i in range(n)]


def _as_devices(devices) -> list:
    return [torch.device(d) for d in devices]


def device_fingerprint(devices) -> tuple:
    """Stable identity of a device list for cross-run cache keys (the
    residency store): an entry staged on one list is never served to a
    run on another."""
    out = []
    for d in _as_devices(devices):
        idx = d.index
        if idx is None:
            idx = torch.cuda.current_device() if d.type == "cuda" else 0
        out.append((d.type, int(idx)))
    return tuple(out)


def _in_group() -> bool:
    """Whether this process belongs to an initialized ``torch.distributed``
    process group (a static run then exchanges through it, at any world
    size)."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def group_size() -> int:
    """Ranks of the initialized ``torch.distributed`` process group, 1
    without one (the JAX package's ``jax.process_count()``)."""
    import torch.distributed as dist

    return dist.get_world_size() if _in_group() else 1


def _resolve_dispatch(dispatch: str | None) -> str:
    """Validate a dispatch selector; ``auto`` stays ``auto`` (the caller
    settles it with :func:`_auto_steal`, which needs the run's size).
    Steal places chunks on this process's devices only, so it is refused
    in a process group."""
    if dispatch is None:
        dispatch = env_choice("PLUSS_SHARD_DISPATCH", "auto",
                              DISPATCH_CHOICES)
    if dispatch not in DISPATCH_CHOICES:
        raise ValueError(f"unknown shard dispatch {dispatch!r} (choices: "
                         f"{', '.join(DISPATCH_CHOICES)})")
    if dispatch == "steal" and group_size() > 1:
        raise RuntimeError(
            "dispatch='steal' places chunks on this process's devices only; "
            "a process group needs dispatch='static' (or 'auto', which "
            "picks it)")
    return dispatch


def _auto_steal(total_refs: int) -> bool:
    """``auto``: steal when the run is long enough for straggler imbalance
    to matter (``PLUSS_SHARD_STEAL_MIN_REFS`` accesses, default 2^23), on
    one process; a process group always takes the static exchange."""
    if group_size() > 1:
        return False
    return total_refs >= env_int("PLUSS_SHARD_STEAL_MIN_REFS", 1 << 23,
                                 minimum=0)


def _shard_segmented_default() -> bool:
    """The segmented window kernel unless ``PLUSS_SHARD_SEGMENTED=0``."""
    return env_bool("PLUSS_SHARD_SEGMENTED", True)


def _steal_seed(steal_seed: int | None) -> int:
    """Steal-schedule seed (``PLUSS_SHARD_STEAL_SEED``): it permutes the
    chunk -> worker map and the victim tie-breaks, never the result."""
    if steal_seed is not None:
        return int(steal_seed)
    return env_int("PLUSS_SHARD_STEAL_SEED", 0, minimum=0)


def _shard_geometry(spec: LoopNestSpec, cfg: SamplerConfig, D: int,
                    assignment, start_point, window_accesses):
    """``(plan, S)``: the window grid of both dispatch modes, ``S`` windows
    per device, each near the engine's window target."""
    S = max(1, -(-natural_n_windows(spec, cfg, assignment, start_point,
                                    window_accesses) // D))
    pl = shard_plan_cached(spec, engine.plan_cfg(cfg), assignment,
                           start_point, window_accesses, D * S)
    return pl, S


# ---------------------------------------------------------------------------
# the window body, shared by both modes


class _NestDevice:
    """One nest's plan arrays on one device, for every thread row."""

    def __init__(self, pl: StreamPlan, ni: int, device: torch.device):
        np_, cfg, spec = pl.nests[ni], pl.cfg, pl.spec
        self.np_, self.cfg, self.spec = np_, cfg, spec
        self.device = device
        self.pdt = torch.int32 if pl.pos_dtype == np.int32 else torch.int64
        self.n_lines = spec.total_lines(cfg)
        self.owned = torch.as_tensor(np_.owned, device=device).to(torch.int64)
        self.clock = None if np_.clock is None else \
            torch.as_tensor(np_.clock, device=device)
        self.nb = torch.as_tensor(pl.nest_base[ni], device=device)
        self.tids = torch.arange(cfg.thread_num, device=device)
        self.win_shift = np_.window_rounds * cfg.chunk_size * np_.body
        self.all_ranges = engine._array_ranges(np_.refs, spec, cfg)
        self.var_ranges = engine._array_ranges(np_.var_refs, spec, cfg)
        self.dtpl = None if np_.tpl is None else \
            engine._DeviceTemplate(np_.tpl, self.pdt, device)
        self.ultra = np_.ultra_windows()
        # bounded nests: each window's refs with the bucket's own trips
        self.brefs = {w: brefs for ws, brefs in (np_.tri_buckets or ())
                      for w in ws}


class _Scope:
    """The carried state of one scope (a segment or a chunk): ``last_pos``
    (ends as the scope's tails), the histogram, the captured heads and
    their share spans, each line table with a dump slot at ``n_lines``;
    and the window share keys gathered so far."""

    def __init__(self, nd: _NestDevice):
        T, L, dev = nd.cfg.thread_num, nd.n_lines, nd.device
        self.last_pos = torch.full((T, L + 1), -1, dtype=nd.pdt, device=dev)
        self.hist = torch.zeros((T, NBINS), dtype=torch.int64, device=dev)
        self.head_pos = torch.full((T, L + 1), -1, dtype=nd.pdt, device=dev)
        self.head_span = torch.zeros((T, L + 1), dtype=torch.int32,
                                     device=dev)
        self.keys: list[torch.Tensor] = []

    def capture(self, rows, cold, key_s, pos_s, span_s, L: int) -> None:
        """Record the scope's first touches (``cold``: no predecessor in
        the scope) of sorted rows; a line is cold at most once per scope,
        so every other entry writes into the dump slot."""
        idx = torch.where(cold, key_s, L).long()
        self.head_pos[rows].scatter_(-1, idx, pos_s)
        self.head_span[rows].scatter_(-1, idx, span_s.to(torch.int32))


def _row_stream(nd: _NestDevice, refs, w: int, t: int, with_clock: bool):
    """``(line, pos, span, valid)`` of thread ``t``'s window ``w`` over
    ``refs``, in program order (refs concatenated), 1-D."""
    np_, cfg, spec = nd.np_, nd.cfg, nd.spec
    bases = spec.line_bases(cfg)
    r0 = w * np_.window_rounds
    rows = slice(t, t + 1)
    clock = nd.clock[rows] if with_clock and nd.clock is not None else None
    spans = sorted({0, *(fr.ref.share_span or 0 for fr in refs)})
    parts = [engine._ref_window(fr, np_, cfg, nd.owned[rows], r0, nd.nb[rows],
                                bases[spec.array_index(fr.ref.array)],
                                nd.pdt, spans.index(fr.ref.share_span or 0),
                                clock)
             for fr in refs]
    line, pos, code, valid = (torch.cat([p[i][0] for p in parts])
                              for i in range(4))
    span = torch.tensor(spans, dtype=torch.int32,
                        device=nd.device)[code.long()]
    return line, pos, span, valid


def _sort_part(nd: _NestDevice, st: _Scope, refs, ranges, w: int,
               with_clock: bool, segmented: bool) -> None:
    """The sort-path part of window ``w`` over ``refs`` for every thread:
    events binned (no colds: those are heads), heads captured, tails
    carried, share keys kept."""
    L = nd.n_lines
    if segmented:
        # one thread's window per call: one sort, one carried gather, one
        # tail scatter; kernel 2 bins it
        for t in range(nd.cfg.thread_num):
            line, pos, span, valid = _row_stream(nd, refs, w, t, with_clock)
            ev = batch_events(line, pos, valid, st.last_pos[t], span=span,
                              pos_sorted=False)
            del line, pos, span, valid
            st.hist[t] += event_histogram(ev, include_cold=False)
            st.capture(t, ev["cold"], ev["key"], ev["pos"], ev["span"], L)
            st.keys.append(share_keys(ev["reuse"][None], ev["share"][None],
                                      nd.tids[t:t + 1]))
        return
    # legacy: every thread's ghost-merged window at once; kernel 1 bins
    # it, colds included in slot 0, which come off again
    clock = nd.clock if with_clock else None
    dh, ev, (key_s, pos_s, span_s) = engine._sort_window(
        nd.np_, refs, ranges, nd.spec, nd.cfg, nd.owned, w, nd.nb, nd.pdt,
        st.last_pos[:, :L], nd.win_shift, carried_histogram, clock,
        with_sorted=True)
    st.hist += dh
    st.hist[:, 0] -= ev["cold"].sum(dim=1)
    st.capture(slice(None), ev["cold"], key_s, pos_s, span_s, L)
    st.keys.append(share_keys(ev["reuse"], ev["share"], nd.tids))


def _template_part(nd: _NestDevice, st: _Scope, w: int) -> None:
    """The static-template part of ultra window ``w`` for every thread:
    its head lines resolve against the scope's carry (a line the scope
    has not seen is a head to capture), the local histogram adds, the
    tail lines carry."""
    dt = nd.dtpl
    tpl = dt.tpl
    units = (w - tpl.w0) * tpl.unit_w + (nd.tids - tpl.t0)
    dpos = ((w - tpl.w0) * tpl.pos_shift + nd.nb).to(nd.pdt)
    hl = dt.hline + dt.hdl * units[:, None]
    hp = dt.hpos + dpos[:, None]
    carried = st.last_pos.gather(1, hl)
    cold = carried < 0
    reuse = hp - carried
    share = ~cold & share_mask(reuse, dt.hspan)
    evt = ~cold & ~share
    st.hist += dt.lhist + bin_histogram(torch.where(evt, log2_bin(reuse), 0),
                                        evt)
    st.head_pos.scatter_(1, hl, torch.where(cold, hp,
                                            st.head_pos.gather(1, hl)))
    st.head_span.scatter_(1, hl, torch.where(cold, dt.hspan,
                                             st.head_span.gather(1, hl)))
    st.last_pos.scatter_(1, dt.tline + dt.tdl * units[:, None],
                         dt.tpos + dpos[:, None])
    st.keys.append(share_keys(reuse[:, dt.hs_idx], share[:, dt.hs_idx],
                              nd.tids))


def _nest_results(nd: _NestDevice, w_ids, segmented: bool):
    """One scope's results over windows ``w_ids`` of one nest, from a
    fresh carry: ``(hist [T, NBINS], share (keys, counts) or None,
    head_pos, head_span, tail_pos [T, n_lines])`` on the nest's device.

    A window takes the static template when it is clean for every thread
    (plus a sort of the template-ineligible arrays), the sort path
    otherwise."""
    np_, L = nd.np_, nd.n_lines
    st = _Scope(nd)
    for w in w_ids:
        if nd.ultra[w]:
            if np_.var_refs:
                _sort_part(nd, st, np_.var_refs, nd.var_ranges, w, False,
                           segmented)
            _template_part(nd, st, w)
        else:
            _sort_part(nd, st, nd.brefs.get(w, np_.refs), nd.all_ranges, w,
                       True, segmented)
    share = share_unique(torch.cat(st.keys)) if st.keys else None
    return (st.hist, share, st.head_pos[:, :L], st.head_span[:, :L],
            st.last_pos[:, :L])


def _chunk_fn(pl: StreamPlan, ni: int, segmented: bool, device):
    """The chunk function of nest ``ni`` on ``device``: window ids ->
    :func:`_nest_results`.  Cached on the plan (a module-level memo would
    keep every plan alive); the caller fills the cache on the dispatching
    thread before workers read it (:func:`_prepare`)."""
    cache = pl.__dict__.setdefault("_chunk_fns", {})
    key = (ni, segmented, str(device))
    fn = cache.get(key)
    if fn is None:
        nd = _NestDevice(pl, ni, device)
        fn = cache[key] = lambda w_ids: _nest_results(nd, w_ids, segmented)
    return fn


def _prepare(pl: StreamPlan, devices, segmented: bool) -> None:
    """Build every chunk function the run needs, check the sort budget of
    each device at its worker count, build the kernels, and wait for the
    uploads, all before any worker starts."""
    from pluss_torch.ops import build

    cfg = pl.cfg
    for dev in set(devices):
        for ni in range(len(pl.nests)):
            _chunk_fn(pl, ni, segmented, dev)
        workers = sum(1 for d in devices if d == dev)
        engine.check_sort_budget(
            pl.nests, pl.spec, cfg, pl.pos_dtype, engine.sort_budget(dev),
            workers * (1 if segmented else cfg.thread_num))
        if dev.type == "cuda":
            build.load("masked_hist" if segmented else "event_hist")
            torch.cuda.synchronize(dev)


def _to_host(out) -> tuple:
    """A scope's results on the host (the copies wait for its device)."""
    hist, share, hp, hs, tp = out
    share = None if share is None else (share[0].cpu(), share[1].cpu())
    return (hist.cpu().numpy(), share, hp.cpu().numpy().astype(np.int64),
            hs.cpu().numpy().astype(np.int64),
            tp.cpu().numpy().astype(np.int64))


class _Streams:
    """One CUDA stream per worker, made on first use by that worker's
    thread; a no-op context on the CPU."""

    def __init__(self, devices):
        self.devices = devices
        self._streams: dict[int, torch.cuda.Stream] = {}

    def __call__(self, wi: int):
        dev = self.devices[wi]
        if dev.type != "cuda":
            return contextlib.nullcontext()
        s = self._streams.get(wi)
        if s is None:
            s = self._streams[wi] = torch.cuda.Stream(dev)
        return torch.cuda.stream(s)


def _head_events(hp: np.ndarray, hs: np.ndarray, prev: np.ndarray):
    """``(cold, nevt, share, reuse)`` of captured heads against the
    carried tails ``prev`` (host arrays, -1 = none)."""
    has = hp >= 0
    evt = has & (prev >= 0)
    reuse = np.where(evt, hp - prev, 0)
    share = evt & share_mask(reuse, hs)
    return has & (prev < 0), evt & ~share, share, reuse


def np_head_hist(reuse_vals: np.ndarray) -> np.ndarray:
    """``[NBINS]`` host binning of head reuses: slot ``1+e`` for reuse in
    ``[2^e, 2^{e+1})`` by the frexp exponent (exact below 2^53).  Both
    boundary merges (:func:`_merge_chunks`, the trace replay's) bin
    through it."""
    slots = np.frexp(reuse_vals.astype(np.float64))[1].astype(np.int64)
    return np.bincount(slots, minlength=NBINS)[:NBINS]


def _head_pairs(reuse: np.ndarray, share: np.ndarray):
    """The ``[T, L]`` heads' share events as packed ``(keys, counts)``
    (row ``t`` is thread ``t``), None when there are none."""
    keys = share_keys(torch.from_numpy(reuse), torch.from_numpy(share))
    if not keys.numel():
        return None
    return keys, torch.ones_like(keys)


def _merge_share(pairs, T: int) -> list[dict]:
    """Per-thread raw share dicts of the scopes' ``(keys, counts)``."""
    pairs = [p for p in pairs if p is not None]
    return merge_share_windows([k for k, _ in pairs], [c for _, c in pairs],
                               T)


def _result(pl: StreamPlan, hist: np.ndarray, share_raw: list[dict],
            stats: dict) -> SamplerResult:
    """Box a sharded run, with the template nests' static in-window share
    events (one copy per thread and ultra window)."""
    add_static_share(share_raw,
                     [(n, int(n.ultra_windows().sum())) for n in pl.nests])
    return SamplerResult(noshare_dense=hist, share_raw=share_raw,
                         share_ratio=pl.cfg.thread_num - 1,
                         max_iteration_count=pl.total_count,
                         dispatch_stats=stats)


# ---------------------------------------------------------------------------
# static dispatch: one segment per device, one exchange


class _LocalExchange:
    """The exchange of the D segments of one process: already stacked."""

    def __init__(self, n_local: int):
        self.first, self.n_segments = 0, n_local

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return x


class _GroupExchange:
    """The exchange over a ``torch.distributed`` process group: each rank
    holds its own segments (rank-major), tails go through
    ``all_gather_into_tensor`` and sums through ``all_reduce``.  NCCL
    moves device tensors; gloo moves host tensors, so the exchange stages
    on the host (pinned, for a CUDA rank)."""

    def __init__(self, n_local: int, device: torch.device):
        import torch.distributed as dist

        self.dist = dist
        world, rank = dist.get_world_size(), dist.get_rank()
        self.first, self.n_segments = rank * n_local, world * n_local
        self.world = world
        self.wire = device if dist.get_backend() == "nccl" \
            else torch.device("cpu")

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous().to(self.wire)
        out = torch.empty((self.world * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=self.wire)
        self.dist.all_gather_into_tensor(out, x)
        return out.cpu()

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.wire)
        self.dist.all_reduce(x)
        return x.cpu()


def _gather_pairs(ex, pairs) -> list:
    """Every rank's share ``(keys, counts)`` on every rank: a rank's pairs
    as one, zero-padded to the longest rank's length for the gather (the
    padding's zero counts drop out)."""
    pairs = [p for p in pairs if p is not None]
    if isinstance(ex, _LocalExchange):
        return pairs
    empty = torch.empty(0, dtype=torch.int64)
    keys = torch.cat([k for k, _ in pairs]) if pairs else empty
    cnts = torch.cat([c for _, c in pairs]) if pairs else empty
    longest = torch.tensor([keys.numel()], dtype=torch.int64).to(ex.wire)
    ex.dist.all_reduce(longest, op=ex.dist.ReduceOp.MAX)
    m = int(longest.item())
    pad = lambda x: torch.cat([x, torch.zeros(m - x.numel(),
                                              dtype=torch.int64)])
    stacked = ex.gather(torch.stack([pad(keys), pad(cnts)])[None])
    return [(k[c > 0], c[c > 0]) for k, c in stacked]


def _run_segments(devices, fn) -> list:
    """``fn(i)`` for each local segment ``i``, one thread each under its
    worker's stream when there are several; the first error re-raises."""
    streams = _Streams(devices)
    out: list = [None] * len(devices)
    errors: list = []

    def one(i: int) -> None:
        try:
            with streams(i):
                out[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    if len(devices) == 1:
        one(0)
    else:
        threads = [threading.Thread(target=one, args=(i,), daemon=True,
                                    name=f"pluss-shard-{i}")
                   for i in range(len(devices))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    if errors:
        raise errors[0]
    return out


def _shard_run_static(spec, cfg, devices, assignment, start_point,
                      window_accesses, segmented: bool) -> SamplerResult:
    T = cfg.thread_num
    ex = _GroupExchange(len(devices), devices[0]) if _in_group() \
        else _LocalExchange(len(devices))
    D = ex.n_segments
    pl, S = _shard_geometry(spec, cfg, D, assignment, start_point,
                            window_accesses)
    N = len(pl.nests)
    _prepare(pl, devices, segmented)

    def segment(i: int):
        g = ex.first + i
        outs = [_to_host(_chunk_fn(pl, ni, segmented, devices[i])(
            range(g * S, g * S + S))) for ni in range(N)]
        return (sum(o[0] for o in outs), [o[1] for o in outs],
                np.stack([o[2] for o in outs], axis=1),
                np.stack([o[3] for o in outs], axis=1),
                np.stack([o[4] for o in outs], axis=1))

    with obs.span("shard.dispatch", model=spec.name, backend="static",
                  devices=D, segmented=segmented):
        local = _run_segments(devices, segment)
        # [D, T, N, L]: the only cross-device state
        tails = ex.gather(torch.from_numpy(
            np.stack([s[4] for s in local]))).numpy()
        hist = sum(s[0] for s in local)
        pairs = [p for s in local for p in s[1]]
        prev = np.full(tails.shape[1:2] + tails.shape[3:], -1, np.int64)
        for ni in range(N):
            for g in range(D):
                i = g - ex.first
                if 0 <= i < len(local):
                    cold, nevt, share, reuse = _head_events(
                        local[i][2][:, ni], local[i][3][:, ni], prev)
                    hist[:, 0] += cold.sum(axis=1)
                    for t in range(T):
                        if nevt[t].any():
                            hist[t] += np_head_hist(reuse[t][nevt[t]])
                    pairs.append(_head_pairs(reuse, share))
                prev = np.maximum(prev, tails[g, :, ni])
        hist = ex.sum(torch.from_numpy(hist)).numpy()
        share_raw = _merge_share(_gather_pairs(ex, pairs), T)
    obs.counter_add("engine.refs_processed", pl.total_count)
    return _result(pl, hist, share_raw, {"dispatch": "static", "devices": D})


# ---------------------------------------------------------------------------
# steal dispatch: chunks over worker threads, a canonical-order merge


def _chunk_windows_of(S: int) -> int:
    """Windows per chunk: about four chunks per device's static share, so
    an idle worker always has something to steal
    (``PLUSS_SHARD_CHUNK_WINDOWS`` overrides)."""
    return env_int("PLUSS_SHARD_CHUNK_WINDOWS", max(1, S // 4))


def _chunk_plan(pl: StreamPlan, S: int) -> list[tuple[int, int, int]]:
    """``[(nest, w_lo, w_len)]`` chunks in canonical (stream) order."""
    cw = _chunk_windows_of(S)
    return [(ni, lo, min(cw, np_.n_windows - lo))
            for ni, np_ in enumerate(pl.nests)
            for lo in range(0, np_.n_windows, cw)]


def _run_steal(pl: StreamPlan, devices, S: int, segmented: bool, seed: int):
    """Dispatch the chunk plan over the workers with work stealing.
    Returns ``(chunks, results {chunk id: host tuple}, stats)``; a worker
    fetches each chunk's results before it takes the next."""
    from pluss_torch.parallel.steal import StealDispatcher

    chunks = _chunk_plan(pl, S)
    _prepare(pl, devices, segmented)
    streams = _Streams(devices)
    results: dict[int, tuple] = {}

    def run_chunk(wi: int, ci: int) -> None:
        ni, lo, ln = chunks[ci]
        with streams(wi):
            results[ci] = _to_host(_chunk_fn(pl, ni, segmented,
                                             devices[wi])(range(lo, lo + ln)))

    disp = StealDispatcher(len(chunks), len(devices), run_chunk, seed=seed)
    return chunks, results, disp.run()


def _merge_chunks(pl: StreamPlan, chunks, results):
    """Canonical-order boundary merge of the chunk outputs: heads of chunk
    ``k`` resolve against the running per-line max of earlier chunks'
    tails, the host twin of the static exchange.  Only the (fixed) chunk
    partition and this (fixed) order reach the result."""
    T = pl.cfg.thread_num
    prev = np.full((T, pl.spec.total_lines(pl.cfg)), -1, np.int64)
    hist = np.zeros((T, NBINS), np.int64)
    pairs = []
    for ci in range(len(chunks)):
        h, share, hp, hs, tp = results[ci]
        hist += h
        cold, nevt, sh, reuse = _head_events(hp, hs, prev)
        hist[:, 0] += cold.sum(axis=1)
        for t in range(T):
            if nevt[t].any():
                hist[t] += np_head_hist(reuse[t][nevt[t]])
        pairs += [share, _head_pairs(reuse, sh)]
        prev = np.where(tp >= 0, tp, prev)
    return hist, _merge_share(pairs, T)


def _shard_run_steal(spec, cfg, devices, assignment, start_point,
                     window_accesses, segmented: bool,
                     seed: int) -> SamplerResult:
    D = len(devices)
    pl, S = _shard_geometry(spec, cfg, D, assignment, start_point,
                            window_accesses)
    with obs.span("shard.dispatch", model=spec.name, backend="steal",
                  devices=D, segmented=segmented) as sp:
        chunks, results, stats = _run_steal(pl, devices, S, segmented, seed)
        hist, share_raw = _merge_chunks(pl, chunks, results)
        sp.set(chunks=len(chunks), steals=stats["steals"])
    obs.counter_add("engine.refs_processed", pl.total_count)
    obs.counter_add("shard.chunks", len(chunks))
    obs.counter_add("shard.steals", stats["steals"])
    for i, bf in enumerate(stats["busy_frac"]):
        obs.gauge_set(f"shard.device_busy_frac.{i}", round(bf, 4))
    return _result(pl, hist, share_raw,
                   {"dispatch": "steal", "devices": D, "chunks": len(chunks),
                    "steals": stats["steals"],
                    "busy_frac": stats["busy_frac"],
                    "ran_by": stats["ran_by"]})


def shard_run(spec: LoopNestSpec, cfg: SamplerConfig = DEFAULT, *,
              devices=None, assignment=None, start_point=None,
              window_accesses: int | None = None,
              dispatch: str | None = None,
              segmented: bool | None = None,
              steal_seed: int | None = None) -> SamplerResult:
    """Run the sampler with its stream windows sharded over ``devices``
    (default :func:`default_devices`: every card), equal to
    :func:`pluss_torch.engine.run`.

    ``assignment``/``start_point``/``window_accesses`` as in
    ``engine.run``.  ``dispatch``: ``steal``, ``static`` or ``auto``/None
    (``PLUSS_SHARD_DISPATCH``); ``segmented``: the window kernel
    (``PLUSS_SHARD_SEGMENTED``; default the segmented one);
    ``steal_seed`` permutes the steal schedule, never the result.  In an
    initialized ``torch.distributed`` process group, ``devices`` are this
    rank's own (one segment each) and the dispatch is static.
    """
    from pluss_torch.resilience import faults

    faults.check("shard.run")   # chaos injection site (per entry attempt)
    devices = _as_devices(devices) if devices is not None \
        else default_devices()
    if not devices:
        raise ValueError("shard_run needs at least one device")
    assignment = engine._freeze(assignment)
    mode = _resolve_dispatch(dispatch)
    if mode == "auto":
        pl0, _ = _shard_geometry(spec, cfg, len(devices) * group_size(),
                                 assignment, start_point, window_accesses)
        mode = "steal" if _auto_steal(pl0.total_count) else "static"
    if segmented is None:
        segmented = _shard_segmented_default()
    if mode == "steal":
        return _shard_run_steal(spec, cfg, devices, assignment, start_point,
                                window_accesses, bool(segmented),
                                _steal_seed(steal_seed))
    return _shard_run_static(spec, cfg, devices, assignment, start_point,
                             window_accesses, bool(segmented))
