"""The sampler engine: affine stream enumeration + sort-based reuse, in torch.

Counterpart of ``pluss/engine.py`` for rectangular nests.  Every occurrence
of every static reference is materialized by broadcast arithmetic straight
from the :class:`~pluss_torch.spec.FlatRef` affine forms:

- stream position  ``pos  = nest_base + rank*stride0 + sum(idx_l*stride_l) + offset``
- element address  ``addr = base + sum(coef_l * iv_l)`` -> cache line ``addr*DS//CLS``

The stream is processed in round windows, in a Python loop that carries a
dense ``last_pos [T, n_lines]`` table and the ``[T, NBINS]`` histogram on the
device (the JAX package's ``lax.scan``); both are updated in place.  The
simulated threads are the leading ``T`` dimension of every tensor (the JAX
package's ``vmap`` axis): per-thread state is disjoint, so rows never
interact until the host merge.

Each window takes one of two paths:

- **static template** ("ultra" windows, clean for every thread): the local
  event analysis of a clean window is done once on the host at plan time
  (:func:`_build_template`), so the device resolves only the window's head
  lines against the carried table, updates its tail lines and adds the
  precomputed local histogram — O(lines), not O(accesses).
- **ghost-merged sort**: the window's accesses and one ghost entry per
  covered line sort by (line, pos); the hand-written carried-event kernel
  (:mod:`pluss_torch.ops.event_hist`) bins the events, and the tails update
  the carried table.  Arrays that break the template's shift invariance take
  this path inside ultra windows too.

The host plan is numpy; :func:`run` places the device part on CUDA unless the
caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pluss_torch.config import DEFAULT, NBINS, SamplerConfig
from pluss_torch.ops.event_hist import event_histogram
from pluss_torch.ops.reuse import (
    SHARE_SHIFT,
    bin_histogram,
    carried_events,
    extract_tails,
    ghost_entries,
    log2_bin,
    share_keys,
    share_mask,
    share_unique,
    sort_stream,
)
from pluss_torch.sched import ChunkSchedule
from pluss_torch.spec import (
    FlatRef,
    LoopNestSpec,
    flatten_nest,
    nest_iteration_size,
)

#: default accesses per window (per simulated thread)
WINDOW_TARGET = 1 << 23

#: largest window the plan-time template analysis will host-lexsort; bigger
#: windows take the device sort path
MAX_TEMPLATE_WINDOW = 1 << 29


@dataclasses.dataclass(frozen=True)
class WindowTemplate:
    """Static structure shared by ALL clean windows of a nest.

    Every clean window of every thread is a rigid shift of every other
    (under the conditions of :func:`_split_ref_groups`): same sort order,
    same in-window reuses and share classes, same head/tail line structure;
    only line ids and positions move, linearly in
    ``units = (w - w0)*W*T + (t - t0)``.
    """

    t0: int                   # template origin thread
    w0: int                   # template origin window
    unit_w: int               # units advanced per window step = W*T
    pos_shift: int            # positions advanced per window = W*CS*body
    local_hist: np.ndarray    # [NBINS] in-window (non-head) event histogram
    share_vals: np.ndarray    # [S] static in-window share reuse values
    share_cnts: np.ndarray    # [S] their per-window counts
    head_line: np.ndarray     # [H] int32 first-touch line ids at the origin
    head_pos: np.ndarray      # [H] their stream positions (origin-relative)
    head_span: np.ndarray     # [H] int32 share span of the head's ref (0=none)
    head_dline: np.ndarray    # [H] int32 line shift per unit
    hs_idx: np.ndarray        # [Hs] indices into H with span>0
    tail_line: np.ndarray     # [Ht] int32 last-touch line ids at the origin
    tail_pos: np.ndarray      # [Ht]
    tail_dline: np.ndarray    # [Ht] int32


@dataclasses.dataclass(frozen=True)
class NestPlan:
    sched: ChunkSchedule
    refs: tuple[FlatRef, ...]
    body: int                 # accesses per parallel iteration
    owned: np.ndarray         # [T, NW*W] global chunk ids, -1 = none
    window_rounds: int        # W
    n_windows: int            # NW
    tpl: WindowTemplate | None = None      # static-window fast path
    clean: np.ndarray | None = None        # [T, NW] bool: window is clean
    #: refs of template-INELIGIBLE arrays: they run the sort path in every
    #: window, alongside the template.  Equal to ``refs`` without a template.
    var_refs: tuple[FlatRef, ...] = ()

    def ultra_windows(self) -> np.ndarray:
        """[NW] bool: windows on the static-template path (clean for EVERY
        thread, template available)."""
        if self.clean is None or self.tpl is None:
            return np.zeros(self.n_windows, bool)
        return self.clean.all(axis=0)


@dataclasses.dataclass(frozen=True, eq=False)
class StreamPlan:
    """Static description of one workload's per-thread streams."""

    spec: LoopNestSpec
    cfg: SamplerConfig
    nests: tuple[NestPlan, ...]
    iters_per_thread: np.ndarray      # [n_nests, T] true parallel iterations
    nest_base: np.ndarray             # [n_nests, T] clock offset of each nest
    total_count: int                  # true total accesses over all threads
    pos_dtype: np.dtype               # stream-position dtype (int32 | int64)


def _owned_matrix(sched: ChunkSchedule, T: int) -> np.ndarray:
    """[T, R] global chunk ids each thread serves under the static
    round-robin schedule (chunk ``cid`` -> thread ``cid % T``), -1 padded.
    Rows ascend, so the only partial chunk (the globally last) ends its
    owner's stream and the closed-form clock ``rank*body`` stays gapless."""
    R = max(-(-sched.n_chunks // T), 1)
    cid = np.arange(R * T, dtype=np.int64).reshape(R, T).T
    return np.where(cid < sched.n_chunks, cid, -1).astype(np.int32)


def _np_ref_window(fr: FlatRef, np_rounds: int, cfg: SamplerConfig, sched,
                   owned_row: np.ndarray, r0: int, line_base: int):
    """Host (numpy) enumeration of one ref over rounds [r0, r0+np_rounds) of
    one thread — the template's input.  Omits the nest_base offset: a
    constant shift of every pos cannot change a lexsort."""
    CS = cfg.chunk_size
    shape = (np_rounds, CS) + fr.trips[1:]
    nd = len(shape)

    def iota(axis):
        return np.arange(shape[axis], dtype=np.int64).reshape(
            (1,) * axis + (-1,) + (1,) * (nd - axis - 1))

    r, p = iota(0), iota(1)
    g = owned_row[r0 + r] * CS + p
    pos = ((r0 + r) * CS + p) * fr.pos_strides[0] + fr.offset
    addr = fr.ref.addr_base + fr.addr_coefs[0] * (sched.start + g * sched.step)
    for l in range(1, len(fr.trips)):
        idx = iota(l + 1)
        pos = pos + idx * fr.pos_strides[l]
        if fr.addr_coefs[l]:
            addr = addr + fr.addr_coefs[l] * (fr.starts[l] + idx * fr.steps[l])
    line = line_base + addr * cfg.ds // cfg.cls
    line, pos = np.broadcast_to(line, shape), np.broadcast_to(pos, shape)
    return line.reshape(-1), pos.reshape(-1)


def _split_ref_groups(refs, sched, cfg: SamplerConfig):
    """Partition refs BY ARRAY into (template-eligible, sort-path) groups.

    Line ranges of different arrays are disjoint, so shift invariance of the
    window sort order is required only per array: every ref of the array
    shares one parallel-dim address coefficient, and the per-chunk address
    shift is a whole number of cache lines.  Arrays failing either test run
    the device sort path alone.
    """
    bad: set[str] = set()
    coef_by_array: dict[str, int] = {}
    for fr in refs:
        c0 = fr.addr_coefs[0]
        if coef_by_array.setdefault(fr.ref.array, c0) != c0:
            bad.add(fr.ref.array)
        if (abs(c0 * cfg.chunk_size * sched.step) * cfg.ds) % cfg.cls:
            bad.add(fr.ref.array)
    return (tuple(fr for fr in refs if fr.ref.array not in bad),
            tuple(fr for fr in refs if fr.ref.array in bad))


def _clean_windows(owned: np.ndarray, W: int, NW: int, CS: int,
                   trip: int) -> np.ndarray:
    """[T, NW] bool: every chunk of the window exists and is full."""
    cids = owned.reshape(owned.shape[0], NW, W)
    return (cids >= 0).all(axis=2) & (cids.max(axis=2) * CS + CS <= trip)


def _build_template(refs, W, cfg, sched, owned, clean, bases, array_index,
                    body: int) -> WindowTemplate | None:
    """Analyze the first clean window on the host; None if none is clean."""
    t_w = np.argwhere(clean)
    if len(t_w) == 0:
        return None
    t0, w0 = int(t_w[0, 0]), int(t_w[0, 1])
    lines, poss, spans, dlines = [], [], [], []
    for fr in refs:
        line, pos = _np_ref_window(fr, W, cfg, sched, owned[t0], w0 * W,
                                   bases[array_index(fr.ref.array)])
        # line shift per unit chunk offset; integral by _split_ref_groups
        d = fr.addr_coefs[0] * sched.step * cfg.chunk_size * cfg.ds
        lines.append(line)
        poss.append(pos)
        spans.append(np.full(line.shape, fr.ref.share_span or 0, np.int32))
        dlines.append(np.full(line.shape, d // cfg.cls, np.int32))
    line, pos = np.concatenate(lines), np.concatenate(poss)
    span, dline = np.concatenate(spans), np.concatenate(dlines)
    order = np.lexsort((pos, line))
    line, pos, span, dline = line[order], pos[order], span[order], dline[order]

    same = line[1:] == line[:-1]
    local = np.concatenate([[False], same])          # has an in-window prev
    headm = ~local
    tailm = ~np.concatenate([same, [False]])
    prev = np.concatenate([[0], pos[:-1]])
    reuse = np.where(local, pos - prev, 0)
    share = local & share_mask(reuse, span)
    evt = local & ~share
    # slot 1+e for reuse in [2^e, 2^{e+1}): frexp's exponent is exactly 1+e
    slots = np.frexp(reuse[evt].astype(np.float64))[1].astype(np.int64)
    local_hist = np.bincount(slots, minlength=NBINS).astype(np.int64)
    share_vals, share_cnts = np.unique(reuse[share], return_counts=True)
    head_span = span[headm]
    return WindowTemplate(
        t0=t0,
        w0=w0,
        unit_w=W * cfg.thread_num,
        pos_shift=W * cfg.chunk_size * body,
        local_hist=local_hist,
        share_vals=share_vals.astype(np.int64),
        share_cnts=share_cnts.astype(np.int64),
        head_line=line[headm].astype(np.int32),
        head_pos=pos[headm],
        head_span=head_span,
        head_dline=dline[headm],
        hs_idx=np.nonzero(head_span > 0)[0].astype(np.int32),
        tail_line=line[tailm].astype(np.int32),
        tail_pos=pos[tailm],
        tail_dline=dline[tailm],
    )


def _nest_geometry(spec: LoopNestSpec, cfg: SamplerConfig, target: int):
    """Per nest ``(sched, refs, body, owned, W, NW)``: schedule, owned-chunk
    matrix and the window split at ``target`` accesses per window.  Windows
    never split a chunk round."""
    T = cfg.thread_num
    out = []
    for nest in spec.nests:
        sched = ChunkSchedule(cfg.chunk_size, nest.trip, nest.start,
                              nest.step)
        refs = tuple(flatten_nest(nest))
        body = nest_iteration_size(nest)
        owned = _owned_matrix(sched, T)
        R = owned.shape[1]
        W = max(1, min(R, -(-target // (cfg.chunk_size * body))))
        out.append((sched, refs, body, owned, W, -(-R // W)))
    return out


def plan(spec: LoopNestSpec, cfg: SamplerConfig = DEFAULT,
         window_accesses: int | None = None) -> StreamPlan:
    """Build the static stream plan (host, numpy).

    ``window_accesses``: accesses per window per thread (default
    WINDOW_TARGET).  Raises ``NotImplementedError`` for nests outside the
    rectangular contract (see :func:`pluss_torch.spec.check_rectangular`).
    """
    T = cfg.thread_num
    geom = []
    for sched, refs, body, owned, W, NW in _nest_geometry(
            spec, cfg, window_accesses or WINDOW_TARGET):
        pad = np.full((T, NW * W - owned.shape[1]), -1, np.int32)
        geom.append((sched, refs, body,
                     np.concatenate([owned, pad], axis=1), W, NW))

    # the padded per-thread clock bound picks the position dtype; the full
    # int32 range is usable because no event math doubles a position
    max_clock = sum(NW * W * cfg.chunk_size * body
                    for _, _, body, _, W, NW in geom)
    pos_dtype = np.dtype(np.int32) if max_clock < 2**31 - 2 \
        else np.dtype(np.int64)

    nests: list[NestPlan] = []
    iters = np.zeros((len(spec.nests), T), np.int64)
    for ni, (sched, refs, body, owned, W, NW) in enumerate(geom):
        tpl = clean = None
        var_refs = refs
        # oversize windows would make the host template analysis itself the
        # bottleneck: those nests take the device sort path
        if W * cfg.chunk_size * body <= MAX_TEMPLATE_WINDOW:
            clean = _clean_windows(owned, W, NW, cfg.chunk_size, sched.trip)
            tpl_refs, split_var = _split_ref_groups(refs, sched, cfg)
            if tpl_refs:
                tpl = _build_template(tpl_refs, W, cfg, sched, owned, clean,
                                      spec.line_bases(cfg), spec.array_index,
                                      body)
                if tpl is not None:
                    var_refs = split_var
        nests.append(NestPlan(sched, refs, body, owned, W, NW, tpl, clean,
                              var_refs))
        g0 = owned.astype(np.int64) * cfg.chunk_size
        iters[ni] = np.where(owned >= 0,
                             np.clip(sched.trip - g0, 0, cfg.chunk_size),
                             0).sum(axis=1)
    acc = iters * np.array([n.body for n in nests], np.int64)[:, None]
    nest_base = np.zeros_like(acc)
    nest_base[1:] = np.cumsum(acc[:-1], axis=0)
    return StreamPlan(spec=spec, cfg=cfg, nests=tuple(nests),
                      iters_per_thread=iters, nest_base=nest_base,
                      total_count=int(acc.sum()), pos_dtype=pos_dtype)


def _segments_of(np_: NestPlan) -> list[tuple[bool, list[int]]]:
    """Window segments of one nest in processing order: runs of consecutive
    windows on the same path, ``(is_ultra, window_ids)``.  A window takes
    the template path only when it is clean for EVERY thread (the threads
    run in lockstep as rows of one batch)."""
    ultra_w = np_.ultra_windows()
    segments: list[tuple[bool, list[int]]] = []
    for w in range(np_.n_windows):
        if segments and segments[-1][0] == bool(ultra_w[w]):
            segments[-1][1].append(w)
        else:
            segments.append((bool(ultra_w[w]), [w]))
    return segments


def _array_ranges(refs, spec, cfg) -> tuple[tuple[int, int], ...]:
    """Ascending (line_base, line_count) of the arrays the refs touch — the
    ghost coverage a sort window needs."""
    bases, counts = spec.line_bases(cfg), spec.line_counts(cfg)
    idxs = sorted({spec.array_index(fr.ref.array) for fr in refs})
    return tuple((bases[i], counts[i]) for i in idxs)


def _ref_window(fr: FlatRef, np_: NestPlan, cfg: SamplerConfig,
                owned: torch.Tensor, r0: int, nb: torch.Tensor,
                line_base: int, pdt: torch.dtype):
    """``[T, n]`` (line, pos, span, valid) of one ref over rounds
    [r0, r0+W) for every thread; ``owned`` is the nest's [T, NW*W] chunk
    matrix on the device and ``nb`` the [T] nest clock offsets."""
    CS = cfg.chunk_size
    W = np_.window_rounds
    sched = np_.sched
    T = owned.shape[0]
    shape = (T, W, CS) + fr.trips[1:]
    nd = len(shape)
    dev = owned.device

    def iota(axis):
        return torch.arange(shape[axis], dtype=torch.int64, device=dev).view(
            (1,) * axis + (-1,) + (1,) * (nd - axis - 1))

    r, p = iota(1), iota(2)
    cid = owned[:, r0:r0 + W].view((T, W) + (1,) * (nd - 2))
    g = cid * CS + p
    valid = (cid >= 0) & (g < sched.trip)
    pos = nb.view((T,) + (1,) * (nd - 1)) \
        + ((r0 + r) * CS + p) * fr.pos_strides[0] + fr.offset
    addr = fr.ref.addr_base + fr.addr_coefs[0] * (sched.start + g * sched.step)
    for l in range(1, len(fr.trips)):
        idx = iota(l + 2)
        pos = pos + idx * fr.pos_strides[l]
        if fr.addr_coefs[l]:
            addr = addr + fr.addr_coefs[l] * (fr.starts[l] + idx * fr.steps[l])
    line = line_base + torch.div(addr * cfg.ds, cfg.cls, rounding_mode="floor")
    flat = lambda x, dt: x.expand(shape).reshape(T, -1).to(dt)
    return (flat(line, torch.int32), flat(pos, pdt),
            torch.full((T, int(np.prod(shape[1:]))), fr.ref.share_span or 0,
                       dtype=torch.int32, device=dev),
            flat(valid, torch.bool))


def _sort_window(np_: NestPlan, refs, ranges, spec, cfg, owned, w: int,
                 nb: torch.Tensor, pdt, last_pos: torch.Tensor,
                 win_shift: int, hist: torch.Tensor, event_hist):
    """One sort-path window over ``refs``, ghost-merged with the carry.

    The carried ``last_pos`` slices of the covered arrays enter the sort as
    ghost entries, so every access's predecessor is its sorted left
    neighbour; ``event_hist`` bins the window's events into ``hist`` and the
    segment tails are written back into ``last_pos`` (both in place).
    Returns the window's event dict (for the share extraction).
    """
    r0 = w * np_.window_rounds
    bases = spec.line_bases(cfg)
    parts = [_ref_window(fr, np_, cfg, owned, r0, nb,
                         bases[spec.array_index(fr.ref.array)], pdt)
             for fr in refs]
    parts += [ghost_entries(last_pos[:, b:b + c], b) for b, c in ranges]
    key_s, pos_s, span_s, valid_s = sort_stream(
        *(torch.cat([p[i] for p in parts], dim=1) for i in range(4)))
    win_start = (nb + w * win_shift).to(pdt)
    hist += event_hist(key_s, pos_s, span_s, valid_s, win_start)
    ev = carried_events(key_s, pos_s, span_s, valid_s, win_start)
    tails = extract_tails(key_s, pos_s, valid_s, sum(c for _, c in ranges))
    off = 0
    for b, c in ranges:
        last_pos[:, b:b + c] = tails[:, off:off + c]
        off += c
    return ev


class _DeviceTemplate:
    """A nest's :class:`WindowTemplate` arrays as device tensors."""

    def __init__(self, tpl: WindowTemplate, pdt, device):
        as_t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a),
                                             device=device).to(dt)
        self.tpl = tpl
        self.hline = as_t(tpl.head_line, torch.int64)
        self.hpos = as_t(tpl.head_pos, pdt)
        self.hspan = as_t(tpl.head_span, torch.int32)
        self.hdl = as_t(tpl.head_dline, torch.int64)
        self.tline = as_t(tpl.tail_line, torch.int64)
        self.tpos = as_t(tpl.tail_pos, pdt)
        self.tdl = as_t(tpl.tail_dline, torch.int64)
        self.lhist = as_t(tpl.local_hist, torch.int64)
        self.hs_idx = as_t(tpl.hs_idx, torch.int64)


def _template_window(dt: _DeviceTemplate, w: int, tids: torch.Tensor,
                     nb: torch.Tensor, pdt, last_pos: torch.Tensor,
                     hist: torch.Tensor):
    """The static-template part of an ultra window for every thread:
    resolve the head lines against the carried table, add the local
    histogram, write the tail positions back (``hist`` and ``last_pos`` in
    place).  Returns the share-capable heads' ``(reuse, share)``."""
    tpl = dt.tpl
    units = (w - tpl.w0) * tpl.unit_w + (tids - tpl.t0)            # [T]
    dpos = ((w - tpl.w0) * tpl.pos_shift + nb).to(pdt)
    carried = last_pos.gather(1, dt.hline + dt.hdl * units[:, None])
    cold = carried < 0
    reuse = (dt.hpos + dpos[:, None]) - carried
    share = ~cold & share_mask(reuse, dt.hspan)
    evt = ~cold & ~share
    bins = torch.where(evt, log2_bin(reuse), 0)
    hist += dt.lhist + bin_histogram(bins, cold | evt)
    last_pos.scatter_(1, dt.tline + dt.tdl * units[:, None],
                      dt.tpos + dpos[:, None])
    return reuse[:, dt.hs_idx], share[:, dt.hs_idx]


@dataclasses.dataclass
class SamplerResult:
    """Per-thread dense histograms + dict views matching the reference's
    state: ``noshare[t]`` is ``_NoSharePRI[t]`` (keys -1 and powers of two),
    ``share[t]`` is ``_SharePRI[t]`` (raw keys under the share-ratio group
    T-1), ``max_iteration_count`` the printed "max iteration traversed"."""

    noshare_dense: np.ndarray   # [T, NBINS] int64
    share_raw: list[dict]       # [T] {raw reuse: count}
    share_ratio: int
    max_iteration_count: int

    @property
    def thread_num(self) -> int:
        return self.noshare_dense.shape[0]

    def noshare_dict(self, tid: int) -> dict:
        # the cold key is always present (the reference flushes -1 per
        # thread even for an empty table)
        row = self.noshare_dense[tid]
        out = {-1: float(row[0])}
        for e in range(NBINS - 1):
            if row[1 + e]:
                out[1 << e] = float(row[1 + e])
        return out

    def share_dict(self, tid: int) -> dict:
        h = {int(v): float(c) for v, c in self.share_raw[tid].items()}
        return {self.share_ratio: h} if h else {}

    def noshare_list(self) -> list[dict]:
        return [self.noshare_dict(t) for t in range(self.thread_num)]

    def share_list(self) -> list[dict]:
        return [self.share_dict(t) for t in range(self.thread_num)]


def add_static_share(share_raw: list[dict],
                     nest_windows: list[tuple[NestPlan, int]]) -> None:
    """Add each template nest's static in-window share events to every
    thread's raw dict, once per ultra window (identical for every clean
    window of every thread)."""
    for np_, n_windows in nest_windows:
        if not n_windows or np_.tpl is None or not np_.tpl.share_vals.size:
            continue
        pairs = list(zip(np_.tpl.share_vals.tolist(),
                         (np_.tpl.share_cnts * n_windows).tolist()))
        for d in share_raw:
            for v, c in pairs:
                d[v] = d.get(v, 0) + c


def merge_share_windows(keys: list[torch.Tensor], cnts: list[torch.Tensor],
                        thread_num: int) -> list[dict]:
    """Host merge of the per-window share uniques into per-thread raw
    dicts: one device-side unique over every window's packed keys, one copy
    to the host."""
    out: list[dict] = [dict() for _ in range(thread_num)]
    if not keys:
        return out
    uniq, tot = share_unique(torch.cat(keys), torch.cat(cnts))
    uniq, tot = uniq.cpu().numpy(), tot.cpu().numpy()
    tid = uniq >> SHARE_SHIFT
    vals = uniq & ((1 << SHARE_SHIFT) - 1)
    for t, v, c in zip(tid.tolist(), vals.tolist(), tot.tolist()):
        out[t][v] = c
    return out


def resolve_device(device=None) -> torch.device:
    """The device a run uses: ``device`` when given, else the CUDA card.
    With no card and no explicit device this raises — a run never moves to
    the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(the CLI's --cpu) to run on the host")
    return torch.device("cuda")


def run(spec: LoopNestSpec, cfg: SamplerConfig = DEFAULT, *, device=None,
        window_accesses: int | None = None) -> SamplerResult:
    """Run the sampler on ``device`` (default: the CUDA card).

    ``window_accesses``: accesses per window per thread (default
    WINDOW_TARGET).
    """
    dev = resolve_device(device)
    return _execute(plan(spec, cfg, window_accesses), dev)


def _execute(pl: StreamPlan, device: torch.device,
             event_hist=event_histogram) -> SamplerResult:
    """Run a plan's windows on ``device`` and finalize on the host.

    ``event_hist`` is the sort windows' histogram function: the kernel
    wrapper, or its plain version when ``chip_smoke.py`` cross-checks the
    kernel end to end on the card.
    """
    cfg, spec = pl.cfg, pl.spec
    T = cfg.thread_num
    pdt = torch.int32 if pl.pos_dtype == np.int32 else torch.int64
    last_pos = torch.full((T, spec.total_lines(cfg)), -1, dtype=pdt,
                          device=device)
    hist = torch.zeros((T, NBINS), dtype=torch.int64, device=device)
    tids = torch.arange(T, dtype=torch.int64, device=device)
    nest_base = torch.as_tensor(pl.nest_base, device=device)   # int64
    keys: list[torch.Tensor] = []
    cnts: list[torch.Tensor] = []
    for ni, np_ in enumerate(pl.nests):
        owned = torch.as_tensor(np_.owned, device=device).to(torch.int64)
        nb = nest_base[ni]
        win_shift = np_.window_rounds * cfg.chunk_size * np_.body
        all_ranges = _array_ranges(np_.refs, spec, cfg)
        var_ranges = _array_ranges(np_.var_refs, spec, cfg)
        dtpl = None if np_.tpl is None else \
            _DeviceTemplate(np_.tpl, pdt, device)
        for is_ultra, w_list in _segments_of(np_):
            for w in w_list:
                cand = []
                if is_ultra:
                    # template-ineligible arrays sort inside the clean
                    # window too; disjoint line ranges make the two
                    # updates order-independent
                    if np_.var_refs:
                        ev = _sort_window(np_, np_.var_refs, var_ranges,
                                          spec, cfg, owned, w, nb, pdt,
                                          last_pos, win_shift, hist,
                                          event_hist)
                        cand.append((ev["reuse"], ev["share"]))
                    cand.append(_template_window(dtpl, w, tids, nb, pdt,
                                                 last_pos, hist))
                else:
                    ev = _sort_window(np_, np_.refs, all_ranges, spec, cfg,
                                      owned, w, nb, pdt, last_pos,
                                      win_shift, hist, event_hist)
                    cand.append((ev["reuse"], ev["share"]))
                k, c = share_unique(torch.cat([share_keys(r, s)
                                               for r, s in cand]))
                keys.append(k)
                cnts.append(c)
    share_raw = merge_share_windows(keys, cnts, T)
    # static in-window share events of ultra windows are host-side
    # constants: identical values and counts for every clean window
    add_static_share(share_raw,
                     [(n, int(n.ultra_windows().sum())) for n in pl.nests])
    return SamplerResult(noshare_dense=hist.cpu().numpy(),
                         share_raw=share_raw, share_ratio=T - 1,
                         max_iteration_count=pl.total_count)
