"""The sampler engine: affine stream enumeration + sort-based reuse, in torch.

Counterpart of ``pluss/engine.py``.  Every occurrence of every static
reference is materialized by broadcast arithmetic straight from the
:class:`~pluss_torch.spec.FlatRef` closed forms:

- stream position  ``pos  = nest_base + rank*stride0 + sum(idx_l*stride_l) + offset``
  for rectangular nests; bounded (triangular) nests take the iteration's
  start clock from a per-thread clock table and add the ``*_k`` slopes
  and the quad contract's ``tri()`` terms;
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
  this path inside ultra windows too.  Bounded nests sort every window,
  in size buckets whose bounded levels are padded only to the bucket's
  own maximum; their row-private and sweep-group arrays
  (:mod:`pluss_torch.rowpriv`, :mod:`pluss_torch.sweepgroup`) leave the
  sort for a plan-time histogram table, one row added per window.

The chunk->thread map is data (the owned-chunk matrix): static
round-robin, an explicit (dynamic FIFO) assignment, or the
``setStartPoint`` resume.  The host plan is numpy; :func:`run` places the
device part on CUDA unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pluss_torch import rowpriv, sweepgroup
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
    nest_has_bounds,
    nest_has_varying_start,
    nest_is_quad,
    nest_iteration_size,
    slot_sizes,
)

#: default accesses per window (per simulated thread)
WINDOW_TARGET = 1 << 23

#: largest window the plan-time template analysis will host-lexsort; bigger
#: windows take the device sort path
MAX_TEMPLATE_WINDOW = 1 << 29

#: sort-window memory budget when the run is on the CPU (the JAX package's
#: default); on a CUDA card the budget is the card's free memory
CPU_SORT_BUDGET = 8 << 30


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
    #: bounded nests only: [T, NW*W*CS] exclusive running access count at
    #: each stream slot (the thread's clock when the slot's parallel
    #: iteration starts); None for rectangular nests (clock = rank*body)
    clock: np.ndarray | None = None
    #: bounded nests only: contiguous window buckets, each ``(window ids,
    #: per-bucket FlatRefs)`` with the bounded levels' static trips cut to
    #: the bucket's own parallel-index range; None = one segment
    tri_buckets: tuple | None = None
    #: bounded nests only: [T, NW, NBINS] event histograms of the nest's
    #: closed-form arrays (row-private groups + sweep groups), which are
    #: left out of ``refs``; each window adds its row
    rpg_hist: np.ndarray | None = None
    #: per-thread {raw share reuse: count} of the sweep groups, added at
    #: finalize
    static_share: tuple | None = None

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


def _owned_matrix(sched: ChunkSchedule, T: int,
                  assignment: tuple[int, ...] | None = None,
                  start_point: int | None = None) -> np.ndarray:
    """[T, R] global chunk ids each thread serves, -1 padded.

    Encodes static round-robin (chunk ``cid`` -> thread ``cid % T``), an
    explicit (dynamic-FIFO) ``assignment``, and the ``setStartPoint``
    resume: every thread skips ``static_chunk_id(start_point)`` full
    rounds (pluss_utils.h:443-472).  Rows ascend, so the only partial
    chunk (the globally last) ends its owner's stream and the closed-form
    clock ``rank*body`` stays gapless.
    """
    if assignment is None:
        assignment = tuple(c % T for c in range(sched.n_chunks))
    elif len(assignment) != sched.n_chunks:
        raise ValueError(f"assignment covers {len(assignment)} chunks, "
                         f"schedule has {sched.n_chunks}")
    skip = 0 if start_point is None \
        else sched.static_chunk_id(start_point) * T
    per_thread: list[list[int]] = [[] for _ in range(T)]
    for cid, tid in enumerate(assignment):
        if cid < skip:
            continue
        if not 0 <= tid < T:
            raise ValueError(f"assignment[{cid}]={tid} out of range")
        per_thread[tid].append(cid)
    R = max((len(l) for l in per_thread), default=0)
    out = np.full((T, max(R, 1)), -1, np.int32)
    for t, lst in enumerate(per_thread):
        out[t, :len(lst)] = lst
    return out


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


def _tri_buckets(refs, owned: np.ndarray, sched, cfg: SamplerConfig,
                 W: int, NW: int, nseg: int = 4):
    """Contiguous window buckets with per-bucket static trips for bounded
    levels, or None when bucketing buys nothing.

    A bounded level's effective trip is ``a + b*g``; the enumeration pads
    every window to the level's static maximum and masks, so early windows
    of a growing triangle would sort mostly padding.  Each bucket's shapes
    are sized to its own parallel-index range instead (~5/8 of the volume
    at 4 buckets).
    """
    nseg = max(1, min(nseg, NW))
    if nseg == 1:
        return None
    CS = cfg.chunk_size
    blocks = owned.reshape(owned.shape[0], NW, W).astype(np.int64)
    valid = blocks >= 0
    if not valid.any():
        return None
    gmax_w = np.where(valid, blocks * CS + CS - 1, -1).max(axis=(0, 2))
    gmax_w = np.minimum(gmax_w, sched.trip - 1)
    gmin_w = np.where(valid, blocks * CS,
                      np.iinfo(np.int64).max).min(axis=(0, 2))
    edges = np.linspace(0, NW, nseg + 1).astype(int)
    out = []
    for i in range(nseg):
        ws = tuple(range(edges[i], edges[i + 1]))
        if not ws:
            continue
        g_lo = int(gmin_w[list(ws)].min())
        g_hi = int(gmax_w[list(ws)].max())
        brefs = []
        for fr in refs:
            trips = list(fr.trips)
            for l, bd in enumerate(fr.bounds or ()):
                if bd is None:
                    continue
                a, b = bd
                eff = max(a + b * g_lo, a + b * g_hi, 0)
                trips[l] = int(max(1, min(fr.trips[l], eff)))
            # quad contract: an inner-bounded level clamps transitively
            # (cholesky's k < j, with j already clamped to the bucket)
            for lv, a, b, rl in fr.inner_bounds or ():
                eff = max(a, a + b * (trips[rl] - 1), 0)
                trips[lv] = int(max(1, min(trips[lv], eff)))
            brefs.append(dataclasses.replace(fr, trips=tuple(trips)))
        out.append((ws, tuple(brefs)))
    # a degenerate split (every bucket at the global maximum) buys nothing
    if all(br.trips == fr.trips
           for _, brs in out for br, fr in zip(brs, refs)):
        return None
    return tuple(out)


def _nest_geometry(spec: LoopNestSpec, cfg: SamplerConfig, assignment,
                   start_point, target: int):
    """Per nest ``(sched, refs, body, asg, owned, W, NW)``: schedule,
    owned-chunk matrix and the window split at ``target`` accesses per
    window.  Windows never split a chunk round.  ``start_point`` applies
    to the first nest."""
    T = cfg.thread_num
    out = []
    for ni, nest in enumerate(spec.nests):
        sched = ChunkSchedule(cfg.chunk_size, nest.trip, nest.start,
                              nest.step, T)
        refs = tuple(flatten_nest(nest))
        body = nest_iteration_size(nest)
        asg = assignment[ni] if assignment is not None else None
        owned = _owned_matrix(sched, T, asg,
                              start_point if ni == 0 else None)
        R = owned.shape[1]
        W = max(1, min(R, -(-target // (cfg.chunk_size * body))))
        out.append((sched, refs, body, asg, owned, W, -(-R // W)))
    return out


def sort_window_bytes(np_: NestPlan, cfg: SamplerConfig, pos_dtype,
                      n_lines: int, refs=None) -> int:
    """Estimated device bytes to sort ONE window of ``refs`` (default: the
    nest's full sort-path ref set) for one thread: the sorted operands
    (key, pos, span, valid) plus ghost entries, x4 for sort workspace.
    Bounded levels count at their static maximum, the size the
    enumeration's shapes really take."""
    refs = np_.refs if refs is None else refs
    entries = np_.window_rounds * cfg.chunk_size * sum(
        int(np.prod(fr.trips[1:], dtype=np.int64)) for fr in refs) + n_lines
    return entries * (9 + np.dtype(pos_dtype).itemsize) * 4


def sort_budget(device: torch.device) -> int:
    """Device bytes the sort windows may take: the card's free memory on
    CUDA, :data:`CPU_SORT_BUDGET` on the CPU."""
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0])
    return CPU_SORT_BUDGET


def check_sort_budget(nests, spec: LoopNestSpec, cfg: SamplerConfig,
                      pos_dtype, limit: int) -> None:
    """Fail loudly, before any window runs, when the sort windows of the
    ``T`` threads (processed together, one batch row each) cannot fit in
    ``limit`` bytes — instead of a CUDA out-of-memory error in the middle
    of a run.  Windows never split a chunk round, so a huge body on a
    templateless (ragged, custom-assigned or bounded) nest needs a finer
    chunk size."""
    conc = cfg.thread_num
    n_lines = spec.total_lines(cfg)
    for ni, np_ in enumerate(nests):
        ultra = np_.ultra_windows()
        streams = []
        if not ultra.all():
            streams.append(("sort", np_.refs, "a finer chunk size or a "
                            "smaller window_accesses"))
        if np_.var_refs and ultra.any():
            streams.append(("ultra window's sort-path part", np_.var_refs,
                            "a finer chunk size"))
        for label, refs_, remedy in streams:
            est = sort_window_bytes(np_, cfg, pos_dtype, n_lines,
                                    refs_) * conc
            if est > limit:
                raise RuntimeError(
                    f"nest {ni}: the {label} window stream needs "
                    f"~{est / 2**30:.2f} GiB across {conc} concurrent "
                    f"windows (incl. sort workspace), beyond the "
                    f"{limit / 2**30:.2f} GiB device budget.  Use {remedy}.")


def plan(spec: LoopNestSpec, cfg: SamplerConfig = DEFAULT,
         assignment: tuple[tuple[int, ...] | None, ...] | None = None,
         start_point: int | None = None,
         window_accesses: int | None = None) -> StreamPlan:
    """Build the static stream plan (host, numpy).

    ``assignment``: optional per-nest chunk->thread maps (dynamic
    scheduling); ``start_point``: resume iteration value applied to the
    first nest; ``window_accesses``: accesses per window per thread
    (default WINDOW_TARGET).
    """
    T = cfg.thread_num
    geom = []
    for sched, refs, body, asg, owned, W, NW in _nest_geometry(
            spec, cfg, assignment, start_point,
            window_accesses or WINDOW_TARGET):
        pad = np.full((T, NW * W - owned.shape[1]), -1, np.int32)
        geom.append((sched, refs, body, asg,
                     np.concatenate([owned, pad], axis=1), W, NW))

    # the padded per-thread clock bound picks the position dtype; the full
    # int32 range is usable because no event math doubles a position
    max_clock = sum(NW * W * cfg.chunk_size * body
                    for _, _, body, _, _, W, NW in geom)
    pos_dtype = np.dtype(np.int32) if max_clock < 2**31 - 2 \
        else np.dtype(np.int64)

    nests: list[NestPlan] = []
    iters = np.zeros((len(spec.nests), T), np.int64)
    acc = np.zeros((len(spec.nests), T), np.int64)
    for ni, (sched, refs, body, asg, owned, W, NW) in enumerate(geom):
        nest = spec.nests[ni]
        tri = nest_has_bounds(nest)
        tpl = clean = clock = None
        var_refs = refs
        if tri:
            # the body size varies with the parallel index, so positions
            # need a per-thread clock table: the exclusive running access
            # count at every (round, chunk-slot) (invalid slots add 0)
            slot, valid = slot_sizes(nest, owned, sched.trip,
                                     cfg.chunk_size)
            body_slot = slot.reshape(T, -1)
            clock = np.concatenate(
                [np.zeros((T, 1), np.int64), np.cumsum(body_slot, axis=1)],
                axis=1)[:, :-1]
            acc[ni] = body_slot.sum(axis=1)
            iters[ni] = valid.sum(axis=(1, 2))
        else:
            g0 = owned.astype(np.int64) * cfg.chunk_size
            iters[ni] = np.where(owned >= 0,
                                 np.clip(sched.trip - g0, 0, cfg.chunk_size),
                                 0).sum(axis=1)
            acc[ni] = iters[ni] * body
        # the template rests on shift invariance, which a custom assignment
        # (no linear cid progression), a bounded loop or a varying start
        # breaks; oversize windows would make the host template analysis
        # itself the bottleneck: all of those take the device sort path
        if asg is None and not tri and not nest_has_varying_start(nest) \
                and W * cfg.chunk_size * body <= MAX_TEMPLATE_WINDOW:
            clean = _clean_windows(owned, W, NW, cfg.chunk_size, sched.trip)
            tpl_refs, split_var = _split_ref_groups(refs, sched, cfg)
            if tpl_refs:
                tpl = _build_template(tpl_refs, W, cfg, sched, owned, clean,
                                      spec.line_bases(cfg), spec.array_index,
                                      body)
                if tpl is not None:
                    var_refs = split_var
        refs_sort, rpg_hist, static_share = refs, None, None
        if tri and not nest_is_quad(nest):
            # closed-form arrays leave the sort for host histogram tables
            # (+ static share); each group is verified against a brute
            # replay and stays on the sort path on any mismatch
            refs_sort, rpg_hist = rowpriv.build_rowpriv(
                spec, ni, refs, cfg, sched, owned, W, NW)
            refs_sort, swg_hist, static_share = sweepgroup.build_sweepgroup(
                spec, ni, refs_sort, cfg, sched, owned, W, NW, clock)
            if swg_hist is not None:
                rpg_hist = swg_hist if rpg_hist is None \
                    else rpg_hist + swg_hist
        nests.append(NestPlan(
            sched, refs_sort, body, owned, W, NW, tpl, clean, var_refs,
            clock=clock, rpg_hist=rpg_hist, static_share=static_share,
            tri_buckets=_tri_buckets(refs_sort, owned, sched, cfg, W, NW)
            if tri else None))
    nest_base = np.zeros_like(acc)
    nest_base[1:] = np.cumsum(acc[:-1], axis=0)
    return StreamPlan(spec=spec, cfg=cfg, nests=tuple(nests),
                      iters_per_thread=iters, nest_base=nest_base,
                      total_count=int(acc.sum()), pos_dtype=pos_dtype)


def _segments_of(np_: NestPlan) -> list[tuple[bool, list[int], tuple | None]]:
    """Window segments of one nest in processing order, ``(is_ultra,
    window_ids, bucket_refs)``: runs of consecutive windows on the same
    path.  A window takes the template path only when it is clean for
    EVERY thread (the threads run in lockstep as rows of one batch).
    Bounded nests split into their size buckets instead (all sort path,
    per-bucket static trips)."""
    if np_.tri_buckets is not None:
        return [(False, list(ws), brefs) for ws, brefs in np_.tri_buckets]
    ultra_w = np_.ultra_windows()
    segments: list[tuple[bool, list[int], tuple | None]] = []
    for w in range(np_.n_windows):
        if segments and segments[-1][0] == bool(ultra_w[w]):
            segments[-1][1].append(w)
        else:
            segments.append((bool(ultra_w[w]), [w], None))
    return segments


def _array_ranges(refs, spec, cfg) -> tuple[tuple[int, int], ...]:
    """Ascending (line_base, line_count) of the arrays the refs touch — the
    ghost coverage a sort window needs."""
    bases, counts = spec.line_bases(cfg), spec.line_counts(cfg)
    idxs = sorted({spec.array_index(fr.ref.array) for fr in refs})
    return tuple((bases[i], counts[i]) for i in idxs)


def _ref_window(fr: FlatRef, np_: NestPlan, cfg: SamplerConfig,
                owned: torch.Tensor, r0: int, nb: torch.Tensor,
                line_base: int, pdt: torch.dtype,
                clock: torch.Tensor | None = None):
    """``[T, n]`` (line, pos, span, valid) of one ref over rounds
    [r0, r0+W) for every thread; ``owned`` is the nest's [T, NW*W] chunk
    matrix on the device, ``nb`` the [T] nest clock offsets and ``clock``
    (bounded nests only) the nest's [T, NW*W*CS] clock table.  Positions
    and addresses are computed in int64; entries outside the bounds (and
    padded chunks) may hold any value there, and are masked invalid."""
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
    pos = nb.view((T,) + (1,) * (nd - 1))
    if clock is None:
        pos = pos + ((r0 + r) * CS + p) * fr.pos_strides[0] + fr.offset
    else:
        # bounded nest: the iteration's start clock from the table, plus
        # the in-iteration offset's slope in the parallel index g (and the
        # quad contract's tri(g) term)
        start = clock[:, r0 * CS:(r0 + W) * CS].reshape(
            (T, W, CS) + (1,) * (nd - 3))
        pos = pos + start + fr.offset + fr.offset_k * g
        if fr.offset_g2:
            pos = pos + fr.offset_g2 * torch.div(g * (g - 1), 2,
                                                 rounding_mode="floor")
    addr = fr.ref.addr_base + fr.addr_coefs[0] * (sched.start + g * sched.step)
    for l in range(1, len(fr.trips)):
        idx = iota(l + 2)
        stride = fr.pos_strides[l]
        if clock is not None and fr.pos_strides_k[l]:
            stride = stride + fr.pos_strides_k[l] * g
        pos = pos + idx * stride
        if fr.pos_quads and fr.pos_quads[l]:
            pos = pos + fr.pos_quads[l] * torch.div(idx * (idx - 1), 2,
                                                    rounding_mode="floor")
        if fr.bounds and fr.bounds[l] is not None:
            a, b = fr.bounds[l]
            valid = valid & (idx < a + b * g)
        if fr.addr_coefs[l]:
            start_l = fr.starts[l]
            if fr.starts_k and fr.starts_k[l]:
                start_l = start_l + fr.starts_k[l] * g   # varying start
            addr = addr + fr.addr_coefs[l] * (start_l + idx * fr.steps[l])
    for lv, a, b, rl in fr.inner_bounds:
        # quad contract: idx[lv] < a + b*idx[rl], rl an inner level
        valid = valid & (iota(lv + 2) < a + b * iota(rl + 2))
    line = line_base + torch.div(addr * cfg.ds, cfg.cls, rounding_mode="floor")
    # cast before broadcasting: the copy the reshape makes is then the
    # only full-size one, in the final dtype
    flat = lambda x, dt: x.to(dt).expand(shape).reshape(T, -1)
    return (flat(line, torch.int32), flat(pos, pdt),
            torch.full((T, int(np.prod(shape[1:]))), fr.ref.share_span or 0,
                       dtype=torch.int32, device=dev),
            flat(valid, torch.bool))


def _sort_window(np_: NestPlan, refs, ranges, spec, cfg, owned, w: int,
                 nb: torch.Tensor, pdt, last_pos: torch.Tensor,
                 win_shift: int, hist: torch.Tensor, event_hist,
                 clock: torch.Tensor | None = None):
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
                         bases[spec.array_index(fr.ref.array)], pdt, clock)
             for fr in refs]
    parts += [ghost_entries(last_pos[:, b:b + c], b) for b, c in ranges]
    key_s, pos_s, span_s, valid_s = sort_stream(
        *(torch.cat([p[i] for p in parts], dim=1) for i in range(4)))
    del parts
    if clock is None:
        win_start = (nb + w * win_shift).to(pdt)
    else:
        # bounded nest: the window's smallest position is the clock at its
        # first stream slot
        win_start = (nb + clock[:, r0 * cfg.chunk_size]).to(pdt)
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
        assignment=None, start_point: int | None = None,
        window_accesses: int | None = None) -> SamplerResult:
    """Run the sampler on ``device`` (default: the CUDA card).

    ``assignment``: optional per-nest chunk->thread maps; ``start_point``:
    resume iteration value of the first nest; ``window_accesses``:
    accesses per window per thread (default WINDOW_TARGET).  The sort
    windows must fit the device's budget (:func:`sort_budget`), else this
    raises before any window runs.
    """
    dev = resolve_device(device)
    if assignment is not None:
        assignment = tuple(tuple(a) if a is not None else None
                           for a in assignment)
    pl = plan(spec, cfg, assignment, start_point, window_accesses)
    check_sort_budget(pl.nests, spec, cfg, pl.pos_dtype, sort_budget(dev))
    return _execute(pl, dev)


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
    as_dev = lambda a: None if a is None else torch.as_tensor(a, device=device)
    keys: list[torch.Tensor] = []
    cnts: list[torch.Tensor] = []
    for ni, np_ in enumerate(pl.nests):
        owned = torch.as_tensor(np_.owned, device=device).to(torch.int64)
        nb = nest_base[ni]
        clock = as_dev(np_.clock)
        rpg = as_dev(np_.rpg_hist)
        win_shift = np_.window_rounds * cfg.chunk_size * np_.body
        all_ranges = _array_ranges(np_.refs, spec, cfg)
        var_ranges = _array_ranges(np_.var_refs, spec, cfg)
        dtpl = None if np_.tpl is None else \
            _DeviceTemplate(np_.tpl, pdt, device)
        for is_ultra, w_list, brefs in _segments_of(np_):
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
                elif np_.refs:
                    # a window whose arrays are all closed-form sorts
                    # nothing and launches nothing
                    ev = _sort_window(np_, brefs or np_.refs, all_ranges,
                                      spec, cfg, owned, w, nb, pdt, last_pos,
                                      win_shift, hist, event_hist, clock)
                    cand.append((ev["reuse"], ev["share"]))
                if rpg is not None:
                    hist += rpg[:, w]
                if cand:
                    k, c = share_unique(torch.cat([share_keys(r, s)
                                                   for r, s in cand]))
                    keys.append(k)
                    cnts.append(c)
    share_raw = merge_share_windows(keys, cnts, T)
    # static in-window share events of ultra windows are host-side
    # constants: identical values and counts for every clean window
    add_static_share(share_raw,
                     [(n, int(n.ultra_windows().sum())) for n in pl.nests])
    # the sweep groups' share events are whole-run host constants too
    for n_ in pl.nests:
        for d, adds in zip(share_raw, n_.static_share or ()):
            for v, c in adds.items():
                d[v] = d.get(v, 0) + c
    return SamplerResult(noshare_dense=hist.cpu().numpy(),
                         share_raw=share_raw, share_ratio=T - 1,
                         max_iteration_count=pl.total_count)
