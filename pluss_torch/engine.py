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
  precomputed local histogram — O(lines), not O(accesses).  Arrays with
  mixed parallel coefficients (syrk's ``A``) that pass the interleave
  overlay's checks (:mod:`pluss_torch.overlay`) take an O(lines) closed
  form inside these windows too.
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
``setStartPoint`` resume.  The host plan is numpy (its window template one
native walk, ``csrc/window_template.cpp``), memoized per process
(:func:`_plan_cached`) and, for templates and overlays, on disk
(``PLUSS_PLAN_CACHE_DIR``).  :func:`run` places the device part on CUDA
unless the caller asks for the CPU; a run whose concurrent sort windows
would not fit the device goes through :func:`run_sliced` in smaller
thread batches (:func:`_auto_dispatch`).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import pickle
import sys
import uuid

import numpy as np
import torch

from pluss_torch import native, obs, plancache, rowpriv, sweepgroup
from pluss_torch.config import DEFAULT, NBINS, SHARE_CAP, SamplerConfig
from pluss_torch.obs import xprof
from pluss_torch.ops import build
from pluss_torch.ops.event_hist import event_histogram
from pluss_torch.overlay import (DeviceOverlay, build_overlay, device_window,
                                 verify_overlay)
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
    sort_columns,
)
from pluss_torch.ops.window_sort import key_layout, window_sort
from pluss_torch.resilience import faults
from pluss_torch.resilience.errors import quarantine_artifact
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

#: largest window the plan-time template analysis will walk on the host;
#: bigger windows take the device sort path
MAX_TEMPLATE_WINDOW = 1 << 29

#: sort-window memory budget when the run is on the CPU (the JAX package's
#: default); on a CUDA card the budget is the card's free memory
CPU_SORT_BUDGET = 8 << 30

_HERE = os.path.dirname(os.path.abspath(__file__))


@functools.lru_cache(maxsize=1)
def _plan_cache_salt() -> str:
    """Content hash of the plan-analysis sources: any edit to the template
    or overlay logic invalidates every cached artifact."""
    h = hashlib.sha256()
    for name in ("engine.py", "overlay.py", "spec.py", "sched.py",
                 "config.py", os.path.join("ops", "reuse.py"),
                 os.path.join("csrc", "window_template.cpp")):
        with open(os.path.join(_HERE, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _plan_cache_root() -> str | None:
    """The plan-cache directory, or None when caching is off — the one
    resolution that put, get and evict share.  ``$PLUSS_PLAN_CACHE_DIR``,
    else ``.bench/plan_cache`` when ``.bench`` exists in the working
    directory, else off; ``PLUSS_NO_PLAN_CACHE`` turns it off (the test
    suite sets it, so no template bug hides behind a stale artifact)."""
    if os.environ.get("PLUSS_NO_PLAN_CACHE"):
        return None
    root = os.environ.get("PLUSS_PLAN_CACHE_DIR")
    if root is None:
        if not os.path.isdir(".bench"):
            return None
        root = os.path.join(".bench", "plan_cache")
    return root


def _plan_cache_path(key: str) -> str | None:
    """Disk slot of one nest's plan artifacts (its template and verified
    overlays: expensive to build, cheap to load), or None when off."""
    root = _plan_cache_root()
    if root is None:
        return None
    os.makedirs(root, exist_ok=True)
    return os.path.join(root, key + ".pkl")


def _plan_cache_key(spec, cfg, ni: int, W: int, NW: int) -> str:
    return hashlib.sha256(
        repr((_plan_cache_salt(), spec, cfg, ni, W, NW)).encode()
    ).hexdigest()[:32]


def plan_cache_max() -> int:
    """Disk plan-cache entry cap (``PLUSS_PLAN_CACHE_MAX``, default 256; 0
    disables eviction; a malformed value warns once and means 256)."""
    from pluss_torch.utils.envknob import env_int

    return env_int("PLUSS_PLAN_CACHE_MAX", 256, minimum=0)


def _plan_cache_evict() -> None:
    """Unlink the least recently used entries past :func:`plan_cache_max`
    (a hit refreshes an entry's mtime).  Quarantined ``.corrupt`` files
    and writers' temporaries are not entries; a file that vanishes
    mid-listing is another writer's eviction."""
    cap = plan_cache_max()
    root = _plan_cache_root()
    if cap <= 0 or root is None:
        return
    entries = []
    try:
        with os.scandir(root) as it:
            for de in it:
                if not de.name.endswith(".pkl"):
                    continue
                try:
                    entries.append((de.stat().st_mtime, de.path))
                except OSError:
                    continue
    except OSError:
        return
    for _, path in sorted(entries)[:max(0, len(entries) - cap)]:
        try:
            os.unlink(path)
        except OSError:
            continue
        obs.counter_add("engine.plan_cache.evict")


def _plan_cache_get(key: str):
    """The cached artifacts of ``key``, or None on a miss.  A file that
    does not unpickle is renamed aside (``.corrupt``) and reported once,
    so the rebuilt artifact can take its slot."""
    path = _plan_cache_path(key)
    if path is None:
        return None
    if not os.path.exists(path):
        obs.counter_add("engine.plan_cache.miss")
        obs.trace_event("plan_cache.consult", outcome="miss")
        return None
    faults.corrupt("plan_cache.get", path)   # chaos: corrupt_cache site
    try:
        with open(path, "rb") as f:
            value = pickle.load(f)
    except Exception as e:   # any unpickling failure means corrupt bytes
        obs.counter_add("engine.plan_cache.corrupt")
        quarantine_artifact(path, "engine plan-cache", e)
        return None
    obs.counter_add("engine.plan_cache.hit")
    obs.trace_event("plan_cache.consult", outcome="hit")
    try:
        os.utime(path)   # recency for _plan_cache_evict
    except OSError:
        pass
    return value


def _plan_cache_put(key: str, value) -> None:
    """Write ``value`` to ``key``'s slot atomically (a uuid temporary per
    writer, then a rename), then evict past the cap."""
    path = _plan_cache_path(key)
    if path is None:
        return
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    try:
        with open(tmp, "wb") as f:
            pickle.dump(value, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _plan_cache_evict()


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
    #: interleave overlays (:mod:`pluss_torch.overlay`): template-ineligible
    #: arrays whose ultra windows take an O(lines) closed form instead of
    #: the sort, each verified against brute-force windows at plan time
    overlays: tuple = ()
    #: ``var_refs`` minus the overlaid arrays: what an ultra window still
    #: sorts (non-ultra windows sort ``refs``)
    var_refs_novl: tuple[FlatRef, ...] = ()
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
        thread, with a template, overlays, or both)."""
        if self.clean is None or (self.tpl is None and not self.overlays):
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
                    body: int, sp=obs.NOOP_SPAN) -> WindowTemplate | None:
    """Analyze the first clean window on the host; None if none is clean.

    One native pass over the window's positions
    (``csrc/window_template.cpp``): every access has a position of its
    own, so the walk in position order with a per-line last-position table
    gives each line's accesses in order with no sort.  ``sp`` takes the
    accesses walked (``entries``), the threads that walked them
    (``threads``) and the head count (``heads``)."""
    t_w = np.argwhere(clean)
    if len(t_w) == 0:
        return None
    t0, w0 = int(t_w[0, 0]), int(t_w[0, 1])
    # line shift per unit chunk offset; integral by _split_ref_groups
    dlines = [fr.addr_coefs[0] * sched.step * cfg.chunk_size * cfg.ds
              // cfg.cls for fr in refs]
    arrays, entries, threads = native.template_builder()(
        refs, [bases[array_index(fr.ref.array)] for fr in refs], dlines,
        owned[t0], w0 * W, W, sched, cfg, NBINS)
    sp.set(entries=entries, threads=threads, heads=len(arrays["head_line"]))
    return WindowTemplate(t0=t0, w0=w0, unit_w=W * cfg.thread_num,
                          pos_shift=W * cfg.chunk_size * body, **arrays)


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


def natural_n_windows(spec: LoopNestSpec, cfg: SamplerConfig = DEFAULT,
                      assignment=None, start_point: int | None = None,
                      window_accesses: int | None = None) -> int:
    """The window count :func:`plan` picks on its own (the most of any
    nest).  The sharded backend sizes its grid from it: its windows stay
    near ``window_accesses`` (default WINDOW_TARGET) accesses whatever the
    device count, so a device's sort memory has the single-device bound."""
    geom = _nest_geometry(spec, cfg, _freeze(assignment), start_point,
                          window_accesses or WINDOW_TARGET)
    return max(nw for *_, nw in geom)


def sort_budget(device: torch.device) -> int:
    """Device bytes the sort windows may take: on CUDA the card's free
    memory plus what PyTorch's caching allocator holds unused (earlier
    runs' freed blocks, which it hands out again), :data:`CPU_SORT_BUDGET`
    on the CPU."""
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0]
                   + torch.cuda.memory_reserved(device)
                   - torch.cuda.memory_allocated(device))
    return CPU_SORT_BUDGET


def check_sort_budget(nests, spec: LoopNestSpec, cfg: SamplerConfig,
                      pos_dtype, limit: int,
                      concurrency: int | None = None) -> None:
    """Fail loudly, before any window runs, when the sort windows of
    ``concurrency`` threads (default all ``T``, processed together, one
    batch row each) cannot fit in ``limit`` bytes — instead of a CUDA
    out-of-memory error in the middle of a run.  Windows never split a
    chunk round, so a huge body on a templateless (ragged, custom-assigned
    or bounded) nest needs a finer chunk size."""
    conc = concurrency or cfg.thread_num
    n_lines = spec.total_lines(cfg)
    for ni, np_ in enumerate(nests):
        ultra = np_.ultra_windows()
        streams = []
        if not ultra.all():
            streams.append(("sort", np_.refs, "a finer chunk size or a "
                            "smaller window_accesses"))
        if np_.var_refs_novl and ultra.any():
            # overlaid arrays sort nothing in ultra windows
            streams.append(("ultra window's sort-path part",
                            np_.var_refs_novl, "a finer chunk size"))
        for label, refs_, remedy in streams:
            est = sort_window_bytes(np_, cfg, pos_dtype, n_lines,
                                    refs_) * conc
            if est > limit:
                raise RuntimeError(
                    f"nest {ni}: the {label} window stream needs "
                    f"~{est / 2**30:.2f} GiB across {conc} concurrent "
                    f"windows (incl. sort workspace), beyond the "
                    f"{limit / 2**30:.2f} GiB device budget.  Use {remedy}.")


def _build_overlays(spec, var_refs, cfg, sched, clean, W: int, NW: int,
                    body: int) -> tuple:
    """Verified overlays of a nest's template-ineligible arrays, built on
    its leading run of ultra windows (none when window 0 is not ultra:
    the closed forms assume ``cid = (w*W + r)*T + t``)."""
    T = cfg.thread_num
    n_pref = int(np.argmin(np.concatenate([clean.all(axis=0), [False]])))
    if n_pref == 0:
        return ()
    by_arr: dict[str, list] = {}
    for fr in var_refs:
        by_arr.setdefault(fr.ref.array, []).append(fr)
    out = []
    for arr, frs in by_arr.items():
        ov = build_overlay(arr, frs, cfg, sched, spec, W, 0, body)
        if ov is None:
            continue
        # verification pairs stay inside the leading ultra prefix (the
        # brute replay walks windows 0..w) and the real thread range; the
        # prefix's last window too when its brute chain is short
        w_hi = min(n_pref - 1, 2)
        pairs = {(0, 0), (T - 1, min(1, w_hi)), (min(1, T - 1), w_hi)}
        if w_hi < n_pref - 1 <= 8:
            pairs.add((T // 2, n_pref - 1))
        if verify_overlay(ov, cfg, sched, NW, pairs):
            out.append(ov)
    return tuple(out)


def plan(spec: LoopNestSpec, cfg: SamplerConfig = DEFAULT,
         assignment: tuple[tuple[int, ...] | None, ...] | None = None,
         start_point: int | None = None,
         window_accesses: int | None = None,
         build_templates: bool = True,
         build_overlays: bool = True,
         build_rowpriv: bool = True,
         n_windows: int | None = None) -> StreamPlan:
    """Build the static stream plan (host, numpy).

    ``assignment``: optional per-nest chunk->thread maps (dynamic
    scheduling); ``start_point``: resume iteration value applied to the
    first nest; ``window_accesses``: accesses per window per thread
    (default WINDOW_TARGET); ``n_windows``: exactly this many equal round
    windows per nest instead (the sharded backend's grid of S windows per
    device, :func:`shard_plan_cached`).  ``build_templates=False`` skips
    the static window templates (and with them the overlays, which need
    the clean windows): for callers that only ever sort, as the subset
    sampler's fresh-carry walks.  ``build_overlays=False`` skips the interleave
    overlays and their brute-force verification; ``build_rowpriv=False``
    keeps the row-private and sweep-group arrays on the sort path.

    Templates and verified overlays of a default-scheduled nest are kept
    in the disk plan cache (:func:`_plan_cache_root`).
    """
    T = cfg.thread_num
    geom = []
    for sched, refs, body, asg, owned, W, NW in _nest_geometry(
            spec, cfg, assignment, start_point,
            window_accesses or WINDOW_TARGET):
        if n_windows is not None:
            NW = n_windows
            W = -(-owned.shape[1] // NW)
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
        cache_key = cached = None
        if build_templates and asg is None and not tri \
                and not nest_has_varying_start(nest) \
                and W * cfg.chunk_size * body <= MAX_TEMPLATE_WINDOW:
            with obs.span("engine.plan.template") as sp:
                clean = _clean_windows(owned, W, NW, cfg.chunk_size,
                                       sched.trip)
                if start_point is None:
                    cache_key = _plan_cache_key(spec, cfg, ni, W, NW)
                    cached = _plan_cache_get(cache_key)
                tpl_refs, split_var = _split_ref_groups(refs, sched, cfg)
                if tpl_refs:
                    tpl = cached["tpl"] if cached is not None else \
                        _build_template(tpl_refs, W, cfg, sched, owned,
                                        clean, spec.line_bases(cfg),
                                        spec.array_index, body, sp)
                    if tpl is not None:
                        var_refs = split_var
        overlays: tuple = ()
        if build_overlays and clean is not None and var_refs \
                and (start_point is None or ni != 0):
            if cached is not None and cached["overlays"] is not None:
                overlays = cached["overlays"]
            else:
                overlays = _build_overlays(spec, var_refs, cfg, sched, clean,
                                           W, NW, body)
                if cache_key:
                    _plan_cache_put(cache_key,
                                    {"tpl": tpl, "overlays": overlays})
        elif cache_key and cached is None and tpl is not None:
            # the template alone, when the overlays are not built
            _plan_cache_put(cache_key, {"tpl": tpl, "overlays": None})
        done = {ov.array for ov in overlays}
        var_novl = tuple(fr for fr in var_refs if fr.ref.array not in done)
        refs_sort, rpg_hist, static_share = refs, None, None
        if tri and build_rowpriv and not nest_is_quad(nest):
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
            overlays=overlays, var_refs_novl=var_novl,
            clock=clock, rpg_hist=rpg_hist, static_share=static_share,
            tri_buckets=_tri_buckets(refs_sort, owned, sched, cfg, W, NW)
            if tri else None))
    nest_base = np.zeros_like(acc)
    nest_base[1:] = np.cumsum(acc[:-1], axis=0)
    return StreamPlan(spec=spec, cfg=cfg, nests=tuple(nests),
                      iters_per_thread=iters, nest_base=nest_base,
                      total_count=int(acc.sum()), pos_dtype=pos_dtype)


def plan_path(pl: StreamPlan) -> str:
    """Short label of the paths a plan's windows take: any of ``template``
    (static-window analysis), ``overlay`` (interleave overlays),
    ``closed_form`` (row-private and sweep-group tables) and ``sort``
    (device sort windows), joined with ``+`` when one run mixes them."""
    parts: list[str] = []

    def add(p: str) -> None:
        if p not in parts:
            parts.append(p)

    for np_ in pl.nests:
        if np_.rpg_hist is not None:
            add("closed_form")
        if np_.tpl is not None:
            add("template")
        if np_.overlays:
            add("overlay")
        if np_.refs and (not bool(np_.ultra_windows().all())
                         or np_.var_refs_novl):
            add("sort")
    return "+".join(parts) or "sort"


def describe_path(spec: LoopNestSpec, cfg: SamplerConfig = DEFAULT,
                  window_accesses: int | None = None,
                  degradations: tuple = (), *, device=None) -> str:
    """The :func:`plan_path` label of a default :func:`run` of ``spec`` on
    ``device``, prefixed ``sliced:`` when the auto-dispatch ladder would
    reroute it to :func:`run_sliced`, and suffixed ``[degraded: ...]``
    when the caller passes a result's resilience stamp
    (``res.degradations``).  Plans through the shared memo, so it costs
    nothing after a run."""
    pl = _plan_cached(spec, cfg, None, None, window_accesses)
    label = plan_path(pl)
    if _dispatch(pl, cfg, None, sort_budget(resolve_device(device)))[1]:
        label = "sliced:" + label
    if degradations:
        from pluss_torch.resilience.ladder import degradation_label

        label = degradation_label(label, tuple(degradations))
    return label


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
                line_base: int, pdt: torch.dtype, code: int,
                clock: torch.Tensor | None = None):
    """``[T, n]`` (line, pos, code, valid) of one ref over rounds
    [r0, r0+W) for every thread; ``owned`` is the nest's [T, NW*W] chunk
    matrix on the device, ``nb`` the [T] nest clock offsets and ``clock``
    (bounded nests only) the nest's [T, NW*W*CS] clock table.  ``code``
    (uint8) stands for the ref's share span in the sort, one byte where
    the span would take four.  Positions and addresses are computed in
    int64; entries outside the bounds (and padded chunks) may hold any
    value there, and are masked invalid."""
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
    # in place: the address tensor is this function's own, and a full-size
    # int64 temporary less lowers the sort window's enumeration peak
    line = addr.mul_(cfg.ds).div_(cfg.cls, rounding_mode="floor") \
        .add_(line_base)
    del addr
    # cast before broadcasting: the copy the reshape makes is then the
    # only full-size one, in the final dtype
    flat = lambda x, dt: x.to(dt).expand(shape).reshape(T, -1)
    return (flat(line, torch.int32), flat(pos, pdt),
            torch.full((T, int(np.prod(shape[1:]))), code,
                       dtype=torch.uint8, device=dev),
            flat(valid, torch.bool))


def _sort_window(dn: DeviceNest, refs, ranges, w: int, rows,
                 last_pos: torch.Tensor, event_hist,
                 with_sorted: bool = False):
    """One sort-path window of nest ``dn`` over ``refs`` for thread
    ``rows``, ghost-merged with the carry.

    The carried ``last_pos`` slices of the covered arrays (``ranges``)
    enter the sort as ghost entries, so every access's predecessor is its
    sorted left neighbour; the segment tails are written back into
    ``last_pos`` in place.  Returns ``(hist, ev)``: the window's ``[rows,
    NBINS]`` event histogram from ``event_hist`` and its event dict (for
    the share extraction).  ``event_hist=None`` is a warm walk: only the
    tails update, nothing is binned or launched, and both are None.
    ``with_sorted`` adds a third item, the sorted ``(key_s, pos_s,
    span_s)`` (the sharded window captures its heads from them).

    The window sorts as one packed key (:func:`window_sort`) whose widths
    :func:`key_layout` reckons here from the plan, or, when no such key
    fits (past 63 bits, or past one sort's entries), as full-width columns
    (:func:`sort_columns`); the counters ``engine.sort_window.packed`` and
    ``.two_pass`` count which.
    """
    with obs.tally_span("engine.sort_window"):
        win_start = dn.win_start(w, rows)
        n = sum(dn.entries(fr) for fr in refs)
        n_lines = sum(c for _, c in ranges)
        lay = key_layout(ranges, dn.pos_span(w), len(dn.spans),
                         last_pos.shape[0], n + n_lines)
        if lay is not None:
            obs.counter_add("engine.sort_window.packed")
            key_s, pos_s, span_s, valid_s = window_sort(
                dn.parts(refs, w, rows), n, ranges, lay, win_start,
                last_pos, dn.span_table)
        else:
            obs.counter_add("engine.sort_window.two_pass")
            parts, span_of = dn.stream(refs, w, rows)
            for b, c in ranges:
                line, pos, _, valid = ghost_entries(last_pos[:, b:b + c], b)
                parts.append((line, pos,
                              torch.zeros_like(valid, dtype=torch.uint8),
                              valid))
            cols = [torch.cat([p[i] for p in parts], dim=1)
                    for i in range(4)]
            del parts   # the per-ref blocks are not held through the sort
            key_s, pos_s, code_s, valid_s = sort_columns(cols)  # empties it
            span_s = span_of(code_s)
            del code_s
        tails = extract_tails(key_s, pos_s, valid_s, n_lines)
        off = 0
        for b, c in ranges:
            last_pos[:, b:b + c] = tails[:, off:off + c]
            off += c
        if event_hist is None:
            return None, None
        out = (event_hist(key_s, pos_s, span_s, valid_s, win_start),
               carried_events(key_s, pos_s, span_s, valid_s, win_start))
        return out + ((key_s, pos_s, span_s),) if with_sorted else out


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


def _template_window(dn: DeviceNest, w: int, rows,
                     last_pos: torch.Tensor, hist: torch.Tensor):
    """The static-template part of ultra window ``w`` for thread ``rows``:
    resolve the head lines against the carried table, add the local
    histogram, write the tail positions back (``hist`` and ``last_pos`` in
    place).  Returns the share-capable heads' ``(reuse, share)``."""
    dt = dn.dtpl
    tpl = dt.tpl
    with obs.tally_span("engine.template_window"):
        units = (w - tpl.w0) * tpl.unit_w + (dn.tids[rows] - tpl.t0)  # [T]
        dpos = ((w - tpl.w0) * tpl.pos_shift + dn.nb[rows]).to(dn.pdt)
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


class DeviceNest:
    """One nest of a plan on one device, for every thread row: the tables
    that every window walker reads (:class:`_Walk`, the subset sampler,
    the sharded backend's chunk functions), and the window bodies bound to
    them.  ``rows`` is always a slice of the thread rows."""

    def __init__(self, pl: StreamPlan, ni: int, device: torch.device):
        np_, cfg, spec = pl.nests[ni], pl.cfg, pl.spec
        as_dev = lambda a: None if a is None else \
            torch.as_tensor(a, device=device)
        self.np_, self.cfg, self.spec, self.device = np_, cfg, spec, device
        self.pdt = torch.int32 if pl.pos_dtype == np.int32 else torch.int64
        self.n_lines = spec.total_lines(cfg)
        self.tids = torch.arange(cfg.thread_num, dtype=torch.int64,
                                 device=device)
        self.nb = torch.as_tensor(pl.nest_base[ni], device=device)
        self.owned = torch.as_tensor(np_.owned, device=device) \
            .to(torch.int64)
        self.clock = as_dev(np_.clock)
        self.rpg = as_dev(np_.rpg_hist)
        self.win_shift = np_.window_rounds * cfg.chunk_size * np_.body
        #: every share span of the nest's refs (0 first, the ghosts'): a
        #: sort window's span codes index them
        self.spans = sorted({0, *(fr.ref.share_span or 0
                                  for fr in (*np_.refs, *np_.var_refs))})
        self.all_ranges = _array_ranges(np_.refs, spec, cfg)
        self.var_ranges = _array_ranges(np_.var_refs_novl, spec, cfg)
        self.dtpl = None if np_.tpl is None else \
            _DeviceTemplate(np_.tpl, self.pdt, device)
        self.dovl = [DeviceOverlay(ov, device) for ov in np_.overlays]
        self.segments = _segments_of(np_)
        #: each window's ``(is_ultra, bucket refs)``, from its segment
        self.path = {w: (u, brefs) for u, ws, brefs in self.segments
                     for w in ws}

    def win_start(self, w: int, rows) -> torch.Tensor:
        """``[rows]`` smallest stream position of window ``w`` in each
        thread row, in the position dtype."""
        nb = self.nb[rows]
        if self.clock is None:
            return (nb + w * self.win_shift).to(self.pdt)
        # bounded nest: the clock at the window's first stream slot
        slot = w * self.np_.window_rounds * self.cfg.chunk_size
        return (nb + self.clock[rows][:, slot]).to(self.pdt)

    @functools.cached_property
    def span_table(self) -> torch.Tensor:
        """:attr:`spans` on the device, made by the first sort window (a
        nest walked only by templates and overlays never uploads it)."""
        return torch.tensor(self.spans, dtype=torch.int32,
                            device=self.device)

    @functools.cached_property
    def _pos_spans(self):
        """Bounded nests: each window's largest position span over the
        threads, from the clock table (a slot holds at most ``body``)."""
        np_ = self.np_
        c = np_.clock.reshape(self.cfg.thread_num, np_.n_windows, -1)
        return (c[:, :, -1] - c[:, :, 0]).max(axis=0) + np_.body

    def pos_span(self, w: int) -> int:
        """A bound on the positions of window ``w``, from the plan on the
        host: every real position of a row lies below its
        :meth:`win_start` plus this."""
        return self.win_shift if self.np_.clock is None \
            else int(self._pos_spans[w])

    def entries(self, fr: FlatRef) -> int:
        """Entries of one ref's window block a row (:func:`_ref_window`'s
        shape, padding included)."""
        return self.np_.window_rounds * self.cfg.chunk_size * int(
            np.prod(fr.trips[1:], dtype=np.int64))

    def parts(self, refs, w: int, rows):
        """Window ``w`` over ``refs`` for thread ``rows``: each ref's
        ``[rows, n]`` (line, pos, code, valid) block of :func:`_ref_window`
        in program order, each made when the caller asks for it.  A code
        is the ref's share span's index in :attr:`spans`: a sort carries
        one byte where the span takes four."""
        cfg, spec = self.cfg, self.spec
        bases = spec.line_bases(cfg)
        r0 = w * self.np_.window_rounds
        owned, nb = self.owned[rows], self.nb[rows]
        clock = None if self.clock is None else self.clock[rows]
        for fr in refs:
            yield _ref_window(fr, self.np_, cfg, owned, r0, nb,
                              bases[spec.array_index(fr.ref.array)],
                              self.pdt,
                              self.spans.index(fr.ref.share_span or 0), clock)

    def stream(self, refs, w: int, rows):
        """:meth:`parts` as a list, and ``span_of``, which maps a code
        column to its int32 share spans (code 0 is span 0, the ghosts')."""
        return list(self.parts(refs, w, rows)), \
            lambda code: self.span_table[code.long()]

    sort_window = _sort_window
    template_window = _template_window


@dataclasses.dataclass
class SamplerResult:
    """Per-thread dense histograms + dict views matching the reference's
    state: ``noshare[t]`` is ``_NoSharePRI[t]`` (keys -1 and powers of two),
    ``share[t]`` is ``_SharePRI[t]`` (raw keys under the share-ratio group
    T-1), ``max_iteration_count`` the printed "max iteration traversed"."""

    noshare_dense: np.ndarray   # [T, NBINS] int64 (float64 when sampled)
    share_raw: list[dict]       # [T] {raw reuse: count}
    share_ratio: int
    max_iteration_count: int
    #: fraction of the stream actually walked: 1.0 for a full run, below 1
    #: only for :mod:`pluss_torch.sampling` estimates (float counts)
    sampled_fraction: float = 1.0
    #: degradation-ladder rungs taken to produce this result
    #: (:func:`pluss_torch.resilience.run_resilient`); empty for a clean
    #: first attempt and for every plain :func:`run`
    degradations: tuple = ()
    #: the sharded backend's dispatch record (:mod:`pluss_torch.parallel`):
    #: mode, devices, and for steal its chunks, steals and schedule
    dispatch_stats: dict | None = None

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

    def tenant_view(self) -> "SamplerResult":
        """An independently-owned copy for ONE tenant of a coalesced
        dispatch (:mod:`pluss_torch.serve`): the serving demux hands each
        member of a shared batch its own view, so no tenant's
        post-processing can alias another's arrays or dicts.  The copy is
        cheap — [T, NBINS] counts plus the raw share dicts — next to the
        dispatch it amortizes."""
        return dataclasses.replace(
            self,
            noshare_dense=self.noshare_dense.copy(),
            share_raw=[dict(d) for d in self.share_raw],
        )


def dispatch_key(spec: LoopNestSpec, cfg: SamplerConfig,
                 share_cap: int = SHARE_CAP,
                 window_accesses: int | None = None) -> tuple:
    """Batch-compatibility key of one prediction request
    (:mod:`pluss_torch.serve`).

    Two requests with equal keys resolve to the SAME plan, so one engine
    run can serve all of them, with per-request result views
    demultiplexed on return (:meth:`SamplerResult.tenant_view`).
    ``cache_kb`` is left out: it only steers the AET/MRC conversion after
    the run, so requests differing in cache size alone share the dispatch
    and diverge at demux.  ``share_cap`` stays in the key as a label, as
    the JAX package has it (the port's engine has no share cap), so keys
    and batching match across the packages.  Specs and configs are frozen
    dataclasses, so the tuple is hashable and order-stable."""
    return (spec, plan_cfg(cfg), int(share_cap), window_accesses)


def plan_cfg(cfg: SamplerConfig) -> SamplerConfig:
    """``cfg`` as a plan sees it: ``cache_kb`` only steers the AET/MRC
    conversion after the run, so the plan memo, the warm set and the
    precompile registry key on this config (a request whose cache size
    alone differs from a warmed one's finds the warm plan)."""
    return dataclasses.replace(cfg, cache_kb=0)


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
                        thread_num: int, sign: int = 1,
                        out: list[dict] | None = None) -> list[dict]:
    """Host merge of the per-window share uniques into per-thread raw
    dicts: one device-side unique over every window's packed keys, one copy
    to the host.  ``sign=-1`` with an existing ``out`` subtracts (the
    overlays' substituted template events that never happened)."""
    if out is None:
        out = [dict() for _ in range(thread_num)]
    if not keys:
        return out
    uniq, tot = share_unique(torch.cat(keys), torch.cat(cnts))
    uniq, tot = uniq.cpu().numpy(), tot.cpu().numpy()
    tid = uniq >> SHARE_SHIFT
    vals = uniq & ((1 << SHARE_SHIFT) - 1)
    for t, v, c in zip(tid.tolist(), vals.tolist(), tot.tolist()):
        out[t][v] = out[t].get(v, 0) + sign * c
    return out


def overlay_static_share(share_raw: list[dict], pl: StreamPlan) -> None:
    """Host-side static share accounting of the overlay nests.

    Per ultra window, every thread's window contributes each overlaid
    group's static in-window share events (shift-invariant, like the main
    template's), MINUS the sweeping group's per-line static share on that
    window's collision lines: those lines' events were emitted exactly by
    the device's arrival corrections instead.  Counts may go negative here
    for a while; :func:`_finalize` settles them.
    """
    cfg = pl.cfg
    T = cfg.thread_num
    for np_ in pl.nests:
        ultra = np.nonzero(np_.ultra_windows())[0]
        if not len(ultra) or not np_.overlays:
            continue
        for ov in np_.overlays:
            pairs = list(zip(ov.d_share_vals.tolist(),
                             (ov.d_share_cnts * len(ultra)).tolist())) + \
                list(zip(ov.s_share_vals.tolist(),
                         (ov.s_share_cnts * len(ultra)).tolist()))
            CSR = cfg.chunk_size * ov.R
            for t in range(T):
                d = share_raw[t]
                for v, c in pairs:
                    d[v] = d.get(v, 0) + c
                # collision lines of every ultra window of this thread
                lines = []
                for w in ultra.tolist():
                    for r in range(np_.window_rounds):
                        rs = (((w * np_.window_rounds + r) * T + t)
                              * cfg.chunk_size)
                        lines.append(np.arange(rs * ov.R, rs * ov.R + CSR))
                lines = np.concatenate(lines)
                vals = ov.s_line_share_val[lines].ravel()
                cnts = ov.s_line_share_cnt[lines].ravel()
                nz = cnts > 0
                uv, idx = np.unique(vals[nz], return_inverse=True)
                uc = np.bincount(idx, weights=cnts[nz]).astype(np.int64)
                for v, c in zip(uv.tolist(), uc.tolist()):
                    d[v] = d.get(v, 0) - c


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


def _normalize_thread_batch(thread_batch: int | None,
                            cfg: SamplerConfig) -> int | None:
    """Validate ``thread_batch`` and collapse the values that mean all
    threads at once to None."""
    if thread_batch is None:
        return None
    if thread_batch < 1:
        raise ValueError(f"thread_batch must be >= 1, got {thread_batch}")
    return None if thread_batch >= cfg.thread_num else thread_batch


def _segment_entries_per_window(np_: NestPlan, cfg: SamplerConfig,
                                n_lines: int, is_ultra: bool,
                                brefs) -> int:
    """Sorted entries one window of this segment puts on the device, per
    thread.  Ultra windows sort only the template-ineligible remainder
    (the template and overlay part is O(lines), counted as the ghost
    term)."""
    refs = np_.var_refs_novl if is_ultra else (brefs or np_.refs)
    per_iter = sum(int(np.prod(fr.trips[1:], dtype=np.int64)) for fr in refs)
    return np_.window_rounds * cfg.chunk_size * per_iter + n_lines


def _dispatch_entry_budget() -> int:
    """Sorted entries per slice of a sliced run, across its concurrent
    threads (``PLUSS_MAX_DISPATCH_ENTRIES``, default 2^28)."""
    return int(os.environ.get("PLUSS_MAX_DISPATCH_ENTRIES", 1 << 28))


def _slice_schedule(pl: StreamPlan, cfg: SamplerConfig,
                    thread_batch: int | None,
                    budget: int) -> list[tuple[int, int, list]]:
    """A sliced run's schedule: ``(ni, si, window ids)`` slices of the
    segments (:func:`_segments_of`) in execution order, each sized to
    ``budget`` sorted entries across the thread batch."""
    n_lines = pl.spec.total_lines(cfg)
    conc = thread_batch or cfg.thread_num
    out: list[tuple[int, int, list]] = []
    for ni, np_ in enumerate(pl.nests):
        for si, (is_ultra, w_list, brefs) in enumerate(_segments_of(np_)):
            epw = _segment_entries_per_window(np_, cfg, n_lines,
                                              is_ultra, brefs)
            wpd = max(1, min(len(w_list), budget // max(1, epw * conc)))
            for lo in range(0, len(w_list), wpd):
                out.append((ni, si, w_list[lo:lo + wpd]))
    return out


def _auto_dispatch(pl: StreamPlan, cfg: SamplerConfig,
                   thread_batch: int | None, limit: int):
    """How to run a plan within ``limit`` device bytes: None for the
    plain run of every thread at once, or ``(thread_batch, reason)`` for
    :func:`run_sliced`.

    Two ceilings, the JAX package's: the estimated time of the whole
    stream as one dispatch (sorted entries over ``PLUSS_DISPATCH_ENTRY_RATE``,
    default 5e7/s, against ``PLUSS_MAX_DISPATCH_S``, default 30 s), and
    memory: the largest sort window times the thread concurrency against
    ``limit``, halving the concurrency until it fits (1 is the last rung:
    one window must fit, or the run's budget check raises).  Host math
    only: for the same plan, environment and limit this is the JAX
    package's decision.
    """
    T = cfg.thread_num
    n_lines = pl.spec.total_lines(cfg)
    rate = float(os.environ.get("PLUSS_DISPATCH_ENTRY_RATE", 5e7))
    ceiling_s = float(os.environ.get("PLUSS_MAX_DISPATCH_S", 30))
    total_entries = 0
    max_window_bytes = 0
    for np_ in pl.nests:
        for is_ultra, w_list, brefs in _segments_of(np_):
            epw = _segment_entries_per_window(np_, cfg, n_lines, is_ultra,
                                              brefs)
            total_entries += epw * len(w_list) * T
            refs = np_.var_refs_novl if is_ultra else (brefs or np_.refs)
            if refs:
                max_window_bytes = max(max_window_bytes, sort_window_bytes(
                    np_, cfg, pl.pos_dtype, n_lines, refs))
    conc = thread_batch or T
    while conc > 1 and max_window_bytes * conc > limit:
        conc = (conc + 1) // 2
    est_s = total_entries / rate
    if est_s <= ceiling_s and conc == (thread_batch or T):
        return None
    reasons = []
    if est_s > ceiling_s:
        reasons.append(f"estimated {est_s:.0f}s single-executable time "
                       f"exceeds the {ceiling_s:.0f}s dispatch ceiling")
    if conc != (thread_batch or T):
        reasons.append(f"sort-window memory {max_window_bytes / 2**30:.2f}"
                       f" GiB/window caps thread concurrency at {conc}")
    return _normalize_thread_batch(conc, cfg), "; ".join(reasons)


def _dispatch(pl: StreamPlan, cfg: SamplerConfig, thread_batch: int | None,
              limit: int) -> tuple:
    """How a default run of ``pl`` within ``limit`` device bytes goes:
    ``(thread_batch, dispatch_entries, reason)``.  One dispatch keeps
    ``thread_batch`` and has None for the other two; a plan
    :func:`_auto_dispatch` reroutes gets its thread batch,
    :func:`_dispatch_entry_budget` and the reason.
    ``PLUSS_NO_AUTO_DISPATCH=1`` keeps every plan on one dispatch; this is
    its only reader.  The caller reads :func:`sort_budget` once for this
    and its budget check (a read takes ~0.65 ms on an H100)."""
    if not os.environ.get("PLUSS_NO_AUTO_DISPATCH"):
        decision = _auto_dispatch(pl, cfg, thread_batch, limit)
        if decision is not None:
            return decision[0], _dispatch_entry_budget(), decision[1]
    return thread_batch, None, None


def _freeze(assignment):
    """Per-nest assignments as hashable tuples (the plan memo's key)."""
    if assignment is None:
        return None
    return tuple(tuple(a) if a is not None else None for a in assignment)


#: in-process single-flight registry of plan builds: concurrent callers
#: for one cold key (the serving daemon's device loop racing its warm
#: thread or its background compile, the sweep's precompile thread) plan
#: ONCE; waiters share the plan or the same typed failure.  The serve SLO
#: publisher exports its depth as the ``serve.compile_inflight`` gauge.
_compile_registry = plancache.CompileRegistry(
    gauge="engine.compile_inflight")


def compile_inflight() -> int:
    """Plan builds currently in flight in the single-flight registry."""
    return _compile_registry.inflight()


@functools.lru_cache(maxsize=32)
def _plan_memo(spec: LoopNestSpec, cfg: SamplerConfig, assignment,
               start_point, window_accesses) -> StreamPlan:
    with obs.span("engine.plan", model=spec.name, threads=cfg.thread_num,
                  chunk=cfg.chunk_size):
        return plan(spec, cfg, assignment, start_point, window_accesses)


def _plan_cached(spec: LoopNestSpec, cfg: SamplerConfig, assignment,
                 start_point, window_accesses) -> StreamPlan:
    """The process's plan memo, shared by :func:`run`, :func:`run_sliced`,
    :func:`precompile` and :func:`describe_path`, behind the single-flight
    registry (an ``lru_cache`` alone lets two threads racing a cold key
    both plan)."""
    key = (spec, plan_cfg(cfg), assignment, start_point, window_accesses)
    return _compile_registry.do(key, lambda: _plan_memo(*key))


_plan_cached.cache_clear = _plan_memo.cache_clear


@functools.lru_cache(maxsize=32)
def shard_plan_cached(spec: LoopNestSpec, cfg: SamplerConfig, assignment,
                      start_point, window_accesses,
                      n_windows: int) -> StreamPlan:
    """The plan memo of the sharded backend (:mod:`pluss_torch.parallel`):
    its static and steal dispatch plan the same ``n_windows`` grid, so
    they share one plan, and the chunk functions cached on it survive a
    dispatch-mode flip.  Overlays and row-private tables are off, as in
    the JAX package: a shard window sorts the full ``var_refs``."""
    with obs.span("engine.plan", model=spec.name, threads=cfg.thread_num,
                  chunk=cfg.chunk_size, backend="shard"):
        return plan(spec, cfg, assignment, start_point, window_accesses,
                    build_overlays=False, build_rowpriv=False,
                    n_windows=n_windows)


def _build_kernels(pl: StreamPlan, dev: torch.device) -> None:
    """Build the kernels a run of ``pl`` on ``dev`` launches when the
    device is CUDA (the event-histogram kernel and the window sort when a
    window sorts, the overlay-window kernel when a nest has overlays): the
    ``engine.compile`` fault site, once per run attempt."""
    faults.check("engine.compile")
    if dev.type != "cuda":
        return
    if any(np_.refs for np_ in pl.nests):
        build.load("event_hist")
        build.load("window_sort")
    if any(np_.overlays for np_ in pl.nests):
        build.load("overlay_window")


#: (spec, cfg, window_accesses) of default runs warmed in this process
_warm_keys: set = set()

#: monotonic count of the one-dispatch runs this process has issued
#: through :func:`run` — the witness of the zero-dispatch contract of
#: ``cli predict``/``cli tune`` (:mod:`pluss_torch.analysis.ri`).  Counted
#: as the JAX package counts it (``pluss/engine.py``): once per
#: :func:`run` that is not rerouted; a rerouted run and a direct
#: :func:`run_sliced` count nothing.
DEVICE_DISPATCHES = 0


def run(spec: LoopNestSpec, cfg: SamplerConfig = DEFAULT, *, device=None,
        assignment=None, start_point: int | None = None,
        window_accesses: int | None = None,
        thread_batch: int | None = None,
        backend: str = "vmap") -> SamplerResult:
    """Run the sampler on ``device`` (default: the CUDA card).

    ``assignment``: optional per-nest chunk->thread maps; ``start_point``:
    resume iteration value of the first nest; ``window_accesses``:
    accesses per window per thread (default WINDOW_TARGET);
    ``thread_batch``: threads whose windows run at once (default all).
    ``backend``: ``vmap`` (the threads as rows of one batch) or ``seq``
    (one simulated thread at a time, never rerouted; the JAX package's
    ``seq``), the same result either way; the device-sharded backend is
    :mod:`pluss_torch.parallel`.

    A plan whose concurrent sort windows exceed the device's budget
    (:func:`sort_budget`), or whose stream is past the one-dispatch time
    ceiling, goes through :func:`run_sliced` with the thread batch that
    :func:`_auto_dispatch` picks (same result; a line on stderr says so;
    ``PLUSS_NO_AUTO_DISPATCH=1`` turns this off).  Sort windows that do
    not fit even one at a time raise before any window runs.
    """
    faults.check("engine.run")   # chaos injection site (per entry attempt)
    if backend not in ("vmap", "seq"):
        raise ValueError(f"unknown backend {backend!r} (expected 'vmap' or "
                         "'seq')")
    dev = resolve_device(device)
    assignment = _freeze(assignment)
    tb = 1 if backend == "seq" else _normalize_thread_batch(thread_batch,
                                                            cfg)
    pl = _plan_cached(spec, cfg, assignment, start_point, window_accesses)
    limit = sort_budget(dev)
    budget = None
    if backend == "vmap":
        tb, budget, reason = _dispatch(pl, cfg, tb, limit)
        if reason is not None:
            print(f"engine: auto-sliced dispatch (thread_batch="
                  f"{tb or cfg.thread_num}): {reason}", file=sys.stderr)
            obs.counter_add("engine.auto_dispatch_reroutes")
            obs.event("engine.auto_dispatch", model=spec.name,
                      thread_batch=tb or cfg.thread_num, reason=reason)
    check_sort_budget(pl.nests, spec, cfg, pl.pos_dtype, limit, tb)
    _build_kernels(pl, dev)
    if assignment is None and start_point is None:
        _warm_keys.add((spec, plan_cfg(cfg), window_accesses))
    if budget is None:
        global DEVICE_DISPATCHES
        DEVICE_DISPATCHES += 1
    return _execute(pl, dev, thread_batch=tb, dispatch_entries=budget,
                    backend=backend)


def run_sliced(spec: LoopNestSpec, cfg: SamplerConfig = DEFAULT, *,
               device=None, assignment=None, start_point=None,
               window_accesses=None, thread_batch: int | None = None,
               max_dispatch_entries: int | None = None) -> SamplerResult:
    """The sampler run as slices of windows, ``thread_batch`` threads at
    a time (default all).

    The slices (:func:`_slice_schedule`, ``max_dispatch_entries`` sorted
    entries each, default :func:`_dispatch_entry_budget`) run in stream
    order; within a slice each thread batch walks the slice's windows
    against its own rows of the carried table, so the device holds the
    sort windows of one batch at a time, and the slice's share uniques
    fold into one before the next slice.  Equal to :func:`run`.
    """
    faults.check("engine.run")   # chaos injection site, per attempt
    dev = resolve_device(device)
    assignment = _freeze(assignment)
    tb = _normalize_thread_batch(thread_batch, cfg)
    pl = _plan_cached(spec, cfg, assignment, start_point, window_accesses)
    check_sort_budget(pl.nests, spec, cfg, pl.pos_dtype, sort_budget(dev),
                      tb)
    _build_kernels(pl, dev)
    return _execute(pl, dev, thread_batch=tb,
                    dispatch_entries=max_dispatch_entries
                    or _dispatch_entry_budget())


def precompile(spec: LoopNestSpec, cfg: SamplerConfig = DEFAULT, *,
               device=None, assignment=None, start_point=None,
               window_accesses=None,
               thread_batch: int | None = None) -> str:
    """Warm what :func:`run` needs, without running: the plan (into the
    process memo and the disk plan cache) and, on a CUDA device when the
    plan sorts anything, the event-histogram kernel.  Returns the path
    :func:`run` would take: ``'sliced'`` when the auto-dispatch ladder
    reroutes, else ``'full'``."""
    dev = resolve_device(device)
    assignment = _freeze(assignment)
    tb = _normalize_thread_batch(thread_batch, cfg)

    def warm() -> str:
        with obs.span("engine.precompile", model=spec.name,
                      threads=cfg.thread_num, chunk=cfg.chunk_size):
            pl = _plan_cached(spec, cfg, assignment, start_point,
                              window_accesses)
            _build_kernels(pl, dev)
            if assignment is None and start_point is None:
                _warm_keys.add((spec, plan_cfg(cfg), window_accesses))
            return "sliced" if _dispatch(pl, cfg, tb,
                                         sort_budget(dev))[1] else "full"

    # single-flight: a serve --warm entry racing the daemon's background
    # compile of the same key warms once; both get its answer (or error)
    return _compile_registry.do(
        ("precompile", spec, plan_cfg(cfg), str(dev), assignment,
         start_point, window_accesses, tb), warm)


def warm_run(spec: LoopNestSpec, cfg: SamplerConfig = DEFAULT, *,
             device=None, window_accesses: int | None = None) -> None:
    """Run a default-scheduled plan once on ``device`` and drop the
    result: torch loads each CUDA kernel's module at its first launch and
    the caching allocator grows at its first allocations, so a daemon's
    warm-up that ends with this leaves none of that to its first request.
    Not an attempt of :func:`run`: no fault site, no dispatch count; the
    auto-dispatch ladder applies as in :func:`run`, silently."""
    dev = resolve_device(device)
    pl = _plan_cached(spec, cfg, None, None, window_accesses)
    limit = sort_budget(dev)
    tb, budget, _ = _dispatch(pl, cfg, None, limit)
    check_sort_budget(pl.nests, spec, cfg, pl.pos_dtype, limit, tb)
    _execute(pl, dev, thread_batch=tb, dispatch_entries=budget)


def is_warm(spec: LoopNestSpec, cfg: SamplerConfig,
            window_accesses: int | None = None) -> bool:
    """Whether a default run of ``spec`` (no assignment, no start point)
    was planned by :func:`run` or :func:`precompile` in this process: a
    hint (the memo may have evicted the plan since), never needed for a
    correct result."""
    return (spec, plan_cfg(cfg), window_accesses) in _warm_keys


class _Walk:
    """The device state of one run: the carried ``last_pos [T, lines]``
    table, the ``[T, NBINS]`` histogram and the share uniques, which
    :meth:`window` advances for any contiguous range of thread rows."""

    def __init__(self, pl: StreamPlan, device: torch.device, event_hist):
        T = pl.cfg.thread_num
        self.event_hist = event_hist
        pdt = torch.int32 if pl.pos_dtype == np.int32 else torch.int64
        self.last_pos = torch.full((T, pl.spec.total_lines(pl.cfg)), -1,
                                   dtype=pdt, device=device)
        self.hist = torch.zeros((T, NBINS), dtype=torch.int64, device=device)
        self.nests = [DeviceNest(pl, ni, device)
                      for ni in range(len(pl.nests))]
        # share uniques to add, and the overlays' to subtract
        self.plus: list[tuple[torch.Tensor, torch.Tensor]] = []
        self.minus: list[tuple[torch.Tensor, torch.Tensor]] = []

    def window(self, ni: int, si: int, w: int, rows: slice) -> None:
        """Window ``w`` of segment ``si`` of nest ``ni`` for thread
        ``rows``: every update lands in place in those rows.  Each
        overlaid array's window is an ``engine.overlay_window`` tally and
        one count of ``engine.overlay_windows``."""
        dn = self.nests[ni]
        np_ = dn.np_
        is_ultra, _, brefs = dn.segments[si]
        last_pos, hist = self.last_pos[rows], self.hist[rows]
        tids = dn.tids[rows]
        cand, minus = [], []
        if is_ultra:
            # template-ineligible arrays without an overlay sort inside the
            # clean window too; the arrays' line ranges are disjoint, so
            # the parts update the carried table independently
            if np_.var_refs_novl:
                dh, ev = dn.sort_window(np_.var_refs_novl, dn.var_ranges, w,
                                        rows, last_pos, self.event_hist)
                hist += dh
                cand.append((ev["reuse"], ev["share"]))
            for dov in dn.dovl:
                with obs.tally_span("engine.overlay_window"):
                    dh, plus, sub = device_window(dov, dn.cfg, w, tids,
                                                  dn.nb[rows], last_pos)
                obs.counter_add("engine.overlay_windows")
                hist += dh
                cand.append(plus)
                minus.append(sub)
            if dn.dtpl is not None:
                cand.append(dn.template_window(w, rows, last_pos, hist))
        elif np_.refs:
            # a window whose arrays are all closed-form sorts nothing and
            # launches nothing
            dh, ev = dn.sort_window(brefs or np_.refs, dn.all_ranges, w,
                                    rows, last_pos, self.event_hist)
            hist += dh
            cand.append((ev["reuse"], ev["share"]))
        if dn.rpg is not None:
            hist += dn.rpg[rows, w]
        if not (cand or minus):
            return
        # torch.unique sizes its output from the device's data, so the
        # span takes in the wait for the window's work
        with obs.tally_span("engine.share_unique"):
            for out, pairs in ((self.plus, cand), (self.minus, minus)):
                if pairs:
                    out.append(share_unique(torch.cat(
                        [share_keys(r, s, tids) for r, s in pairs])))

    def fold(self) -> None:
        """Merge the share uniques gathered so far into one pair each."""
        lsts = [lst for lst in (self.plus, self.minus) if len(lst) > 1]
        if not lsts:
            return
        with obs.tally_span("engine.share_unique"):
            for lst in lsts:
                lst[:] = [share_unique(torch.cat([k for k, _ in lst]),
                                       torch.cat([c for _, c in lst]))]


def _execute(pl: StreamPlan, device: torch.device,
             event_hist=event_histogram, thread_batch: int | None = None,
             dispatch_entries: int | None = None,
             backend: str = "vmap") -> SamplerResult:
    """Run a plan's windows on ``device`` and finalize on the host.

    ``thread_batch`` rows walk together (default all); with
    ``dispatch_entries`` the segments split into :func:`_slice_schedule`'s
    slices, each folding its share uniques, else each segment is one
    slice.  ``event_hist`` is the sort windows' histogram function: the
    kernel wrapper, or its plain version when ``chip_smoke.py``
    cross-checks the kernel end to end on the card.

    Telemetry: the ``engine.dispatch`` span (``backend`` ``vmap`` for one
    pass over all rows, ``seq`` for :func:`run`'s one thread at a time,
    ``sliced`` with its ``thread_batch`` and
    ``dispatches``) ends at the copy of the histogram to the host, which
    waits for every launch, so it covers the device's work; then
    ``engine.refs_processed`` (and ``engine.sliced_dispatches``) count,
    and :func:`_finalize` runs in its own span.
    """
    cfg = pl.cfg
    T = cfg.thread_num
    step = thread_batch or T
    if dispatch_entries:
        slices = _slice_schedule(pl, cfg, thread_batch, dispatch_entries)
        attrs = {"backend": "sliced", "thread_batch": step}
    else:
        slices = [(ni, si, w_list) for ni, np_ in enumerate(pl.nests)
                  for si, (_, w_list, _) in enumerate(_segments_of(np_))]
        attrs = {"backend": backend}
    name = pl.spec.name
    walk = _Walk(pl, device, event_hist)
    with xprof.session(), \
            obs.span("engine.dispatch", model=name, **attrs) as sp:
        for ni, si, w_list in slices:
            for lo in range(0, T, step):
                rows = slice(lo, min(T, lo + step))
                for w in w_list:
                    walk.window(ni, si, w, rows)
            walk.fold()
        hist = walk.hist.cpu().numpy()   # the copy waits for the device
        if dispatch_entries:
            sp.set(dispatches=len(slices))
    if dispatch_entries:
        obs.counter_add("engine.sliced_dispatches", len(slices))
    obs.counter_add("engine.refs_processed", pl.total_count)
    with obs.span("engine.finalize", model=name):
        return _finalize(pl, hist, walk.plus, walk.minus)


def _finalize(pl: StreamPlan, hist: np.ndarray, plus, minus) -> SamplerResult:
    """Merge the share uniques (the overlays' subtractions too), add the
    host-side static share constants, and box the result.  Overlay runs
    drop values whose net count is 0 and raise on a negative one."""
    T = pl.cfg.thread_num
    share_raw = merge_share_windows([k for k, _ in plus],
                                    [c for _, c in plus], T)
    merge_share_windows([k for k, _ in minus], [c for _, c in minus], T,
                        sign=-1, out=share_raw)
    # static in-window share events of ultra windows are host-side
    # constants: identical values and counts for every clean window
    add_static_share(share_raw,
                     [(n, int(n.ultra_windows().sum())) for n in pl.nests])
    # the sweep groups' share events are whole-run host constants too
    for n_ in pl.nests:
        for d, adds in zip(share_raw, n_.static_share or ()):
            for v, c in adds.items():
                d[v] = d.get(v, 0) + c
    if any(n.overlays for n in pl.nests):
        overlay_static_share(share_raw, pl)
        for t, d in enumerate(share_raw):
            bad = {v: c for v, c in d.items() if c < 0}
            if bad:
                raise RuntimeError(
                    f"overlay share accounting went negative (thread {t}): "
                    f"{bad}")
            for v in [v for v, c in d.items() if c == 0]:
                d.pop(v)
    return SamplerResult(noshare_dense=hist, share_raw=share_raw,
                         share_ratio=T - 1,
                         max_iteration_count=pl.total_count)
