"""Dynamic trace replay: reuse histograms from raw address streams.

The port of ``pluss/trace.py``'s single-device replay (BASELINE config 5:
raw DynamoRIO-style memory traces at 1e9 refs), streamed and
device-resident.

1. Host: byte addresses are masked to cache lines (``addr >> log2(CLS)``)
   and remapped to dense ids by cluster probing (:class:`_Compactor`; while
   the table holds one cluster, the native mapper of
   :mod:`pluss_torch.native` does it in one pass), batch by batch, in a
   pool of feed threads (:class:`_FeedPool`) that read and wire-encode
   extents of the file in parallel and compact them in stream order.
2. Wire: each batch crosses to the card as the content-adaptive ``d24v``
   encoding (the default on the card, decoded there by the CUDA kernel of
   :mod:`pluss_torch.ops.decode`) or as the fixed-width ``pack``
   (u16/u24/i32, the default on the CPU).  Pinned host buffers and a side
   stream let the copy and decode of batch b+1 overlap batch b's work.
3. Device: each ``[batch_windows * window]`` batch is one segmented
   extraction (:func:`pluss_torch.ops.reuse.batch_events`: one stable sort
   on the line key, one carried gather, one tail scatter into the
   ``last_pos`` table) and one masked histogram (the CUDA kernel of
   :func:`pluss_torch.ops.event_hist.masked_histogram`), accumulated as
   int64 on the card.  ``segmented=False`` takes the legacy per-window
   scan instead (:func:`_scan_batch`, the A/B reference: one sort and one
   histogram per window); both give the same histogram.

A replayed trace is single-clock, so the result feeds
:func:`pluss_torch.mrc.aet_mrc` directly, with no CRI dilation.

Entry points, all on the CUDA card unless the caller passes
``device="cpu"``:

- :func:`replay_file` streams a file in bounded host memory, with
  checkpoint/resume, and with ``resident_cache=True`` rides the
  residency store (:mod:`pluss_torch.residency`): a hit replays the
  resident copy with no feed; a miss stages the stream into the store
  while it replays.  :func:`replay` replays an in-memory stream.
- :func:`pack_file` / :func:`pack_cached` compact and encode a trace once
  into a packed file (u24, i32 past 2^24 lines, or d24v records) with a
  JSON sidecar; :func:`stage_resident` uploads a pack into device memory
  (d24v records decoded there by the kernel), :func:`replay_staged`
  replays it any number of times, :func:`replay_resident` does both, and
  :func:`ensure_resident` packs, stages and publishes into the store.

Histograms, ``total_count`` and ``n_lines`` equal ``pluss.trace``'s; the
two packages' checkpoints, pack journals, packs and sidecars are
interchangeable.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import hashlib
import json
import os
import queue
import sys
import threading
import time
from collections import deque

import numpy as np
import torch

from pluss_torch import obs, residency
from pluss_torch.config import NBINS
from pluss_torch.engine import resolve_device
from pluss_torch.obs import tracectx, xprof
from pluss_torch.ops import wirecodec
from pluss_torch.ops.decode import decode_d24v
from pluss_torch.ops.event_hist import masked_histogram, masked_histogram_plain
from pluss_torch.ops.reuse import batch_events, event_histogram
from pluss_torch.resilience import faults
from pluss_torch.resilience.errors import (DataLoss, ResourceExhausted,
                                          quarantine_artifact)
from pluss_torch.resilience.journal import Journal

#: default accesses per window (the batch is ``batch_windows`` windows)
TRACE_WINDOW = 1 << 20


def _env_int(name: str, default: int, minimum: int = 1) -> int:
    """An integer env knob, parsed leniently (warn once and fall back;
    :mod:`pluss_torch.utils.envknob`).  Explicit keyword arguments keep
    their loud validation (:func:`_positive`)."""
    from pluss_torch.utils.envknob import env_int

    return env_int(name, default, minimum)


#: default windows per device batch: 16 x 2^20 = 2^24 refs per sort
#: (``PLUSS_BATCH_WINDOWS`` overrides it for the process)
WINDOWS_PER_BATCH = _env_int("PLUSS_BATCH_WINDOWS", 16)

WIRE_CHOICES = ("auto", "pack", "d24v")

#: packed-trace wire-format version stamped in pack_file's sidecar (the
#: JAX package's): pack caches and resident keys carry it, so a pack of
#: another format is never replayed as this one
WIRE_VERSION = 1

#: batches above this many ids stay on the plain pack even under
#: ``wire="d24v"`` (the JAX package's limit, kept so both packages pick
#: the same wire for the same batch)
_D24V_MAX_BATCH = 1 << 26


@dataclasses.dataclass(frozen=True)
class TraceKernels:
    """The two per-batch device functions of a replay: the masked event
    histogram and the d24v decode (kernel wrappers by default; their plain
    versions when a run cross-checks the kernels end to end)."""

    histogram: object
    decode: object


KERNELS = TraceKernels(masked_histogram, decode_d24v)
PLAIN = TraceKernels(masked_histogram_plain, wirecodec.decode_d24v_plain)


def lines_of(addrs: np.ndarray, cls: int = 64) -> np.ndarray:
    """Mask byte addresses to cache-line ids."""
    if cls & (cls - 1):
        raise ValueError(f"cache line size {cls} is not a power of two")
    return np.asarray(addrs, np.int64) >> int(cls).bit_length() - 1


@dataclasses.dataclass
class ReplayResult:
    """Dense log2 reuse histogram of one replayed stream.

    ``hist[0]`` = cold (first-touch) count, ``hist[1+e]`` = reuses in
    [2^e, 2^{e+1}).  ``histogram()`` returns the reference-keyed dict view
    (cold key -1), directly consumable by :func:`pluss_torch.mrc.aet_mrc`.
    ``wire``/``feed_workers`` are the streamed feed's effective settings
    (empty/0 without one); ``degradations`` are the ladder rungs taken
    (:func:`pluss_torch.resilience.replay_file_resilient`; empty for a
    clean first attempt and for every plain replay); ``timing`` is its
    main-thread time split
    (``prefetch_stall_s``, ``h2d_s``, ``device_s``, ``ckpt_save_s``,
    ``grow_s``, ``wall_s``), the feed's seconds per stage summed over its
    workers (``read_s``, ``compact_s``, ``encode_s``; they run beside the
    main thread) and the batch and byte counts.
    """

    hist: np.ndarray          # [NBINS] int64
    total_count: int
    n_lines: int
    degradations: tuple = ()
    wire: str = ""
    feed_workers: int = 0
    timing: dict = dataclasses.field(default_factory=dict)

    def histogram(self) -> dict:
        out = {-1: float(self.hist[0])}
        for e in range(NBINS - 1):
            if self.hist[1 + e]:
                out[1 << e] = float(self.hist[1 + e])
        return out


def _positive(name: str, value, default: int) -> int:
    """``value`` (default when None) as an int, which must be >= 1: a
    zero or negative geometry would replay nothing while claiming
    coverage, or leave a queue unbounded."""
    v = default if value is None else int(value)
    if v < 1:
        raise ValueError(f"{name} must be >= 1, got {v}")
    return v


def _tuned(field: str, device=None):
    """The autotuned geometry's value for one replay knob on ``device``,
    or None.  Consulted LAST in every default resolution: explicit kwargs
    and ``PLUSS_*`` env overrides always win; the tuned value only
    replaces the shipped default (:mod:`pluss_torch.autotune`).  Host work
    with no device of its own (``pack_file``) consults the card's
    geometry when there is a card, the host's otherwise."""
    from pluss_torch import autotune

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return autotune.consult(field, device)


def _resolve_window(window: int | None, device=None) -> int:
    """The effective replay window: explicit kwarg > autotuned geometry >
    :data:`TRACE_WINDOW`.  Histograms are window-invariant, so the tuned
    value is a throughput knob only; but it is part of the checkpoint and
    residency identity, so it resolves once, up front."""
    if window is not None:
        return _positive("window", window, TRACE_WINDOW)
    t = _tuned("window", device)
    return int(t) if t else TRACE_WINDOW


def _resolve_bw(batch_windows: int | None, device=None) -> int:
    """The effective windows per batch, validated (``batch_windows=-4``
    would replay nothing while claiming coverage).  Default chain: kwarg >
    ``PLUSS_BATCH_WINDOWS`` > autotuned geometry > 16."""
    if batch_windows is None:
        bw = None
        if "PLUSS_BATCH_WINDOWS" not in os.environ:
            bw = _tuned("batch_windows", device)
        bw = int(bw) if bw else WINDOWS_PER_BATCH
        return _positive("batch_windows", bw, WINDOWS_PER_BATCH)
    return _positive("batch_windows", batch_windows, WINDOWS_PER_BATCH)


def _resolve_stage_depth(stage_depth: int | None, device=None) -> int:
    """Staged-ahead device batches: kwarg > ``PLUSS_TRACE_STAGE_DEPTH`` >
    autotuned geometry > 2 (the double buffer)."""
    if stage_depth is None:
        if "PLUSS_TRACE_STAGE_DEPTH" not in os.environ:
            t = _tuned("stage_depth", device)
            if t:
                return int(t)
        return _env_int("PLUSS_TRACE_STAGE_DEPTH", 2)
    return _positive("stage_depth", stage_depth, 2)


def _resolve_queue_depth(queue_depth: int | None, device=None) -> int:
    """Feed queue bound: kwarg > ``PLUSS_TRACE_QUEUE_DEPTH`` > autotuned
    geometry > 2 (a depth of 0 would leave the queue unbounded)."""
    if queue_depth is None:
        if "PLUSS_TRACE_QUEUE_DEPTH" not in os.environ:
            t = _tuned("queue_depth", device)
            if t:
                return int(t)
        return _env_int("PLUSS_TRACE_QUEUE_DEPTH", 2)
    return _positive("queue_depth", queue_depth, 2)


def _resolve_wire(wire: str | None, device: torch.device) -> str:
    """``auto``: the autotuned wire when there is one, else d24v on the
    card (the compressed bytes cross PCIe and the kernel expands them) and
    pack on the CPU (no transport to compress for).  None reads
    ``PLUSS_WIRE`` (default ``auto``; an unknown value warns and falls
    back), where an explicit bad value raises."""
    if wire is None:
        from pluss_torch.utils.envknob import env_choice

        wire = env_choice("PLUSS_WIRE", "auto", WIRE_CHOICES)
    if wire not in WIRE_CHOICES:
        raise ValueError(f"unknown wire format {wire!r} (choices: "
                         f"{', '.join(WIRE_CHOICES)})")
    if wire == "auto":
        t = _tuned("wire", device)
        if t in ("pack", "d24v"):
            return t
        return "d24v" if device.type == "cuda" else "pack"
    return wire


def _host_workers() -> int:
    """Most of the host's cores, at least 2 and at most 8."""
    return max(2, min(8, (os.cpu_count() or 1) - 1))


def _default_feed_workers(device: torch.device) -> int:
    """On the CPU the replay computes on the same cores, so one feed
    thread; with a card the host cores idle while it computes: use most
    of them."""
    return 1 if device.type == "cpu" else _host_workers()


def _resolve_feed_workers(feed_workers: int | None, device: torch.device,
                          default: int | None = None) -> int:
    """Reader/packer pool width: kwarg > ``PLUSS_FEED_WORKERS`` >
    autotuned geometry > ``default`` (the device's
    :func:`_default_feed_workers` when None).  An explicit 0 raises: a
    pool of no workers would deliver nothing and hang the feed."""
    if feed_workers is None:
        if "PLUSS_FEED_WORKERS" not in os.environ:
            t = _tuned("feed_workers", device)
            if t:
                return int(t)
        return _env_int("PLUSS_FEED_WORKERS", default if default is not None
                        else _default_feed_workers(device))
    return _positive("feed_workers", feed_workers, 1)


class _threaded:
    """Run a generator in a daemon thread behind a bounded queue.

    ``with _threaded(gen_fn) as it:`` yields the generator's items in
    order; generator exceptions re-raise at the consumer; leaving the
    context releases a producer blocked on a full queue.
    """

    _DONE = object()

    def __init__(self, gen_fn, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._t = threading.Thread(
            target=self._run, args=(gen_fn,), daemon=True)

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, gen_fn):
        try:
            for item in gen_fn():
                if not self._put(item):
                    return
            self._put(self._DONE)
        except BaseException as e:
            self._put(e)

    def __enter__(self):
        self._t.start()
        return self

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(timeout=60)
        return False

    def qsize(self) -> int:
        """Items waiting in the queue (the occupancy gauge)."""
        return self._q.qsize()


class _FeedPool:
    """Ordered N-worker feed pipeline: read (parallel) -> compact (in
    stream order) -> wire-encode (parallel) -> strict in-order delivery.

    Batch extents are independent on disk and the encode is independent
    per extent, so N workers overlap them; only the compactor is
    order-dependent (cluster discovery mutates shared state, and its state
    is part of the checkpoint), so it runs under a turnstile admitting
    batches in exact stream order.  numpy reads and packs release the GIL,
    so the overlap is real.  A worker exception is delivered at ITS batch
    index, after every earlier batch, so checkpoint/resume keeps the same
    prefix semantics as the single reader.  ``claim_fn(b)`` runs under
    the claim lock in exact batch order: the ``trace.read_batch`` fault
    site lives there, so ``trace_loss@n`` fires on the n-th stream batch,
    not on whichever worker gets there first.  In-flight batches (claimed
    but not yet consumed) are bounded by ``depth + workers``.
    """

    def __init__(self, b0: int, end: int, claim_fn, read_fn, compact_fn,
                 encode_fn, workers: int, depth: int):
        # serve attribution: the pool is built on the replay thread, which
        # runs under the request's trace context; every worker re-enters
        # it, so their spans and events resolve to the same request
        self._trace_token = tracectx.capture()
        self._end = end
        self._claim_fn, self._read_fn = claim_fn, read_fn
        self._compact_fn, self._encode_fn = compact_fn, encode_fn
        self.workers = workers
        self._budget = depth + workers
        self._cv = threading.Condition()
        self._next_claim = b0
        self._turn = b0
        self._next_out = b0
        self._done: dict[int, object] = {}
        self._stop = False
        self.busy = 0          # workers mid-batch (telemetry gauge)
        # seconds summed over the workers, per stage
        self.stage_s = {"read_s": 0.0, "compact_s": 0.0, "encode_s": 0.0}
        self._threads = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"pluss-torch-feed-{i}")
            for i in range(workers)]

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=60)
        return False

    def qsize(self) -> int:
        """Finished batches awaiting in-order delivery (the occupancy
        gauge: persistently zero means the feed is the bottleneck)."""
        return len(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        with self._cv:
            if self._next_out >= self._end:
                raise StopIteration
            while self._next_out not in self._done:
                if not any(t.is_alive() for t in self._threads):
                    raise RuntimeError(
                        f"feed pool lost batch {self._next_out}: all "
                        "workers exited without delivering it")
                self._cv.wait(0.5)
            item = self._done.pop(self._next_out)
            self._next_out += 1
            self._cv.notify_all()
        if isinstance(item, BaseException):
            raise item
        return item

    def _run(self):
        with tracectx.attach(self._trace_token):
            self._run_inner()

    def _run_inner(self):
        while True:
            with self._cv:
                while (not self._stop and self._next_claim < self._end
                       and self._next_claim - self._next_out
                       >= self._budget):
                    self._cv.wait(0.5)
                if self._stop or self._next_claim >= self._end:
                    return
                b = self._next_claim
                self._next_claim += 1
                self.busy += 1
                err = None
                try:
                    self._claim_fn(b)   # ordered under the lock
                except BaseException as e:
                    err = e
            raw = mid = item = None
            t0 = time.perf_counter()
            if err is None:
                try:
                    raw = self._read_fn(b)
                except BaseException as e:
                    err = e
            t1 = time.perf_counter()
            # compact turnstile, strictly in stream order.  A failed batch
            # still takes and releases its turn, so later batches (to be
            # discarded once the error is delivered at b) cannot deadlock
            # behind it.
            with self._cv:
                while not self._stop and self._turn != b:
                    self._cv.wait(0.5)
                if self._stop:
                    return
            t2 = time.perf_counter()
            if err is None:
                try:
                    mid = self._compact_fn(b, raw)
                except BaseException as e:
                    err = e
            with self._cv:
                self._turn = b + 1
                self._cv.notify_all()
            t3 = time.perf_counter()
            if err is None:
                try:
                    item = self._encode_fn(b, mid)
                except BaseException as e:
                    err = e
            t4 = time.perf_counter()
            with self._cv:
                for k, dt in (("read_s", t1 - t0), ("compact_s", t3 - t2),
                              ("encode_s", t4 - t3)):
                    self.stage_s[k] += dt
                self._done[b] = err if err is not None else item
                self.busy -= 1
                self._cv.notify_all()


def _pack24(ids: np.ndarray) -> np.ndarray:
    """[n] int32 line ids < 2^24 -> [n, 3] little-endian bytes."""
    b4 = np.ascontiguousarray(ids, dtype="<i4").view(np.uint8)
    return np.ascontiguousarray(b4.reshape(-1, 4)[:, :3])


def _pack16(ids: np.ndarray) -> np.ndarray:
    """[n] int32 line ids < 2^16 -> u16."""
    return ids.astype(np.uint16)


def _pack_ids(ids: np.ndarray, n_lines: int) -> np.ndarray:
    """Tightest fixed-width wire the line-table size allows (the ``pack``
    wire)."""
    if n_lines <= 1 << 16:
        return _pack16(ids)
    if n_lines < 1 << 24:
        return _pack24(ids)
    return ids


#: one d24v-encoded batch as it rides the feed queue
_WireD24V = collections.namedtuple("_WireD24V", ("payload", "wm"))


def _encode_wire(ids: np.ndarray, n_lines: int, wirefmt: str):
    """One padded batch -> what crosses to the device: a
    :class:`_WireD24V` under the compressed wire (tables under 2^24
    lines), else the fixed-width pack."""
    if wirefmt == "d24v" and n_lines < 1 << 24 \
            and ids.shape[0] <= _D24V_MAX_BATCH:
        return _WireD24V(*wirecodec.encode_d24v(ids))
    return _pack_ids(ids, n_lines)


def _widen_ids(t: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_pack_ids` on the device: u8 [n, 3] (24-bit) |
    u8 [n, 4] (the i32 pack's little-endian bytes) | int16 (the u16 pack,
    reinterpreted) | int32 -> int32."""
    if t.dtype == torch.uint8 and t.shape[-1] == 4:
        return t.contiguous().view(torch.int32).reshape(-1)
    if t.dtype == torch.uint8:
        b = t.to(torch.int32)
        return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    if t.dtype == torch.int16:
        return t.to(torch.int32) & 0xFFFF
    return t


def _u24_bytes(ids: torch.Tensor) -> torch.Tensor:
    """int32 ids < 2^24 -> their ``[n, 3]`` little-endian bytes (the
    resident u24 layout; a view of ``ids``)."""
    return ids.contiguous().view(torch.uint8).view(-1, 4)[:, :3]


def _extent_reader(path: str, batch: int, n: int):
    """Raw u64 extent reader.  Each read opens its own handle, so N feed
    workers read concurrently; it never reads past ``n`` (a
    ``limit_refs`` prefix must not compact addresses it masks out)."""
    def read_raw(b):
        with open(path, "rb") as f:
            f.seek(b * batch * 8)
            return np.fromfile(f, dtype="<u8",
                               count=min(batch, n - b * batch))
    return read_raw


def _compact_stage(comp, shift: int, precompacted: bool, snapshot: bool):
    """Raw addresses -> ``(dense ids, table size, compactor snapshot)``
    (stateful: feed pools run it in stream order).  The snapshot rides
    with the batch, so a checkpoint records the state consistent with what
    the consumer has processed while producers run ahead."""
    def compact_batch(b, raw):
        ids = comp.map_raw(raw, 0 if precompacted else shift)
        if ids is None:
            lines = raw.astype(np.int64) if precompacted \
                else raw.astype(np.int64) >> shift
            ids = comp.map(lines)
        return ids, comp.next_free, comp.snapshot() if snapshot else None
    return compact_batch


def _segmented_batch(last_pos, hist, base: int, ids, n_valid: int, pdt,
                     hist_fn) -> None:
    """One whole batch as one segmented extraction: positions are the
    stream order itself, so a stable sort on the line key realizes the
    (line, pos) order.  Padding is always the stream tail, so validity is
    ``pos < n_valid``.  ``last_pos`` and ``hist`` advance in place."""
    pos = torch.arange(base, base + ids.shape[0], dtype=pdt,
                       device=ids.device)
    ev = batch_events(ids, pos, pos < n_valid, last_pos)
    hist += event_histogram(ev, hist_fn=hist_fn)


def _scan_batch(last_pos, hist, base: int, ids, n_valid: int, pdt, hist_fn,
                *, window: int) -> None:
    """The legacy per-window scan of one batch (the JAX package's
    ``_scan_batch``, its A/B reference for :func:`_segmented_batch`): each
    ``window`` slice is sorted on its own (one stable sort on the line
    key), resolved against ``last_pos`` and binned, one histogram per
    window.  Reuse gaps do not depend on how the stream is cut, so the
    histogram equals the segmented batch's."""
    for lo in range(0, ids.shape[0], window):
        pos = torch.arange(base + lo, base + lo + window, dtype=pdt,
                           device=ids.device)
        ev = batch_events(ids[lo:lo + window], pos, pos < n_valid, last_pos)
        hist += event_histogram(ev, hist_fn=hist_fn)


def _batch_fn(segmented: bool | None, window: int):
    """The per-batch step: the segmented batch (``segmented`` None, the
    default, or True) or the legacy per-window scan (False)."""
    if segmented is None or segmented:
        return _segmented_batch
    return functools.partial(_scan_batch, window=window)


def replay(addrs: np.ndarray, cls: int = 64, window: int = TRACE_WINDOW,
           precompacted: bool = False, batch_windows: int | None = None,
           segmented: bool | None = None, *, device=None,
           _kernels: TraceKernels = KERNELS) -> ReplayResult:
    """Replay an in-memory address stream into a reuse histogram, on
    ``device`` (default: the CUDA card).

    ``addrs``: 1-D array of byte addresses (or dense line ids when
    ``precompacted``).  ``segmented=False`` takes the legacy per-window
    scan.
    """
    dev = resolve_device(device)
    addrs = np.asarray(addrs)
    if addrs.ndim != 1:
        raise ValueError("trace must be a 1-D address stream")
    n = addrs.shape[0]
    if n == 0:
        return ReplayResult(np.zeros(NBINS, np.int64), 0, 0)
    lines = addrs.astype(np.int64) if precompacted else lines_of(addrs, cls)
    ids, n_lines = _compact(lines, window)
    return _replay_ids(ids, n_lines, n, window, batch_windows, dev,
                       _kernels.histogram, _batch_fn(segmented, window))


def _compact(lines: np.ndarray, window: int) -> tuple[np.ndarray, int]:
    """Dense int32 ids + table size for a whole line array: the offset
    is the id when the lines span less than 2^24, else cluster probing."""
    lo_line, hi_line = int(lines.min()), int(lines.max())
    if hi_line - lo_line < 1 << 24:
        return (lines - lo_line).astype(np.int32), hi_line - lo_line + 1
    comp = _Compactor()
    ids = np.empty(len(lines), np.int32)
    for lo in range(0, len(lines), window):
        ids[lo:lo + window] = comp.map(lines[lo:lo + window])
    return ids, comp.next_free


class _Compactor:
    """Incremental cluster-probing line -> dense-id table.

    Real traces touch a few contiguous memory regions, so each chunk is
    probed against the discovered cluster table (one searchsorted over a
    few clusters) and only the misses are sorted.  A new cluster reserves
    ``slack`` id slots past its observed end so right-growth keeps
    assigned ids stable; ``next_free`` counts allocated table slots.
    While the table holds one cluster, :meth:`map_raw` maps a raw batch
    in one native pass (:func:`pluss_torch.native.line_mapper`).
    """

    def __init__(self, slack: int = 1024):
        self.slack = slack
        self.starts = np.empty(0, np.int64)   # cluster start line, sorted
        self.widths = np.empty(0, np.int64)   # id slots allocated
        self.bases = np.empty(0, np.int64)    # cluster's first id
        self.next_free = 0

    def snapshot(self) -> dict:
        """JSON-able state for checkpoint/resume: a resumed stream maps
        every line to the identical dense id."""
        return {"slack": self.slack, "starts": self.starts.tolist(),
                "widths": self.widths.tolist(), "bases": self.bases.tolist(),
                "next_free": int(self.next_free)}

    @classmethod
    def restore(cls, snap: dict) -> "_Compactor":
        comp = cls(slack=int(snap["slack"]))
        comp.starts = np.asarray(snap["starts"], np.int64)
        comp.widths = np.asarray(snap["widths"], np.int64)
        comp.bases = np.asarray(snap["bases"], np.int64)
        comp.next_free = int(snap["next_free"])
        return comp

    def map_raw(self, raw: np.ndarray, shift: int) -> np.ndarray | None:
        """u64 byte addresses (``shift`` = log2 of the line size; 0 for
        precompacted line ids) -> int32 ids in one native pass, while the
        table holds a single cluster that covers the whole chunk.  None
        otherwise: the caller maps ``raw >> shift`` with :meth:`map`,
        which also discovers new clusters.  The first call builds the
        native library, and a failed build raises."""
        if len(self.starts) != 1:
            return None
        from pluss_torch import native

        return native.line_mapper()(raw, shift, int(self.starts[0]),
                                    int(self.widths[0]), int(self.bases[0]))

    def _map_into(self, chunk, out):
        cl = np.searchsorted(self.starts, chunk, side="right") - 1
        clc = np.maximum(cl, 0)
        inside = (cl >= 0) & (chunk < self.starts[clc] + self.widths[clc])
        out[inside] = (self.bases[clc] + (chunk - self.starts[clc]))[inside]
        return inside

    def map(self, chunk: np.ndarray) -> np.ndarray:
        """Dense int32 ids of one chunk of line numbers (grows the table)."""
        if len(self.starts) == 1:
            # one discovered region (the common case once the working set
            # is known): containment is a min/max check and the mapping
            # one vectorized subtract
            s0 = int(self.starts[0])
            if int(chunk.min()) >= s0 \
                    and int(chunk.max()) < s0 + int(self.widths[0]):
                return (chunk - (s0 - int(self.bases[0]))).astype(np.int32)
        out = np.empty(len(chunk), np.int32)
        inside = self._map_into(chunk, out) if len(self.starts) else \
            np.zeros(len(chunk), bool)
        miss = chunk[~inside]
        if not miss.size:
            return out
        mu = np.unique(miss)
        brk = np.nonzero(np.diff(mu) > self.slack)[0] + 1
        seg_s = mu[np.concatenate([[0], brk])]
        seg_e = mu[np.concatenate([brk - 1, [len(mu) - 1]])]
        for s, e in zip(seg_s.tolist(), seg_e.tolist()):
            # clamp the slack so cluster ranges never overlap the next one
            j = np.searchsorted(self.starts, s, side="right")
            limit = int(self.starts[j]) if j < len(self.starts) else None
            w = e - s + 1 + self.slack
            if limit is not None:
                w = min(w, limit - s)
            self.starts = np.insert(self.starts, j, s)
            self.widths = np.insert(self.widths, j, w)
            self.bases = np.insert(self.bases, j, self.next_free)
            self.next_free += w
        sub = np.empty(miss.size, np.int32)
        if not self._map_into(miss, sub).all():
            raise RuntimeError("trace compactor left lines unmapped")
        out[~inside] = sub
        if self.next_free >= 1 << 31:
            raise RuntimeError(
                "trace line-id space exhausted; lines too fragmented for "
                "cluster compaction")
        return out


def _pos_dtype(n_batches: int, batch: int, clock0: int = 0) -> torch.dtype:
    """int32 positions while every padded position (from ``clock0`` on)
    fits; int64 past."""
    return torch.int32 if clock0 + n_batches * batch < 2**31 - 2 \
        else torch.int64


def _replay_ids(ids: np.ndarray, n_lines: int, n: int, window: int,
                batch_windows: int | None, dev: torch.device,
                hist_fn, batch_fn) -> ReplayResult:
    """Stream dense line ids through the device in fixed-shape batches."""
    bw = _resolve_bw(batch_windows, dev)
    batch = bw * window
    n_batches = -(-n // batch)
    pdt = _pos_dtype(n_batches, batch)
    last_pos = torch.full((n_lines + 1,), -1, dtype=pdt, device=dev)
    hist = torch.zeros(NBINS, dtype=torch.int64, device=dev)
    for b in range(n_batches):
        lo = b * batch
        chunk = ids[lo:lo + batch]
        pad = batch - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.zeros(pad, np.int32)])
        batch_fn(last_pos, hist, lo, torch.from_numpy(chunk).to(dev), n, pdt,
                 hist_fn)
    return ReplayResult(hist.cpu().numpy(), n, n_lines)


def _trace_fingerprint(path: str) -> str:
    """Content identity of a trace file: sha256 of its first 1 MB (binds a
    checkpoint to the file, not just its length)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        h.update(f.read(1 << 20))
    return h.hexdigest()[:16]


def _ckpt_save(path: str, b_next: int, n: int, window: int, cls: int,
               precompacted: bool, fp: str, last_pos: np.ndarray,
               capacity: int, hist: np.ndarray, comp_snap: dict,
               batch_windows: int, wirefmt: str) -> None:
    """Atomic replay checkpoint, field for field the JAX package's
    (``pluss/trace.py:_ckpt_save``), so either package resumes the
    other's: the live prefix of ``last_pos`` (the compactor's
    ``next_free`` slots; the rest of the ``capacity`` slots are -1), the
    histogram in the position dtype, the compactor's id table, the next
    batch, and the run identity (n, window, cls, precompacted, batch
    windows, wire and the file's fingerprint)."""
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    np.savez(tmp,
             last_pos=last_pos,
             capacity=np.int64(capacity),
             hist=hist,
             b_next=np.int64(b_next), n=np.int64(n),
             window=np.int64(window), cls=np.int64(cls),
             bw=np.int64(batch_windows),
             precompacted=np.int64(bool(precompacted)),
             fp=np.frombuffer(fp.encode(), np.uint8),
             wirefmt=np.frombuffer(wirefmt.encode(), np.uint8),
             comp=np.frombuffer(json.dumps(comp_snap).encode(), np.uint8))
    os.replace(tmp, path)


def _ckpt_load(path: str, n: int, window: int, cls: int,
               precompacted: bool, fp: str, batch_windows: int,
               wirefmt: str):
    """``(b_next, last_pos, hist, comp)`` from a checkpoint, or None when
    it is absent or describes a different run.  ``last_pos`` comes back at
    full capacity.  A checkpoint that fails to load is quarantined and the
    run starts fresh: the source trace is intact, so it costs a recompute,
    never the run."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            if "bw" not in z.files or "capacity" not in z.files \
                    or "wirefmt" not in z.files:
                print(f"trace: checkpoint {path} is from an older layout; "
                      "starting fresh", file=sys.stderr)
                return None
            ident = (int(z["n"]), int(z["window"]), int(z["cls"]),
                     int(z["precompacted"]), bytes(z["fp"]).decode(),
                     int(z["bw"]), bytes(z["wirefmt"]).decode())
            if ident != (n, window, cls, int(bool(precompacted)), fp,
                         batch_windows, wirefmt):
                print(f"trace: checkpoint {path} is for a different run "
                      f"(n, window, cls, precompacted, file, bw, "
                      f"wire)={ident}; starting fresh", file=sys.stderr)
                return None
            comp = _Compactor.restore(json.loads(bytes(z["comp"]).decode()))
            lp = z["last_pos"]
            cap = int(z["capacity"])
            if lp.shape[0] < cap:   # re-pad the saved live prefix
                lp = np.concatenate(
                    [lp, np.full((cap - lp.shape[0],), -1, lp.dtype)])
            return int(z["b_next"]), lp, z["hist"], comp
    except Exception as e:  # noqa: BLE001 — any unreadable checkpoint
        quarantine_artifact(path, "trace replay-checkpoint", e,
                            action="starting fresh")
        return None


def _to_device_ids(w, dev: torch.device, batch: int, decode) -> torch.Tensor:
    """One wire item -> int32 ``[batch]`` ids on ``dev``.  Host arrays go
    through pinned memory with an asynchronous copy when ``dev`` is a card
    (the caching host allocator keeps a pinned block until its copy is
    done); the d24v wire decodes on the device."""
    def put(a: np.ndarray) -> torch.Tensor:
        if a.dtype == np.uint16:
            a = a.view(np.int16)     # widened back with a 16-bit mask
        t = torch.from_numpy(a)
        if dev.type == "cpu":
            return t
        return t.pin_memory().to(dev, non_blocking=True)

    if isinstance(w, _WireD24V):
        return decode(put(w.payload), put(w.wm))[:batch]
    return _widen_ids(put(w))


def replay_file(path: str, fmt: str = "u64", cls: int = 64,
                window: int | None = None, precompacted: bool = False,
                initial_capacity: int = 1 << 20,
                limit_refs: int | None = None,
                deadline_s: float | None = None,
                checkpoint_path: str | None = None,
                checkpoint_every: int = 16,
                resume: bool = False,
                batch_windows: int | None = None,
                queue_depth: int | None = None,
                feed_workers: int | None = None,
                wire: str | None = None,
                stage_depth: int | None = None,
                segmented: bool | None = None,
                resident_cache: bool | None = None,
                *, device=None,
                _kernels: TraceKernels = KERNELS) -> ReplayResult:
    """Replay a trace FILE in bounded host memory, on ``device`` (default:
    the CUDA card; ``"cpu"`` for the host).

    ``fmt``: ``u64`` (packed little-endian byte addresses, streamed) or
    ``text`` (one address per line, replayed in memory).  The stream goes
    to the device in batches of ``batch_windows * window`` refs (2^24 at
    the defaults); the device line table starts at ``initial_capacity``
    ids and doubles as the compactor discovers the working set.

    Feed: ``feed_workers`` threads read, compact (in stream order) and
    wire-encode batches; ``queue_depth`` bounds the single reader's queue
    and, with the workers, the pool's in-flight batches; ``stage_depth``
    batches are copied (and decoded) ahead of the one being processed.
    ``wire``: ``pack``, ``d24v`` or ``auto``/None (d24v on the card, pack
    on the CPU); it does not change the histogram.

    ``limit_refs`` replays a prefix.  ``deadline_s`` stops cleanly after
    the batch in flight once the wall clock passes it (``total_count``
    says how far the replay got).  ``checkpoint_path`` + ``resume``: every
    ``checkpoint_every`` batches the carries, the compactor's id table and
    the stream position are saved atomically; ``resume=True`` continues
    from the checkpoint, equal to an uninterrupted run.  A checkpoint of a
    different run identity is ignored with a notice.  The defaults are the
    JAX package's accelerator defaults on the card and its CPU defaults on
    the CPU.  ``segmented=False`` takes the legacy per-window scan.

    ``resident_cache=True`` rides the residency store
    (:mod:`pluss_torch.residency`): a hit replays the resident copy through
    :func:`replay_staged`, with no feed, no copy and no decode
    (``timing["resident"] == "hit"``); a miss reserves room for the u24
    copy and accumulates every staged batch into it while streaming,
    byte for byte what :func:`stage_resident` makes of the pack, and
    publishes it when the stream ran to its end (``"stage_through"``).
    A budget that cannot hold it streams plainly (``"fallback"``), and a
    table past 2^24 lines abandons the copy (``"abandoned"``).
    Checkpointed, resumed and ``deadline_s``-truncated runs never touch
    the store.  None or False keeps the store out of the path.
    """
    dev = resolve_device(device)
    window = _resolve_window(window, dev)
    if fmt == "text":  # line-oriented; no random access worth streaming
        return replay(load_trace(path, fmt), cls, window,
                      precompacted=precompacted, batch_windows=batch_windows,
                      segmented=segmented, device=dev, _kernels=_kernels)
    if fmt != "u64":
        raise ValueError(f"unknown trace format {fmt!r}")
    if resident_cache is not None and not isinstance(resident_cache, bool):
        raise ValueError(
            f"resident_cache must be a bool or None, got {resident_cache!r}")
    n = _u64_count(path)
    if limit_refs is not None:
        n = min(n, limit_refs)
    if n == 0:
        return ReplayResult(np.zeros(NBINS, np.int64), 0, 0)
    if cls & (cls - 1):
        raise ValueError(f"cache line size {cls} is not a power of two")
    shift = int(cls).bit_length() - 1
    bw = _resolve_bw(batch_windows, dev)
    batch = bw * window
    n_batches = -(-n // batch)
    pdt = _pos_dtype(n_batches, batch)
    np_pdt = np.int32 if pdt == torch.int32 else np.int64
    wirefmt = _resolve_wire(wire, dev)
    workers = _resolve_feed_workers(feed_workers, dev)
    sd = _resolve_stage_depth(stage_depth, dev)
    qd = _resolve_queue_depth(queue_depth, dev)
    batch_fn = _batch_fn(segmented, window)

    # a checkpointed or resumed run enters mid-stream, so its staging
    # would be partial: the store stays out of its path
    store = key = None
    if resident_cache and checkpoint_path is None and not resume:
        store = residency.store()
        key = _residency_key(path, cls=cls, window=window, bw=bw,
                             precompacted=precompacted, device=dev)
        ent = store.lookup_pin(key, n_run=n)
        if ent is not None:
            t0 = time.perf_counter()
            try:
                rep = replay_staged(ent.value, ent.n_lines, ent.n_run, window,
                                    segmented=segmented, _kernels=_kernels)
            finally:
                store.unpin(key)
            rep.timing.update(resident="hit", h2d_bytes=0, read_s=0.0,
                              compact_s=0.0, encode_s=0.0,
                              wall_s=time.perf_counter() - t0)
            return rep

    b0 = 0
    comp = _Compactor()
    fp = _trace_fingerprint(path) if checkpoint_path else ""
    ck = _ckpt_load(checkpoint_path, n, window, cls, precompacted, fp, bw,
                    wirefmt) if resume and checkpoint_path else None
    if ck is not None:
        b0, ck_last_pos, ck_hist, comp = ck
        print(f"trace: resuming from checkpoint at batch {b0}/{n_batches} "
              f"({min(n, b0 * batch)} refs already replayed)",
              file=sys.stderr)
        if b0 >= n_batches:   # the checkpoint covers the whole stream
            return ReplayResult(np.asarray(ck_hist, np.int64), n,
                                comp.next_free, wire=wirefmt,
                                feed_workers=workers)

    read_raw = _extent_reader(path, batch, n)
    compact_batch = _compact_stage(comp, shift, precompacted,
                                   snapshot=bool(checkpoint_path))
    # seconds per feed stage of the single-reader paths
    stage_s = {"read_s": 0.0, "compact_s": 0.0, "encode_s": 0.0}

    def encode_batch(b, mid):
        """Pad to the fixed batch shape and wire-encode (independent per
        extent, so pool workers run it in parallel)."""
        ids, n_lines_b, snap_b = mid
        pad = batch - len(ids)
        if pad:
            ids = np.concatenate([ids, np.zeros(pad, np.int32)])
        return _encode_wire(ids, n_lines_b, wirefmt), n_lines_b, snap_b

    def batches():
        """Single-reader feed: the same three stages in one thread, in
        order."""
        for b in range(b0, n_batches):
            faults.check("trace.read_batch")  # chaos injection site
            t1 = time.perf_counter()
            raw = read_raw(b)
            t2 = time.perf_counter()
            mid = compact_batch(b, raw)
            t3 = time.perf_counter()
            item = encode_batch(b, mid)
            stage_s["read_s"] += t2 - t1
            stage_s["compact_s"] += t3 - t2
            stage_s["encode_s"] += time.perf_counter() - t3
            yield item

    if workers > 1:
        src = _FeedPool(b0, n_batches,
                        lambda b: faults.check("trace.read_batch"),
                        read_raw, compact_batch, encode_batch, workers, qd)
    else:
        src = _threaded(batches, depth=qd)

    t0 = time.perf_counter()
    if ck is not None:
        capacity = len(ck_last_pos)
        last_pos = torch.full((capacity + 1,), -1, dtype=pdt, device=dev)
        last_pos[:capacity] = torch.from_numpy(
            ck_last_pos.astype(np_pdt)).to(dev)
        hist = torch.from_numpy(np.asarray(ck_hist, np.int64)).to(dev)
        n_lines = comp.next_free
        done = min(n, b0 * batch)
    else:
        capacity = int(initial_capacity)
        last_pos = torch.full((capacity + 1,), -1, dtype=pdt, device=dev)
        hist = torch.zeros(NBINS, dtype=torch.int64, device=dev)
        n_lines = 0
        done = 0
    done0 = done   # checkpoint-restored refs: not this run's work

    # the main thread is, at any instant, in one of these buckets
    st = {"prefetch_stall_s": 0.0, "h2d_s": 0.0, "device_s": 0.0,
          "ckpt_save_s": 0.0, "grow_s": 0.0}
    st_n = {"h2d_bytes": 0, "batches": 0, "ckpt_saves": 0, "growths": 0}
    # the int32 ids the kernels read per staged batch (the wire-vs-device
    # byte ratio of `stats` reads off it; a counter only, not in timing)
    device_bytes = 0
    cuda = dev.type == "cuda"
    main = torch.cuda.current_stream(dev) if cuda else None
    side = torch.cuda.Stream(dev) if cuda else None

    # stage-through: the u24 copy of every batch, for the store
    acc = resident = None
    if store is not None:
        try:
            store.reserve(n_batches * batch * 3)
            acc = torch.zeros((n_batches, bw, window, 3), dtype=torch.uint8,
                              device=dev)
            resident = "stage_through"
        except ResourceExhausted:
            resident = "fallback"

    def stage(item):
        """Start one batch's copy (and d24v decode) on the side stream
        now; the main stream waits for its event before using the ids."""
        w, n_lines_b, snap_b = item
        nbytes = w.payload.nbytes + w.wm.nbytes \
            if isinstance(w, _WireD24V) else w.nbytes
        if not cuda:
            return (_to_device_ids(w, dev, batch, _kernels.decode), None,
                    n_lines_b, snap_b, nbytes)
        with torch.cuda.stream(side):
            ids = _to_device_ids(w, dev, batch, _kernels.decode)
            ready = torch.cuda.Event()
            ready.record(side)
        # made on the side stream, used on the main one: the allocator
        # must not reuse its memory before the main stream is done with it
        ids.record_stream(main)
        return ids, ready, n_lines_b, snap_b, nbytes

    with xprof.session(), obs.span(
            "trace.replay_file", refs=n, window=window, batch_windows=bw,
            resume_batch=b0, feed_workers=workers, wire=wirefmt) as sp, \
            src as it:
        # read inside the session: a profiled replay arms one
        obs_on = obs.enabled()
        stream = iter(it)
        pending: deque = deque()
        exhausted = False
        feed_err: BaseException | None = None
        truncated = False

        def pump():
            """Refill the staged-ahead pipeline to ``stage_depth``
            batches.  A feed error is held, not raised: batches already
            staged are processed (and checkpointed) first."""
            nonlocal exhausted, feed_err, device_bytes
            while not exhausted and len(pending) < sd:
                t1 = time.perf_counter()
                try:
                    item = next(stream, None)
                except BaseException as e:
                    feed_err = e
                    exhausted = True
                    st["prefetch_stall_s"] += time.perf_counter() - t1
                    break
                t2 = time.perf_counter()
                st["prefetch_stall_s"] += t2 - t1
                if item is None:
                    exhausted = True
                    break
                out = stage(item)
                st["h2d_s"] += time.perf_counter() - t2
                st_n["h2d_bytes"] += out[4]
                device_bytes += batch * 4
                pending.append(out)

        try:
            pump()
            b = b0
            while pending:
                ids_dev, ready, n_lines, snap, _ = pending.popleft()
                if n_lines > capacity:
                    # the compactor's host-side table size says when to grow:
                    # no device value is read
                    tg = time.perf_counter()
                    old = capacity
                    while capacity < n_lines:
                        capacity *= 2
                    grown = torch.full((capacity + 1,), -1, dtype=pdt,
                                       device=dev)
                    grown[:old] = last_pos[:old]
                    last_pos = grown
                    st["grow_s"] += time.perf_counter() - tg
                    st_n["growths"] += 1
                td = time.perf_counter()
                if ready is not None:
                    main.wait_event(ready)
                if acc is not None:
                    if n_lines >= 1 << 24:
                        # the ids no longer fit the 3-byte layout
                        acc = None
                        resident = "abandoned"
                        obs.counter_add("residency.fallback")
                    else:
                        acc[b].view(batch, 3).copy_(_u24_bytes(ids_dev))
                with obs.tally_span("trace.batch"):
                    batch_fn(last_pos, hist, b * batch, ids_dev, n, pdt,
                             _kernels.histogram)
                del ids_dev
                st["device_s"] += time.perf_counter() - td
                st_n["batches"] += 1
                if obs_on:
                    obs.gauge_set("trace.queue_occupancy", it.qsize())
                    if isinstance(it, _FeedPool):
                        obs.gauge_set("trace.feed_workers_busy", it.busy)
                done = min(n, (b + 1) * batch)
                if checkpoint_path and done < n \
                        and (b + 1 - b0) % checkpoint_every == 0:
                    # the copy to the host waits for the device: the price of
                    # a durable point, amortized by checkpoint_every.  It runs
                    # before the next prefetch, so a feed fault in batch b+1
                    # never costs batch b's durable point.
                    tc = time.perf_counter()
                    live = min(int(snap["next_free"]), capacity)
                    _ckpt_save(checkpoint_path, b + 1, n, window, cls,
                               precompacted, fp,
                               last_pos[:live].cpu().numpy(), capacity,
                               hist.cpu().numpy().astype(np_pdt), snap, bw,
                               wirefmt)
                    st["ckpt_save_s"] += time.perf_counter() - tc
                    st_n["ckpt_saves"] += 1
                # the unsynced clock runs every batch; the device sync that
                # makes it real is paid only once it is over, so a fast run
                # never syncs and a slow one overshoots by one batch at most
                if deadline_s is not None and done < n \
                        and time.perf_counter() - t0 > deadline_s:
                    ts = time.perf_counter()
                    if cuda:
                        torch.cuda.synchronize(dev)
                    st["device_s"] += time.perf_counter() - ts
                    if time.perf_counter() - t0 > deadline_s:
                        if obs_on:
                            obs.event("trace.deadline_truncated", done=done,
                                      refs=n)
                        truncated = True
                        break
                pump()
                b += 1
            if feed_err is not None and not truncated:
                # every staged batch has been processed and checkpointed; now
                # the held feed error surfaces
                raise feed_err
            # the copy to the host waits for every outstanding launch: that
            # wait is device time
            td = time.perf_counter()
            hist_np = hist.cpu().numpy()
            st["device_s"] += time.perf_counter() - td
        finally:
            # recorded even when the replay aborts mid-stream (an injected
            # DataLoss, a real read failure): the partial run's breakdown
            # is what the post-mortem wants to see
            if obs_on:
                for k, v in {**st, **st_n}.items():
                    obs.counter_add(f"trace.{k}", v)
                obs.counter_add("trace.device_bytes", device_bytes)
                # encode seconds run beside the main thread's buckets (the
                # pool's workers): a counter of their own, not a bucket
                feed = it.stage_s if isinstance(it, _FeedPool) else stage_s
                obs.counter_add("trace.wire_encode_s", feed["encode_s"])
                # only the refs this run replayed: a resumed run's span
                # covers the tail after its checkpoint
                obs.counter_add("trace.refs_replayed", done - done0)
                sp.set(refs_replayed=done - done0, stream_done=done,
                       n_lines=n_lines)
                obs.flush_metrics()
    if checkpoint_path and done >= n:
        # a finished run retires its checkpoint: a later, different run
        # must not resume from this one's final state
        with contextlib.suppress(OSError):
            os.unlink(checkpoint_path)
    if acc is not None:
        if done >= n and not truncated:
            # the whole stream went through: the copy is the whole trace
            store.put(key, acc, n_lines=n_lines, n_run=n, nbytes=acc.nbytes,
                      meta={"path": path, "stage_through": True})
            obs.counter_add("residency.stage_through")
            obs.trace_event("residency.stage_through",
                            nbytes=int(acc.nbytes))
        else:
            resident = "truncated"
    feed = it.stage_s if isinstance(it, _FeedPool) else stage_s
    return ReplayResult(hist_np, done, n_lines, wire=wirefmt,
                        feed_workers=workers,
                        timing={**st, **st_n, **feed,
                                **({"resident": resident} if resident
                                   else {}),
                                "wall_s": time.perf_counter() - t0})


def _u64_count(path: str) -> int:
    """Record count of a packed-u64 trace, rejecting a truncated file (a
    byte length that is not a multiple of 8) as :class:`DataLoss` naming
    the offset."""
    size = os.path.getsize(path)
    if size % 8:
        raise DataLoss(
            f"truncated u64 trace {path}: {size} bytes is not a multiple "
            f"of 8 ({size % 8} trailing bytes after the last whole record "
            f"at byte offset {size - size % 8})", site="trace.load")
    return size // 8


def load_trace(path: str, fmt: str = "u64") -> np.ndarray:
    """Load a whole trace file: ``u64`` (packed little-endian uint64 byte
    addresses) or ``text`` (one address per line, decimal or 0x-hex).
    Malformed input raises :class:`DataLoss` naming the byte offset or
    line number."""
    if fmt == "u64":
        _u64_count(path)
        return np.fromfile(path, dtype="<u8").astype(np.int64)
    if fmt == "text":
        out = []
        with open(path) as f:
            for lineno, s in enumerate(f, 1):
                s = s.strip()
                if not s:
                    continue
                try:
                    out.append(int(s, 0))
                except ValueError:
                    raise DataLoss(
                        f"garbage text-trace line {lineno} of {path}: "
                        f"{s[:40]!r} is neither decimal nor 0x-hex",
                        site="trace.load") from None
        return np.asarray(out, np.int64)
    raise ValueError(f"unknown trace format {fmt!r}")


# --- packed traces ---------------------------------------------------------

def pack_file(path: str, out_path: str, cls: int = 64,
              window: int = TRACE_WINDOW, precompacted: bool = False,
              limit_refs: int | None = None,
              resume: bool = False, _wide: bool = False,
              batch_windows: int | None = None,
              feed_workers: int | None = None,
              wire: str | None = None) -> dict:
    """Compact and encode a raw u64 trace once, into the replay's packed
    wire (``out_path``) and a JSON sidecar (``out_path + '.json'``);
    returns the sidecar dict.  Both files are byte for byte the JAX
    package's (``pluss.trace.pack_file``), so either package stages the
    other's packs.

    The stream goes through the same feed as :func:`replay_file` (the
    ``feed_workers`` pool, the compactor under its stream-order turnstile,
    the native mapper while the table holds one cluster).  Formats:

    - ``u24`` (3 bytes per ref) while the id table stays under 2^24 lines.
      The final table size is unknown mid-stream, so the 3-byte format is
      written first and the pack restarts as ``i32`` (4 little-endian
      bytes per ref) the moment the table reaches 2^24.
    - ``wire='d24v'``: per-batch records ``u32 used | width map |
      payload[:used]`` of the compressed wire, with the records' offsets
      and the ``batch`` they were cut at in the sidecar (staging must
      slice at the same grid).  Batches are capped at ``_D24V_MAX_BATCH``
      refs.  ``auto``/``pack``/None write the fixed-width formats.

    The sidecar holds ``n``, ``n_lines``, ``fmt``, ``src_fp`` (the source's
    fingerprint) and ``wire`` (:data:`WIRE_VERSION`); it is written
    atomically.  Progress journals to ``out_path + '.journal'`` after each
    flushed batch (:class:`pluss_torch.resilience.journal.Journal`: the
    output offset and the compactor's table); ``resume=True`` truncates
    the partial ``out_path + '.tmp'`` to the last journaled batch and
    continues, equal to an uninterrupted pack.  The journal records the format, so a resumed
    pack stays in it (an i32 restart stays i32, a d24v pack stays d24v).
    """
    n = _u64_count(path)
    if limit_refs is not None:
        n = min(n, limit_refs)
    if cls & (cls - 1):
        raise ValueError(f"cache line size {cls} is not a power of two")
    if wire is not None and wire not in WIRE_CHOICES:
        raise ValueError(f"unknown wire format {wire!r} (choices: "
                         f"{', '.join(WIRE_CHOICES)})")
    workers = _resolve_feed_workers(feed_workers, None, _host_workers())
    shift = int(cls).bit_length() - 1
    bw = _resolve_bw(batch_windows)
    window = _resolve_window(window)
    batch = bw * window
    if wire == "d24v" and batch > _D24V_MAX_BATCH:
        # the decode's bit offsets are 32-bit: a record past the cap
        # would not stage, so refuse it now
        raise ValueError(
            f"d24v records cap at {_D24V_MAX_BATCH} refs/batch (int32 "
            f"decode offsets); batch_windows*window = {batch}: reduce the "
            "batch or pack with wire='pack'")
    n_batches = -(-n // batch)
    comp = _Compactor()
    tmp = out_path + ".tmp"
    jpath = out_path + ".journal"
    b0 = 0
    fp = _trace_fingerprint(path)
    fmt = "i32" if _wide else ("d24v" if wire == "d24v" else "u24")
    offsets: list[int] = []   # d24v record offsets (sidecar, for staging)
    if resume and not _wide and os.path.exists(jpath):
        rec0 = Journal(jpath).get({"batch": 0})
        if rec0 is not None and rec0.get("fmt") == "i32":
            # the interrupted pack had restarted in the wide format:
            # resume in it
            return pack_file(path, out_path, cls, window, precompacted,
                             limit_refs, resume=True, _wide=True,
                             batch_windows=bw, feed_workers=workers)
        if rec0 is not None and rec0.get("fmt") == "d24v" \
                and wire in (None, "auto"):
            # a d24v pack resumed without wire='d24v' stays d24v (an
            # explicit wire='pack' is another identity: a fresh pack)
            fmt = "d24v"
    if resume and os.path.exists(jpath) and os.path.exists(tmp):
        jr = Journal(jpath)
        best = None
        # journal batch indices count bw-sized batches: bw is identity
        ident = {"n": n, "window": window, "cls": cls,
                 "precompacted": bool(precompacted), "fp": fp, "fmt": fmt,
                 "bw": bw}
        out_bytes_seen: list[int] = []   # out_bytes after batch j
        for b in range(n_batches):
            rec = jr.get({"batch": b})
            if rec is None:
                break
            if any(rec.get(k) != v for k, v in ident.items()):
                best = None   # a journal of another pack
                out_bytes_seen = []
                break
            best = rec
            out_bytes_seen.append(rec["out_bytes"])
        if best is not None and os.path.getsize(tmp) < best["out_bytes"]:
            # the journal outlived the bytes it describes: walk back to
            # the last batch whose bytes are on disk (truncating forward
            # would zero-extend the stream)
            size = os.path.getsize(tmp)
            while best is not None and best["out_bytes"] > size:
                b_prev = best["key"]["batch"] - 1
                best = jr.get({"batch": b_prev}) if b_prev >= 0 else None
        if best is not None:
            b0 = best["key"]["batch"] + 1
            comp = _Compactor.restore(best["comp"])
            offsets = [0] + out_bytes_seen[:b0 - 1]
            with open(tmp, "r+b") as out:
                out.truncate(best["out_bytes"])
            print(f"trace: resuming pack at batch {b0}/{n_batches} "
                  f"({best['out_bytes']} bytes already packed)",
                  file=sys.stderr)
    if b0 == 0:
        # a fresh start: a stale journal of an earlier pack must not
        # survive into a later resume's contiguity scan
        with contextlib.suppress(OSError):
            os.unlink(jpath)
        offsets = []
    journal = Journal(jpath)

    read_raw = _extent_reader(path, batch, n)
    compact_batch = _compact_stage(comp, shift, precompacted, snapshot=True)

    def encode_rec(b, mid):
        """The on-disk record of one batch (parallel across pool workers).
        A table of 2^24 lines or more is not encoded: the consumer
        restarts the pack in the wide format before writing."""
        ids, nl, snap = mid
        if not _wide and nl >= 1 << 24:
            return None, nl, snap
        if fmt == "d24v":
            payload, wm = wirecodec.encode_d24v(ids)
            used = wirecodec.used_bytes(wm)
            rec = (np.asarray([used], dtype="<u4"), wm, payload[:used])
        elif _wide:
            rec = (np.ascontiguousarray(ids, dtype="<i4"),)
        else:
            rec = (_pack24(ids),)
        return rec, nl, snap

    def items():
        for b in range(b0, n_batches):
            faults.check("trace.read_batch")  # chaos injection site
            yield encode_rec(b, compact_batch(b, read_raw(b)))

    if workers > 1:
        src = _FeedPool(b0, n_batches,
                        lambda b: faults.check("trace.read_batch"),
                        read_raw, compact_batch, encode_rec, workers,
                        depth=2)
    else:
        src = contextlib.nullcontext(items())
    with obs.span("trace.pack_file", refs=n, fmt=fmt, resume_batch=b0,
                  feed_workers=workers), \
            src as it, open(tmp, "r+b" if b0 else "wb") as out:
        out.seek(0, os.SEEK_END)
        for b, item in zip(range(b0, n_batches), it):
            rec, nl, snap = item
            if not _wide and nl >= 1 << 24:
                print(f"trace: line table overflowed 2^24 ids at batch {b}; "
                      "restarting the pack in the int32 wire format",
                      file=sys.stderr)
                for f in (jpath, tmp):
                    with contextlib.suppress(OSError):
                        os.unlink(f)
                return pack_file(path, out_path, cls, window, precompacted,
                                 limit_refs, _wide=True, batch_windows=bw,
                                 feed_workers=workers)
            if fmt == "d24v":
                offsets.append(out.tell())
            for arr in rec:
                arr.tofile(out)
            out.flush()
            # the data is durable before the journal line that promises it
            os.fsync(out.fileno())
            journal.record({"batch": b}, out_bytes=out.tell(), comp=snap,
                           n=n, window=window, cls=cls,
                           precompacted=bool(precompacted), fp=fp, fmt=fmt,
                           bw=bw)
    os.replace(tmp, out_path)
    meta = {"n": n, "n_lines": comp.next_free, "fmt": fmt, "src_fp": fp,
            "wire": WIRE_VERSION}
    if fmt == "d24v":
        # records are cut at the pack's batch: staging slices the same way
        meta["batch"] = batch
        meta["offsets"] = offsets
    # atomic sidecar: a reader sees the old meta or the new, never a torn
    # write
    sidecar_tmp = out_path + ".json.tmp"
    with open(sidecar_tmp, "w") as f:
        json.dump(meta, f)
    os.replace(sidecar_tmp, out_path + ".json")
    with contextlib.suppress(OSError):
        os.unlink(jpath)   # the pack is durable; the journal is spent
    obs.counter_add("trace.pack_refs", n)
    return meta


def pack_cached(path: str, packed_path: str | None = None, *,
                cls: int = 64, window: int = TRACE_WINDOW,
                precompacted: bool = False,
                limit_refs: int | None = None,
                batch_windows: int | None = None,
                feed_workers: int | None = None,
                wire: str = "d24v",
                allow_pack: bool = True) -> tuple[dict | None, bool, str]:
    """Disk pack cache: ``(sidecar meta, was_cached, packed path)``.

    Packs ``path`` with :func:`pack_file` once (into ``packed_path``,
    default ``path + '.pack'``) and reuses the pack while its sidecar
    matches the source: the ref count, the source fingerprint,
    :data:`WIRE_VERSION` and, for d24v, the batch grid.  Any mismatch
    repacks; a stale pack is never replayed.  ``allow_pack=False`` only
    probes: a fresh pack returns as usual, a missing or stale one returns
    ``(None, False, packed)`` without packing.
    """
    packed = packed_path if packed_path is not None else path + ".pack"
    sidecar = packed + ".json"
    n = _u64_count(path)
    if limit_refs is not None:
        n = min(n, limit_refs)
    bw = _resolve_bw(batch_windows)
    if os.path.exists(packed) and os.path.exists(sidecar):
        try:
            with open(sidecar) as f:
                meta = json.load(f)
        except ValueError:
            meta = {}
        # d24v packs stage only at their own batch grid; the fixed-width
        # formats slice at any
        fmt_ok = meta.get("fmt") in ("u24", "i32") or (
            meta.get("fmt") == "d24v" and meta.get("batch") == bw * window)
        if meta.get("n") == n \
                and meta.get("src_fp") == _trace_fingerprint(path) \
                and meta.get("wire") == WIRE_VERSION and fmt_ok:
            return meta, True, packed
    if not allow_pack:
        return None, False, packed
    meta = pack_file(path, packed, cls=cls, window=window,
                     precompacted=precompacted, limit_refs=limit_refs,
                     batch_windows=bw, feed_workers=feed_workers, wire=wire)
    return meta, False, packed


# --- device-resident replay ------------------------------------------------

def _device_fingerprint(dev: torch.device) -> tuple:
    """``(type, index)`` of a torch device, the current card's index when
    ``dev`` names none."""
    if dev.type == "cuda" and dev.index is None:
        return ("cuda", torch.cuda.current_device())
    return (dev.type, dev.index)


def _residency_key(path: str, *, cls: int, window: int, bw: int,
                   precompacted: bool, device=None, devices=None) -> tuple:
    """Identity of one trace's resident staging: the file's content
    fingerprint and size, :data:`WIRE_VERSION`, the line size, window,
    batch grid, ``precompacted`` and the device (a sharded replay's
    grouped entry: its whole device list).  Any change misses the
    store.  The replayed prefix (``n_run``) is checked at lookup, not in
    the key, so one trace never holds two near-identical copies."""
    try:
        size = os.path.getsize(path)
    except OSError:
        size = -1
    if devices is not None:
        from pluss_torch.parallel.shard import device_fingerprint

        where = ("shard",) + device_fingerprint(devices)
    else:
        where = _device_fingerprint(resolve_device(device))
    return ("trace", _trace_fingerprint(path), size, WIRE_VERSION, int(cls),
            int(window), int(bw), bool(precompacted), where)


def ensure_resident(path: str, *, cls: int = 64, window: int = TRACE_WINDOW,
                    precompacted: bool = False,
                    limit_refs: int | None = None,
                    packed_path: str | None = None,
                    upload_budget_s: float | None = None,
                    batch_windows: int | None = None,
                    feed_workers: int | None = None,
                    wire: str = "d24v", device=None,
                    _kernels: TraceKernels = KERNELS) -> residency.Entry:
    """Pack (through the disk cache), stage and publish one trace into the
    residency store; returns its :class:`pluss_torch.residency.Entry`,
    from the store on a hit.  An ``upload_budget_s``-shrunk prefix comes
    back unpublished (``meta['published']`` False): the sidecar's
    ``n_lines`` is exact only for the whole pack, and a hit must equal the
    streamed run it stands for.  Raises :class:`ResourceExhausted` when
    the staged bytes can never fit the budget."""
    dev = resolve_device(device)
    st = residency.store()
    n_file = _u64_count(path)
    n_req = n_file if limit_refs is None else min(n_file, limit_refs)
    bw = _resolve_bw(batch_windows, dev)
    key = _residency_key(path, cls=cls, window=window, bw=bw,
                         precompacted=precompacted, device=dev)
    ent = st.lookup_pin(key, n_run=n_req)
    if ent is not None:
        st.unpin(key)
        return ent
    meta, _, packed = pack_cached(path, packed_path, cls=cls, window=window,
                                  precompacted=precompacted,
                                  limit_refs=limit_refs, batch_windows=bw,
                                  feed_workers=feed_workers, wire=wire)
    bpr = 4 if meta["fmt"] == "i32" else 3
    batch = bw * window
    st.reserve(-(-n_req // batch) * batch * bpr)
    staged, n_run, info = stage_resident(
        packed, meta, window, limit_refs=n_req,
        upload_budget_s=upload_budget_s, batch_windows=bw,
        feed_workers=feed_workers, device=dev, _kernels=_kernels)
    meta_e = {"path": path, "packed": packed, **info}
    if n_run == n_req:
        return st.put(key, staged, n_lines=meta["n_lines"], n_run=n_run,
                      nbytes=staged.nbytes,
                      meta={**meta_e, "published": True})
    # a budget-shrunk prefix: usable by the caller, never served from the
    # store (its exact line count is unknown)
    obs.counter_add("residency.fallback")
    return residency.Entry(key=key, value=staged, n_lines=meta["n_lines"],
                           n_run=n_run,
                           nbytes=0 if staged is None else staged.nbytes,
                           meta={**meta_e, "published": False})


def stage_resident(packed_path: str, meta: dict,
                   window: int = TRACE_WINDOW,
                   limit_refs: int | None = None,
                   upload_budget_s: float | None = None,
                   batch_windows: int | None = None,
                   feed_workers: int | None = None, *, device=None,
                   _kernels: TraceKernels = KERNELS):
    """Upload a packed trace into device memory.  Returns ``(resident,
    n_run, stats)``: the ``[n_batches, batch_windows, window, bpr]`` uint8
    tensor on ``device`` (default: the CUDA card; ``bpr`` 4 for ``i32``
    packs, else 3), the staged ref count (a prefix under
    ``upload_budget_s``) and ``{upload_s, upload_bytes}``.

    Fixed-width records are copied as they are, zero-padded to the batch.
    A d24v record crosses compressed and the decode kernel (kernel 3,
    ``_kernels.decode``) expands it on the device; its ids are then
    restacked into the u24 bytes (plain torch ops), so every format stages
    to the layout :func:`replay_staged` reads.  Reads run in the
    ``feed_workers`` pool.  A record cut short raises :class:`DataLoss`
    naming it.  ``upload_budget_s`` stops the upload at the first
    16-batch mark past it (the device is synced there, so the clock is
    real) and keeps the staged prefix.
    """
    dev = resolve_device(device)
    fmt = meta["fmt"]
    if fmt not in ("u24", "i32", "d24v"):
        raise ValueError(f"unknown packed trace format {fmt!r}")
    d24v = fmt == "d24v"
    bpr = 4 if fmt == "i32" else 3   # resident bytes per ref
    n = meta["n"] if limit_refs is None else min(meta["n"], limit_refs)
    if n == 0:
        return None, 0, {"upload_s": 0.0, "upload_bytes": 0}
    bw = _resolve_bw(batch_windows, dev)
    window = _resolve_window(window, dev)
    batch = bw * window
    n_batches = -(-n // batch)
    workers = _resolve_feed_workers(feed_workers, dev)
    if d24v and meta.get("batch") != batch:
        raise ValueError(
            f"d24v pack {packed_path} was cut at {meta.get('batch')} "
            f"refs/batch; this replay slices at {batch} (batch_windows * "
            "window): match the pack's batching or repack")
    offsets = meta.get("offsets")

    def read_fixed(b):
        """One fixed-width record (the caller zero-pads it)."""
        want = min(batch, n - b * batch) * bpr
        with open(packed_path, "rb") as f:
            f.seek(b * batch * bpr)
            raw = np.fromfile(f, dtype=np.uint8, count=want)
        if raw.size != want:
            raise DataLoss(
                f"truncated {fmt} pack {packed_path}: record {b} at byte "
                f"offset {b * batch * bpr} is cut short", site="trace.load")
        return raw, raw.size

    def read_d24v(b):
        """One compressed record (header | width map | payload), its
        payload padded for the decode kernel."""
        count = min(batch, meta["n"] - b * batch)
        nb_blocks = -(-count // wirecodec.BLOCK)
        with open(packed_path, "rb") as f:
            f.seek(offsets[b])
            hdr = np.fromfile(f, dtype="<u4", count=1)
            wm = np.fromfile(f, dtype=np.uint8, count=nb_blocks)
            used = int(hdr[0]) if hdr.size else -1
            payload = np.fromfile(f, dtype=np.uint8, count=max(used, 0))
        if used < 0 or wm.size != nb_blocks or payload.size != used:
            raise DataLoss(
                f"truncated d24v pack {packed_path}: record {b} at byte "
                f"offset {offsets[b]} is cut short", site="trace.load")
        pp = np.zeros(wirecodec.pad_len(used), np.uint8)
        pp[:used] = payload
        return (pp, wm, count), 4 + wm.nbytes + used

    read_rec = read_d24v if d24v else read_fixed
    if workers > 1:
        src = _FeedPool(0, n_batches, lambda b: None, read_rec,
                        lambda b, raw: raw, lambda b, mid: mid, workers,
                        depth=2)
    else:
        src = contextlib.nullcontext(read_rec(b) for b in range(n_batches))
    cuda = dev.type == "cuda"

    def put(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        return t.pin_memory().to(dev, non_blocking=True) if cuda else t

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    resident = torch.zeros((n_batches, bw, window, bpr), dtype=torch.uint8,
                           device=dev)
    staged = 0
    file_bytes = 0   # bytes read from the pack, without the padding
    with obs.span("trace.stage_resident", refs=n, fmt=fmt,
                  batch_windows=bw, feed_workers=workers) as sp, src as it:
        for b, (rec, nbytes) in zip(range(n_batches), it):
            file_bytes += nbytes
            if d24v:
                pp, wm, count = rec
                ids = _kernels.decode(put(pp), put(wm))
                resident[b].view(batch, 3)[:count].copy_(
                    _u24_bytes(ids[:count]))
            else:
                resident[b].view(-1)[:rec.size].copy_(put(rec))
            staged = b + 1
            if upload_budget_s is not None and staged < n_batches \
                    and staged % 16 == 0:
                # copies are asynchronous: only a sync makes the clock
                # count them
                sync()
                if time.perf_counter() - t0 > upload_budget_s:
                    break
        sync()   # the staged bytes are on the card: the span covers them
        upload_s = time.perf_counter() - t0
        sp.set(staged_batches=staged, shrunk=staged < n_batches)
    obs.counter_add("trace.upload_s", upload_s)
    obs.counter_add("trace.upload_bytes", file_bytes)
    if staged < n_batches:
        resident = resident[:staged]
    return resident, min(n, staged * batch), {
        "upload_s": upload_s,
        "upload_bytes": file_bytes if d24v else staged * batch * bpr}


def replay_staged(resident: torch.Tensor, n_lines: int, n_run: int,
                  window: int = TRACE_WINDOW, clock0: int = 0,
                  stats: dict | None = None,
                  segmented: bool | None = None, *,
                  _kernels: TraceKernels = KERNELS) -> ReplayResult:
    """Replay a staged resident trace (:func:`stage_resident`) on the
    device that holds it: a loop over its batches, each widened to int32
    ids and run through the segmented batch (or, with ``segmented=False``,
    the legacy per-window scan), binned by kernel 2
    (``_kernels.histogram``).

    ``clock0`` shifts the positions' origin: reuses are differences, so the
    histogram does not change; positions are int64 once ``clock0 +
    n_batches * batch`` reaches 2^31 - 2.  ``stats``, when given, gains
    ``replay_s`` and ``refs``; the result's ``timing`` holds them too.
    """
    n_batches, bw = resident.shape[0], resident.shape[1]
    batch = bw * window
    if resident.shape[2] != window:
        raise ValueError(f"resident trace has windows of "
                         f"{resident.shape[2]}, not {window}")
    pdt = _pos_dtype(n_batches, batch, clock0)
    batch_fn = _batch_fn(segmented, window)
    dev = resident.device
    t0 = time.perf_counter()
    with xprof.session(), obs.span("trace.replay_staged", refs=n_run):
        last_pos = torch.full((n_lines + 1,), -1, dtype=pdt, device=dev)
        hist = torch.zeros(NBINS, dtype=torch.int64, device=dev)
        for b in range(n_batches):
            ids = _widen_ids(resident[b].view(batch, resident.shape[3]))
            batch_fn(last_pos, hist, clock0 + b * batch, ids,
                     clock0 + n_run, pdt, _kernels.histogram)
        hist_np = hist.cpu().numpy()   # the copy waits for the device
    replay_s = time.perf_counter() - t0
    # resident refs have their own counter: trace.refs_replayed feeds the
    # streamed path's rate (refs over the replay_file span's wall)
    obs.counter_add("trace.resident_replay_s", replay_s)
    obs.counter_add("trace.resident_refs", n_run)
    if stats is not None:
        stats.update(replay_s=replay_s, refs=n_run)
    return ReplayResult(hist_np, n_run, n_lines,
                        timing={"replay_s": replay_s, "batches": n_batches})


def replay_resident(packed_path: str, meta: dict,
                    window: int = TRACE_WINDOW,
                    limit_refs: int | None = None,
                    upload_budget_s: float | None = None,
                    clock0: int = 0,
                    stats: dict | None = None,
                    batch_windows: int | None = None,
                    segmented: bool | None = None,
                    feed_workers: int | None = None, *, device=None,
                    _kernels: TraceKernels = KERNELS) -> ReplayResult:
    """Stage a packed trace into device memory (:func:`stage_resident`)
    and replay it from there (:func:`replay_staged`), on ``device``
    (default: the CUDA card).  ``meta`` is :func:`pack_file`'s sidecar.
    ``stats`` gains ``upload_s``, ``upload_bytes``, ``replay_s`` and
    ``refs``; under ``upload_budget_s`` the replay covers the staged
    prefix (``stats['refs']``)."""
    resident, n_run, info = stage_resident(
        packed_path, meta, window, limit_refs, upload_budget_s,
        batch_windows=batch_windows, feed_workers=feed_workers,
        device=device, _kernels=_kernels)
    if stats is not None:
        stats.update(info)
    if n_run == 0:
        return ReplayResult(np.zeros(NBINS, np.int64), 0, 0)
    return replay_staged(resident, meta["n_lines"], n_run, window,
                         clock0=clock0, stats=stats, segmented=segmented,
                         _kernels=_kernels)


# --- sharded replay ---------------------------------------------------------


def _steal_chunk_fn(ids: torch.Tensor, base: int, n_valid: int, L: int, pdt,
                    hist_fn=masked_histogram):
    """One chunk of a sharded replay from a fresh carry: ONE
    :func:`~pluss_torch.ops.reuse.batch_events` over the chunk (kernel 2
    bins it, colds left out), and its first touches captured as heads for
    the boundary merge.  ``L`` is the line table's capacity when the chunk
    was compacted.  Returns ``(hist, heads, tails)`` on the ids' device."""
    dev = ids.device
    pos = torch.arange(base, base + ids.shape[0], dtype=pdt, device=dev)
    last_pos = torch.full((L + 1,), -1, dtype=pdt, device=dev)
    ev = batch_events(ids, pos, pos < n_valid, last_pos)
    hist = event_histogram(ev, include_cold=False, hist_fn=hist_fn)
    head = torch.full((L + 1,), -1, dtype=pdt, device=dev)
    head.scatter_(0, torch.where(ev["cold"], ev["key"], L).long(), ev["pos"])
    return hist, head[:L], last_pos[:L]


def _resolve_heads(hist: np.ndarray, hp: np.ndarray,
                   prev: np.ndarray) -> None:
    """Add a scope's heads ``hp`` (host, -1 = none), resolved against the
    earlier scopes' tails ``prev``, to ``hist``: a head with no earlier
    tail is cold (slot 0), any other a reuse."""
    from pluss_torch.parallel.shard import np_head_hist

    hp = hp.astype(np.int64)
    evt = (hp >= 0) & (prev >= 0)
    hist[0] += int(((hp >= 0) & (prev < 0)).sum())
    r = (hp - prev)[evt]
    if r.size:
        hist += np_head_hist(r)


def _steal_boundary_merge(results: dict, n_chunks: int, L: int) -> np.ndarray:
    """Canonical-order boundary merge of per-scope ``(hist, heads, tails)``
    host arrays (the host twin of a static exchange): the heads of scope
    ``k`` resolve against the running max of earlier scopes' tails.  The
    order is the stream's whichever worker ran which scope, so any pull
    or steal schedule gives the same histogram."""
    prev = np.full(L, -1, np.int64)
    hist = np.zeros(NBINS, np.int64)
    for k in range(n_chunks):
        h, hp, tp = results.pop(k)
        hist += np.asarray(h, np.int64)
        if hp.shape[0] < L:   # a scope compacted at a smaller capacity
            pad = np.full(L - hp.shape[0], -1, hp.dtype)
            hp = np.concatenate([hp, pad])
            tp = np.concatenate([tp, pad])
        _resolve_heads(hist, hp, prev)
        prev = np.where(tp >= 0, tp.astype(np.int64), prev)
    return hist


def _host(out) -> tuple:
    return tuple(t.cpu().numpy() for t in out)


def _exchange(devs: list):
    """The static exchange of a sharded replay over this process's
    ``devs`` (:mod:`pluss_torch.parallel.shard`): the process group's when
    there is one (this rank's segments are ``ex.first ..``), else the
    local stack."""
    from pluss_torch.parallel.shard import (_GroupExchange, _in_group,
                                            _LocalExchange)

    return _GroupExchange(len(devs), devs[0]) if _in_group() \
        else _LocalExchange(len(devs))


def _exchange_merge(ex, outs: list, L: int) -> np.ndarray:
    """Boundary merge of a static sharded replay: ``outs`` are this
    process's segments' host ``(hist, heads, tails)``; every segment's
    tails come through the exchange, the heads of segment ``g`` resolve
    against the running max of earlier segments' tails, and the
    histograms sum over the group.  In one process it is
    :func:`_steal_boundary_merge` over the segments."""
    tails = ex.gather(torch.from_numpy(
        np.stack([o[2] for o in outs]))).numpy().astype(np.int64)
    prev = np.full(L, -1, np.int64)
    hist = np.zeros(NBINS, np.int64)
    for g in range(ex.n_segments):
        i = g - ex.first
        if 0 <= i < len(outs):
            hist += np.asarray(outs[i][0], np.int64)
            _resolve_heads(hist, outs[i][1], prev)
        prev = np.where(tails[g] >= 0, tails[g], prev)
    return ex.sum(torch.from_numpy(hist)).numpy()


def shard_replay(addrs: np.ndarray, cls: int = 64, devices=None,
                 window: int = TRACE_WINDOW, precompacted: bool = False, *,
                 device=None) -> ReplayResult:
    """Replay one in-memory address stream sharded over ``devices``
    (default :func:`pluss_torch.parallel.shard.default_devices` of
    ``device``): each device takes a contiguous segment of ``S`` windows,
    captures the accesses with no predecessor in its segment as heads, and
    the segments' boundaries merge in stream order; a segment runs in
    batches of the replay's batch geometry.  Exact: equal to
    :func:`replay`.

    In an initialized ``torch.distributed`` process group ``devices`` are
    this rank's own: every rank compacts the whole stream the same way,
    replays its devices' segments of the group's ``world * len(devices)``,
    and the tails and histograms go through the group's exchange, so
    every rank returns the same result."""
    from pluss_torch.parallel.shard import (_as_devices, _run_segments,
                                            default_devices)

    devs = _as_devices(devices) if devices is not None \
        else default_devices(device=device)
    addrs = np.asarray(addrs)
    if addrs.ndim != 1:
        raise ValueError("trace must be a 1-D address stream")
    n = addrs.shape[0]
    if n == 0:
        return ReplayResult(np.zeros(NBINS, np.int64), 0, 0)
    ex = _exchange(devs)
    D = ex.n_segments
    lines = addrs.astype(np.int64) if precompacted else lines_of(addrs, cls)
    ids, n_lines = _compact(lines, window)
    seg = max(1, -(-n // (D * window))) * window
    pdt = _pos_dtype(1, D * seg)
    batch = _resolve_bw(None, devs[0]) * window

    def segment(i: int) -> tuple:
        dev = devs[i]
        g = ex.first + i
        lo, hi = g * seg, min(n, (g + 1) * seg)
        last_pos = torch.full((n_lines + 1,), -1, dtype=pdt, device=dev)
        head = torch.full((n_lines + 1,), -1, dtype=pdt, device=dev)
        hist = torch.zeros(NBINS, dtype=torch.int64, device=dev)
        for b in range(lo, hi, batch):
            chunk = torch.from_numpy(ids[b:min(hi, b + batch)]).to(dev)
            pos = torch.arange(b, b + chunk.shape[0], dtype=pdt, device=dev)
            ev = batch_events(chunk, pos, torch.ones_like(pos, dtype=bool),
                              last_pos)
            hist += event_histogram(ev, include_cold=False)
            head.scatter_(0, torch.where(ev["cold"], ev["key"],
                                         n_lines).long(), ev["pos"])
        return _host((hist, head[:n_lines], last_pos[:n_lines]))

    outs = _run_segments(devs, segment)
    return ReplayResult(_exchange_merge(ex, outs, n_lines), n, n_lines)


def _shard_replay_file_steal(path: str, cls: int, devs: list, window: int,
                             precompacted: bool, bw: int,
                             resident_cache: bool = False) -> ReplayResult:
    """Work-stealing sharded replay: a sequential reader and compactor
    feeds chunk ids into a bounded queue, one worker per listed device
    pulls the next produced chunk
    (:class:`pluss_torch.parallel.steal.QueueDispatcher`; a pull off the
    static split counts as a steal), and the host merges the chunk
    boundaries in stream order, so the pull schedule never reaches the
    histogram.  Each chunk is one :func:`_steal_chunk_fn` (one kernel-2
    launch) under its worker's stream.

    ``resident_cache`` keeps the compacted chunks on their devices as ONE
    grouped entry of the residency store (:mod:`pluss_torch.residency`):
    a repeat replay skips the read and compact feed and reruns the chunk
    functions over the stored ids into the same merge."""
    from pluss_torch.parallel.shard import _Streams
    from pluss_torch.parallel.steal import QueueDispatcher

    D = len(devs)
    n = _u64_count(path)
    if n == 0:
        return ReplayResult(np.zeros(NBINS, np.int64), 0, 0)
    if cls & (cls - 1):
        raise ValueError(f"cache line size {cls} is not a power of two")
    shift = int(cls).bit_length() - 1
    chunk = bw * window
    n_chunks = -(-n // chunk)
    pdt = _pos_dtype(n_chunks, chunk)

    store = key = None
    if resident_cache:
        store = residency.store()
        key = _residency_key(path, cls=cls, window=window, bw=bw,
                             precompacted=precompacted, devices=devs)
        ent = store.lookup_pin(key, n_run=n)
        if ent is not None:
            # a hit: the compacted chunks are already on their devices
            try:
                results = {k: _host(_steal_chunk_fn(ids_dev, k * chunk, n,
                                                    int(cap_k), pdt))
                           for k, (ids_dev, cap_k) in enumerate(ent.value)}
                hist = _steal_boundary_merge(results, n_chunks, ent.n_lines)
                obs.counter_add("trace.shard_refs_replayed", n)
                return ReplayResult(hist, n, ent.n_lines)
            finally:
                store.unpin(key)

    comp = _Compactor()
    read_raw = _extent_reader(path, chunk, n)
    compact = _compact_stage(comp, shift, precompacted, snapshot=False)
    results: dict[int, tuple] = {}
    staged: dict[int, tuple] = {}
    through = store is not None
    if through:
        try:
            # compacted ids stay int32 on the device: 4 B per ref
            store.reserve(n_chunks * chunk * 4)
        except ResourceExhausted:
            through = False   # reserve counted the fallback

    def produce():
        for k in range(n_chunks):
            faults.check("trace.read_batch")  # chaos injection site
            ids, cap_k, _ = compact(k, read_raw(k))
            if len(ids) < chunk:
                ids = np.concatenate([ids, np.zeros(chunk - len(ids),
                                                    np.int32)])
            yield k, (ids, cap_k)

    streams = _Streams(devs)

    def run_chunk(wi: int, k: int, payload) -> None:
        ids, cap_k = payload
        dev = devs[wi]
        with streams(wi):
            t = torch.from_numpy(ids)
            ids_dev = t if dev.type == "cpu" else \
                t.pin_memory().to(dev, non_blocking=True)
            out = _steal_chunk_fn(ids_dev, k * chunk, n, int(cap_k), pdt)
            results[k] = _host(out)
        if through:
            staged[k] = (ids_dev, cap_k)

    disp = QueueDispatcher(D, run_chunk, depth=D + 2)
    with obs.span("trace.shard_replay_file", refs=n, devices=D,
                  dispatch="steal") as sp:
        stats = disp.run(produce(), n_chunks)
        hist = _steal_boundary_merge(results, n_chunks, comp.next_free)
        sp.set(chunks=n_chunks, steals=stats["steals"])
    if through and len(staged) == n_chunks:
        for dev in set(devs):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        value = tuple(staged[k] for k in range(n_chunks))
        nbytes = sum(int(v[0].numel()) * 4 for v in value)
        store.put(key, value, n_lines=comp.next_free, n_run=n, nbytes=nbytes,
                  meta={"path": path, "grouped": True, "devices": D})
        obs.counter_add("residency.stage_through")
        obs.trace_event("residency.stage_through", nbytes=nbytes)
    obs.counter_add("shard.chunks", n_chunks)
    obs.counter_add("shard.steals", stats["steals"])
    obs.counter_add("trace.shard_refs_replayed", n)
    for i, bf in enumerate(stats["busy_frac"]):
        obs.gauge_set(f"shard.device_busy_frac.{i}", round(bf, 4))
    return ReplayResult(hist, n, comp.next_free)


def shard_replay_file(path: str, cls: int = 64, devices=None,
                      window: int = TRACE_WINDOW,
                      precompacted: bool = False,
                      batch_windows: int | None = None,
                      initial_capacity: int = 1 << 20,
                      checkpoint_path: str | None = None,
                      checkpoint_every: int = 4,
                      resume: bool = False,
                      dispatch: str | None = None,
                      resident_cache: bool | None = None, *,
                      device=None) -> ReplayResult:
    """Sharded replay of a u64 trace streamed from disk, over ``devices``
    (default :func:`pluss_torch.parallel.shard.default_devices` of
    ``device``), equal to :func:`replay_file`.

    ``dispatch``: ``steal`` (:func:`_shard_replay_file_steal`, with more
    than one listed device), ``static`` or ``auto``/None
    (``PLUSS_SHARD_DISPATCH``; steal from 2^23 refs).  Static: device
    ``d`` owns the segment of ``S = ceil(n / (D * window))`` windows
    from ``d*S*window``; each step reads and compacts every device's next
    ``batch_windows`` windows of its segment (device-major, through one
    compactor, so ids agree across segments), runs one segmented
    extraction per device against its carried ``last_pos`` and captures
    first touches as heads; at the end the segments' boundaries merge in
    stream order.

    ``checkpoint_path`` + ``resume``: every ``checkpoint_every`` steps the
    carries (``last_pos``, ``hist``, ``head_pos``, all ``[D, capacity]``)
    go to ``checkpoint_path + '.npz'`` and the step, compactor and run
    identity to the journal at ``checkpoint_path``, record for record the
    JAX package's, so either package resumes the other's.  The checkpoint
    identity is the static segment grid, so a checkpoint pins the static
    dispatch (an explicit ``steal`` says so on stderr).  A checkpoint of
    another run is ignored with a notice and never spliced; a finished
    run retires its own.

    ``resident_cache``: steal only, keep the compacted chunks in the
    residency store as one grouped entry.

    In an initialized ``torch.distributed`` process group ``devices`` are
    this rank's own and the dispatch is static over the group's ``D =
    world * len(devices)`` segments; the ids must be ``precompacted``
    (JAX's rule).  Every rank reads and compacts every segment's slices
    through one compactor in the same order, so the ids agree, runs its
    own segments, and the tails and histograms go through the group's
    exchange: every rank returns the same result.  A checkpoint holds the
    whole group's carries: they are gathered to the coordinator
    (:func:`pluss_torch.parallel.multihost.is_coordinator`), which alone
    writes and retires it; on resume every rank reads it and takes its own
    rows, and the ranks start fresh together unless every one resumes at
    the same step.
    """
    from pluss_torch.parallel.shard import (_as_devices, _auto_steal,
                                            _resolve_dispatch,
                                            default_devices, group_size)

    devs = _as_devices(devices) if devices is not None \
        else default_devices(device=device)
    bw = _resolve_bw(batch_windows, devs[0])
    if group_size() > 1 and not precompacted:
        raise RuntimeError(
            "shard_replay_file needs precompacted ids under multi-process "
            "execution (per-process cluster discovery would diverge)"
        )
    if resident_cache is not None and not isinstance(resident_cache, bool):
        raise ValueError(
            f"resident_cache must be a bool or None, got {resident_cache!r}")
    eff = _resolve_dispatch(dispatch)
    if eff == "auto":
        eff = "steal" if _auto_steal(_u64_count(path)) else "static"
    if eff == "steal" and checkpoint_path is not None:
        if dispatch == "steal":
            print("trace: checkpointing pins the static sharded dispatch "
                  "(the checkpoint identity is the static segment grid); "
                  "using dispatch='static'", file=sys.stderr)
        eff = "static"
    if eff == "steal" and len(devs) > 1:
        return _shard_replay_file_steal(path, cls, devs, window,
                                        precompacted, bw,
                                        resident_cache=bool(resident_cache))
    n = _u64_count(path)
    if n == 0:
        return ReplayResult(np.zeros(NBINS, np.int64), 0, 0)
    if cls & (cls - 1):
        raise ValueError(f"cache line size {cls} is not a power of two")
    from pluss_torch.parallel.multihost import is_coordinator

    shift = int(cls).bit_length() - 1
    # this process's segments are ex.first .. ex.first + nl - 1 of D
    ex = _exchange(devs)
    D, nl, first = ex.n_segments, len(devs), ex.first
    S = max(1, -(-n // (D * window)))
    SB = min(bw, S)
    n_calls = -(-S // SB)
    pdt = _pos_dtype(1, D * S * window)
    npdt = np.int32 if pdt == torch.int32 else np.int64
    comp = _Compactor()
    capacity = initial_capacity

    def carries(lp, hi, hp):
        """This process's per-device carries from host arrays (``[nl,
        ...]``), each line table with its dump slot."""
        dump = np.full((nl, 1), -1, npdt)
        return ([torch.from_numpy(np.concatenate([lp, dump], 1)[i]).to(
                    devs[i], pdt) for i in range(nl)],
                [torch.from_numpy(hi[i].astype(np.int64)).to(devs[i])
                 for i in range(nl)],
                [torch.from_numpy(np.concatenate([hp, dump], 1)[i]).to(
                    devs[i], pdt) for i in range(nl)])

    def host_carries():
        return (np.stack([t[:-1].cpu().numpy() for t in last_pos]),
                np.stack([t.cpu().numpy() for t in hist]).astype(npdt),
                np.stack([t[:-1].cpu().numpy() for t in head_pos]))

    def mine(a: np.ndarray) -> np.ndarray:
        """This process's rows of a ``[D, ...]`` checkpoint array."""
        return a[first:first + nl]

    ident = {"n": n, "window": window, "cls": cls,
             "precompacted": bool(precompacted), "D": D, "SB": SB,
             "fp": _trace_fingerprint(path) if checkpoint_path else ""}
    jr = Journal(checkpoint_path) if checkpoint_path else None
    npz_path = checkpoint_path + ".npz" if checkpoint_path else None
    k0 = 0
    last_pos = None
    #: a checkpoint of ANOTHER run is never retired by this one
    foreign = False
    if jr is not None and len(jr):
        rec0 = jr.get({"shard_ckpt": 1})
        foreign = rec0 is None or any(rec0.get(k_) != v
                                      for k_, v in ident.items())
        if foreign and not resume:
            print(f"trace: {checkpoint_path} holds a checkpoint for a "
                  "DIFFERENT run; this run will overwrite it at its "
                  "first checkpoint", file=sys.stderr)
    if resume and jr is not None and len(jr) and os.path.exists(npz_path):
        rec = jr.get({"shard_ckpt": 1})
        if rec is None or any(rec.get(k_) != v for k_, v in ident.items()):
            print(f"trace: shard checkpoint {checkpoint_path} is for a "
                  "different run; starting fresh", file=sys.stderr)
        else:
            try:
                with np.load(npz_path) as z:
                    if int(z["k_next"]) != rec["k_next"]:
                        raise ValueError(
                            "journal/array checkpoint out of step")
                    k0 = int(z["k_next"])
                    capacity = int(z["capacity"])
                    last_pos, hist, head_pos = carries(
                        mine(z["last_pos"]).astype(npdt), mine(z["hist"]),
                        mine(z["head_pos"]).astype(npdt))
                comp = _Compactor.restore(rec["comp"])
                print(f"trace: resuming sharded replay at call "
                      f"{k0}/{n_calls}", file=sys.stderr)
            except Exception as e:  # noqa: BLE001 — any unreadable one
                if is_coordinator():
                    quarantine_artifact(npz_path, "shard replay-checkpoint",
                                        e, action="starting fresh")
                k0, last_pos = 0, None
    if nl < D and jr is not None:
        # a group resumes only when every rank resumes at the same step
        k0s = ex.gather(torch.tensor([[k0]], dtype=torch.int64)).flatten()
        if bool((k0s != k0).any()):
            if k0:
                print("trace: the group's ranks disagree on the shard "
                      "checkpoint; starting fresh", file=sys.stderr)
            k0, last_pos = 0, None
            comp, capacity = _Compactor(), initial_capacity
    if last_pos is None:
        last_pos, hist, head_pos = carries(
            np.full((nl, capacity), -1, npdt), np.zeros((nl, NBINS), npdt),
            np.full((nl, capacity), -1, npdt))

    def save_ckpt(k_next: int) -> None:
        # the whole group's carries, gathered to the coordinator, which
        # alone writes: the arrays land first (atomic replace), then the
        # journal line that promises them
        nonlocal foreign
        foreign = False
        lp, hi, hp = (ex.gather(torch.from_numpy(a)).numpy()
                      for a in host_carries())
        if not is_coordinator():
            return
        tmp = f"{npz_path}.tmp.{os.getpid()}.npz"
        np.savez(tmp, k_next=np.int64(k_next), capacity=np.int64(capacity),
                 last_pos=lp, hist=hi, head_pos=hp)
        os.replace(tmp, npz_path)
        jr.record({"shard_ckpt": 1}, k_next=k_next, comp=comp.snapshot(),
                  **ident)

    def read_slice(f, d: int, k: int) -> np.ndarray:
        """Device d's k-th slice of ids, zero-padded to SB*window; the
        read clips at the stream's end and at the segment's."""
        faults.check("trace.read_batch")  # chaos injection site
        lo = d * S * window + k * SB * window
        count = max(0, min(SB * window, n - lo, (d + 1) * S * window - lo))
        out = np.zeros(SB * window, np.int32)
        if count:
            f.seek(lo * 8)
            raw = np.fromfile(f, dtype="<u8", count=count)
            ids = comp.map_raw(raw, 0 if precompacted else shift)
            if ids is None:
                lines = raw.astype(np.int64) if precompacted \
                    else raw.astype(np.int64) >> shift
                ids = comp.map(lines)
            out[:count] = ids
        return out

    with obs.span("trace.shard_replay_file", refs=n, devices=D,
                  dispatch="static"), open(path, "rb") as f:
        for k in range(k0, n_calls):
            # every segment's slice, device-major through the one
            # compactor (so every rank's ids agree); this process runs
            # its own
            slices = [read_slice(f, d, k) for d in range(D)]
            if comp.next_free > capacity:
                # table growth: the carries re-pad at the new capacity
                lp, hi, hp = host_carries()
                while capacity < comp.next_free:
                    capacity *= 2
                pad = np.full((nl, capacity - lp.shape[1]), -1, npdt)
                last_pos, hist, head_pos = carries(
                    np.concatenate([lp, pad], 1), hi,
                    np.concatenate([hp, pad], 1))
            for i in range(nl):
                d, dev = first + i, devs[i]
                lo = d * S * window + k * SB * window
                ids = torch.from_numpy(slices[d]).to(dev)
                pos = torch.arange(lo, lo + SB * window, dtype=pdt,
                                   device=dev)
                ev = batch_events(ids, pos,
                                  pos < min(n, (d + 1) * S * window),
                                  last_pos[i])
                hist[i] += event_histogram(ev, include_cold=False)
                head_pos[i].scatter_(0, torch.where(
                    ev["cold"], ev["key"], capacity).long(), ev["pos"])
            if jr is not None and k + 1 < n_calls \
                    and (k + 1 - k0) % checkpoint_every == 0:
                save_ckpt(k + 1)
        results = [_host((hist[i], head_pos[i][:-1], last_pos[i][:-1]))
                   for i in range(nl)]
        out = _exchange_merge(ex, results, capacity)
    if jr is not None and not foreign and is_coordinator():
        for p_ in (checkpoint_path, npz_path):
            try:
                os.unlink(p_)
            except OSError:
                pass
    return ReplayResult(out, n, comp.next_free)
