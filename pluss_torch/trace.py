"""Dynamic trace replay: reuse histograms from raw address streams.

The port of ``pluss/trace.py``'s single-device streamed replay (BASELINE
config 5: raw DynamoRIO-style memory traces at 1e9 refs).

1. Host: byte addresses are masked to cache lines (``addr >> log2(CLS)``)
   and remapped to dense ids by cluster probing (:class:`_Compactor`),
   batch by batch, in a pool of feed threads (:class:`_FeedPool`) that read
   and wire-encode extents of the file in parallel and compact them in
   stream order.
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
   int64 on the card.

A replayed trace is single-clock, so the result feeds
:func:`pluss_torch.mrc.aet_mrc` directly, with no CRI dilation.

Entry points: :func:`replay_file` (streams a file in bounded host memory,
with checkpoint/resume) and :func:`replay` (an in-memory stream); both run
on the CUDA card unless the caller passes ``device="cpu"``.  Histograms,
``total_count`` and ``n_lines`` equal ``pluss.trace``'s, and the two
packages' checkpoints resume in each other.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
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

from pluss_torch.config import NBINS
from pluss_torch.engine import resolve_device
from pluss_torch.errors import DataLoss, quarantine_artifact
from pluss_torch.ops import wirecodec
from pluss_torch.ops.decode import decode_d24v
from pluss_torch.ops.event_hist import masked_histogram, masked_histogram_plain
from pluss_torch.ops.reuse import batch_events, event_histogram

#: default accesses per window (the batch is ``batch_windows`` windows)
TRACE_WINDOW = 1 << 20

#: default windows per device batch: 16 x 2^20 = 2^24 refs per sort
WINDOWS_PER_BATCH = 16

WIRE_CHOICES = ("auto", "pack", "d24v")

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
    (empty/0 without one); ``timing`` is its main-thread time split
    (``prefetch_stall_s``, ``h2d_s``, ``device_s``, ``ckpt_save_s``,
    ``grow_s``, ``wall_s``), the feed's seconds per stage summed over its
    workers (``read_s``, ``compact_s``, ``encode_s``; they run beside the
    main thread) and the batch and byte counts.
    """

    hist: np.ndarray          # [NBINS] int64
    total_count: int
    n_lines: int
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


def _resolve_wire(wire: str | None, device: torch.device) -> str:
    """``auto``/None: d24v on the card (the compressed bytes cross PCIe
    and the kernel expands them), pack on the CPU (no transport to
    compress for)."""
    wire = "auto" if wire is None else wire
    if wire not in WIRE_CHOICES:
        raise ValueError(f"unknown wire format {wire!r} (choices: "
                         f"{', '.join(WIRE_CHOICES)})")
    if wire == "auto":
        return "d24v" if device.type == "cuda" else "pack"
    return wire


def _default_feed_workers(device: torch.device) -> int:
    """On the CPU the replay computes on the same cores, so one feed
    thread; with a card the host cores idle while it computes: use most
    of them."""
    if device.type == "cpu":
        return 1
    return max(2, min(8, (os.cpu_count() or 1) - 1))


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
    prefix semantics as the single reader.  In-flight batches (claimed but
    not yet consumed) are bounded by ``depth + workers``.
    """

    def __init__(self, b0: int, end: int, read_fn, compact_fn, encode_fn,
                 workers: int, depth: int):
        self._end = end
        self._read_fn = read_fn
        self._compact_fn, self._encode_fn = compact_fn, encode_fn
        self.workers = workers
        self._budget = depth + workers
        self._cv = threading.Condition()
        self._next_claim = b0
        self._turn = b0
        self._next_out = b0
        self._done: dict[int, object] = {}
        self._stop = False
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
            err = raw = mid = item = None
            t0 = time.perf_counter()
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
    int16 (the u16 pack, reinterpreted) | int32 -> int32."""
    if t.dtype == torch.uint8:
        b = t.to(torch.int32)
        return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    if t.dtype == torch.int16:
        return t.to(torch.int32) & 0xFFFF
    return t


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


def replay(addrs: np.ndarray, cls: int = 64, window: int = TRACE_WINDOW,
           precompacted: bool = False, batch_windows: int | None = None,
           *, device=None, _kernels: TraceKernels = KERNELS) -> ReplayResult:
    """Replay an in-memory address stream into a reuse histogram, on
    ``device`` (default: the CUDA card).

    ``addrs``: 1-D array of byte addresses (or dense line ids when
    ``precompacted``).
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
                       _kernels.histogram)


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
    assigned ids stable; ``next_free`` counts allocated table slots.  The
    JAX package's native single-cluster mapper is not ported: this numpy
    path assigns the same ids.
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


def _pos_dtype(n_batches: int, batch: int) -> torch.dtype:
    """int32 positions while every padded position fits; int64 past."""
    return torch.int32 if n_batches * batch < 2**31 - 2 else torch.int64


def _replay_ids(ids: np.ndarray, n_lines: int, n: int, window: int,
                batch_windows: int | None, dev: torch.device,
                hist_fn) -> ReplayResult:
    """Stream dense line ids through the device in fixed-shape batches."""
    bw = _positive("batch_windows", batch_windows, WINDOWS_PER_BATCH)
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
        _segmented_batch(last_pos, hist, lo, torch.from_numpy(chunk).to(dev),
                         n, pdt, hist_fn)
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
    the CPU.
    """
    dev = resolve_device(device)
    window = _positive("window", window, TRACE_WINDOW)
    if fmt == "text":  # line-oriented; no random access worth streaming
        return replay(load_trace(path, fmt), cls, window,
                      precompacted=precompacted, batch_windows=batch_windows,
                      device=dev, _kernels=_kernels)
    if fmt != "u64":
        raise ValueError(f"unknown trace format {fmt!r}")
    n = _u64_count(path)
    if limit_refs is not None:
        n = min(n, limit_refs)
    if n == 0:
        return ReplayResult(np.zeros(NBINS, np.int64), 0, 0)
    if cls & (cls - 1):
        raise ValueError(f"cache line size {cls} is not a power of two")
    shift = int(cls).bit_length() - 1
    bw = _positive("batch_windows", batch_windows, WINDOWS_PER_BATCH)
    batch = bw * window
    n_batches = -(-n // batch)
    pdt = _pos_dtype(n_batches, batch)
    np_pdt = np.int32 if pdt == torch.int32 else np.int64
    wirefmt = _resolve_wire(wire, dev)
    workers = _positive("feed_workers", feed_workers,
                        _default_feed_workers(dev))
    sd = _positive("stage_depth", stage_depth, 2)
    qd = _positive("queue_depth", queue_depth, 2)

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
        src = _FeedPool(b0, n_batches, read_raw, compact_batch, encode_batch,
                        workers, qd)
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

    # the main thread is, at any instant, in one of these buckets
    st = {"prefetch_stall_s": 0.0, "h2d_s": 0.0, "device_s": 0.0,
          "ckpt_save_s": 0.0, "grow_s": 0.0}
    st_n = {"h2d_bytes": 0, "batches": 0, "ckpt_saves": 0, "growths": 0}
    cuda = dev.type == "cuda"
    main = torch.cuda.current_stream(dev) if cuda else None
    side = torch.cuda.Stream(dev) if cuda else None

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

    with src as it:
        stream = iter(it)
        pending: deque = deque()
        exhausted = False
        feed_err: BaseException | None = None
        truncated = False

        def pump():
            """Refill the staged-ahead pipeline to ``stage_depth``
            batches.  A feed error is held, not raised: batches already
            staged are processed (and checkpointed) first."""
            nonlocal exhausted, feed_err
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
                pending.append(out)

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
            _segmented_batch(last_pos, hist, b * batch, ids_dev, n, pdt,
                             _kernels.histogram)
            del ids_dev
            st["device_s"] += time.perf_counter() - td
            st_n["batches"] += 1
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
    if checkpoint_path and done >= n:
        # a finished run retires its checkpoint: a later, different run
        # must not resume from this one's final state
        with contextlib.suppress(OSError):
            os.unlink(checkpoint_path)
    feed = it.stage_s if isinstance(it, _FeedPool) else stage_s
    return ReplayResult(hist_np, done, n_lines, wire=wirefmt,
                        feed_workers=workers,
                        timing={**st, **st_n, **feed,
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
