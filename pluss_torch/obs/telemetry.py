"""Structured telemetry core: counters, gauges, spans, and a JSONL sink.

The port's copy of ``pluss/obs/telemetry.py``: the same schema version,
record kinds, JSONL stream, Prometheus text and ``PLUSS_TELEMETRY`` /
``PLUSS_PROM`` bootstrap, so a stream from either package reads the same
in both ``stats`` commands.  Every layer of the port records into it:

- **counters** — monotonically accumulated numbers (floats allowed: stall
  *seconds* are a counter), cumulative per process;
- **gauges** — last-value-wins samples (queue occupancy, resident bytes);
- **spans** — monotonic-clock wall intervals, nestable per thread (a
  ``threading.local`` stack provides parent ids), with free-form
  attributes;
- **events** — discrete occurrences (a fault fired, a ladder rung taken).

Everything lands in ONE append-only JSONL stream with the resilience
Journal's write discipline (one record = one line = one ``write()`` +
flush, so a crash can only tear the final line; ``stats --check``
tolerates exactly that).  Counters/gauges are additionally snapshotted as
records at every :func:`flush_metrics` and at shutdown, and can be
exported as a Prometheus-style textfile (:meth:`Telemetry.write_prom`).

The DISABLED path is the design center: with no sink configured every
module-level helper is a global-read + ``None``-check (and ``span()``
returns one shared no-op singleton), so instrumented code pays
effectively nothing — and, enforced by tests, telemetry is observably
passive: histograms and MRCs are bit-identical with it on or off.  Spans
and counters are host wall clocks: none of them synchronizes the CUDA
device, so a span that does not end at a copy back to the host measures
the launches, not the device's work.

While a ``torch.profiler`` is recording, every span also opens a
``torch.profiler.record_function`` range of its own name (:func:`_range`),
so the profiler's timeline, and a device trace read off it, shows the
program's spans on the profiler's own clock.  The check reads ``torch``
from ``sys.modules``: this module imports no torch, and a process that
never imported it runs no profiler.  The JSONL record is the same either
way.

Work that repeats many times inside one span, such as the windows of a
dispatch, opens :func:`tally_span` instead: a profiler range per call, but
one record per name for each enclosing span, with the summed seconds and
the number of calls.  The stream then grows with the number of
operations, not of windows, and a sink's per-record write does not land
inside the loop it observes.

Inside a serve request's context (:mod:`pluss_torch.obs.tracectx`) spans
and events carry a ``trace`` stamp naming the request, and
:func:`trace_event` emits; outside one it emits nothing and records carry
no stamp.

Enable via ``PLUSS_TELEMETRY=<path>`` (read once, lazily) or explicitly
with :func:`configure` (the CLI's ``--telemetry`` flag).
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time

from pluss_torch.obs import tracectx

#: event-stream schema version, stamped on the meta line; ``pluss stats
#: --check`` refuses streams from a NEWER schema than it understands
SCHEMA_VERSION = 1

#: record kinds a stream may contain (the single source for stats --check)
EVENT_KINDS = ("meta", "span", "counter", "gauge", "event", "end")


class _NoopSpan:
    """The shared disabled-path span: every method is a no-op returning
    self, so ``with span(...) as s: s.set(x=1)`` costs two attribute
    lookups when telemetry is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NOOP_SPAN = _NoopSpan()


def _range(name: str):
    """An open ``record_function`` range named ``name`` while a
    ``torch.profiler`` records, else None."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    rf = torch.autograd.profiler.record_function(name)
    rf.__enter__()
    return rf


class _Tally:
    """A span of work that repeats inside its enclosing span (one window
    of a dispatch): every call opens its own profiler range, but its
    record is kept by the enclosing span, one per name, with the calls'
    summed seconds and their number (attribute ``calls``).  So the stream
    holds as many records for a run of a hundred windows as of one."""

    __slots__ = ("_tel", "name", "_start", "_rf")

    def __init__(self, tel: "Telemetry", name: str):
        self._tel = tel
        self.name = name

    def __enter__(self):
        self._rf = _range(self.name)
        self._start = time.monotonic()
        return self

    def __exit__(self, etype, evalue, tb):
        dur = time.monotonic() - self._start
        if self._rf is not None:
            self._rf.__exit__(etype, evalue, tb)
        self._tel._tally(self.name, self._start, dur)
        return False


class _Span:
    __slots__ = ("_tel", "name", "attrs", "_start", "_id", "_parent",
                 "_trace", "_rf", "_tallies", "_outer")

    def __init__(self, tel: "Telemetry", name: str, attrs: dict):
        self._tel = tel
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        tel = self._tel
        stack = tel._span_stack()
        self._parent = stack[-1] if stack else None
        self._id = tel._new_id()
        stack.append(self._id)
        # the trace stamp names the request context the work STARTED
        # under (a batch dispatch re-binding per member still attributes
        # the enclosing span to the lead request it entered with)
        self._trace = tracectx.current()
        # the tallied spans that close inside this one, by name
        self._tallies = {}
        self._outer = getattr(tel._tls, "tallies", None)
        tel._tls.tallies = self._tallies
        self._rf = _range(self.name)
        self._start = time.monotonic()
        return self

    def set(self, **attrs):
        """Attach/override attributes mid-span (recorded at exit)."""
        self.attrs.update(attrs)
        return self

    def __exit__(self, etype, evalue, tb):
        dur = time.monotonic() - self._start
        if self._rf is not None:
            self._rf.__exit__(etype, evalue, tb)
        tel = self._tel
        stack = tel._span_stack()
        if stack and stack[-1] == self._id:
            stack.pop()
        if getattr(tel._tls, "tallies", None) is self._tallies:
            tel._tls.tallies = self._outer
        # children record before their parent, as nested spans do
        for name, (start, total, calls) in self._tallies.items():
            tel._emit_span(tel._new_id(), name, start, total, self._id,
                           self._trace, {"calls": calls})
        tel._emit_span(self._id, self.name, self._start, dur, self._parent,
                       self._trace, self.attrs,
                       etype.__name__ if etype is not None else None)
        return False


class Telemetry:
    """One process-wide telemetry session bound to a JSONL sink file.

    Thread-safe throughout: counters/gauges mutate under one lock, every
    record is a single locked ``write()`` + flush (the Journal's torn-
    line-only crash contract), and span nesting state is per-thread.
    """

    def __init__(self, path: str | None, prom_path: str | None = None):
        self.path = path
        self.prom_path = prom_path
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._tls = threading.local()
        self._id = 0
        self._t0 = time.monotonic()
        self._closed = False
        self._taps: tuple = ()
        if path is None:
            # memory-only session: no sink file — records exist only for
            # taps (the serve flight recorder's post-mortem ring) and the
            # in-memory counter/gauge maps.  Bounded by construction: the
            # maps are keyed aggregates and taps own their retention.
            self._f = None
        else:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            # one run = one stream: truncate, then append-only for the
            # run's lifetime (pluss stats reads a single run's tree)
            self._f = open(path, "w")
        self._emit({"ev": "meta", "schema": SCHEMA_VERSION,
                    "pid": os.getpid(), "argv": sys.argv[:8],
                    "t_wall": round(time.time(), 3), "clock": "monotonic"})

    # -- internals ----------------------------------------------------------

    def _span_stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _new_id(self) -> int:
        with self._lock:
            self._id += 1
            return self._id

    def _emit_span(self, sid: int, name: str, start: float, dur: float,
                   parent, trace, attrs: dict, error: str | None = None
                   ) -> None:
        rec = {"ev": "span", "id": sid, "name": name,
               "t": round(start - self._t0, 6), "dur": round(dur, 6)}
        if parent is not None:
            rec["parent"] = parent
        if trace is not None:
            rec["trace"] = trace
        if attrs:
            rec["attrs"] = attrs
        if error is not None:
            rec["error"] = error
        th = threading.current_thread().name
        if th != "MainThread":
            rec["thread"] = th
        self._emit(rec)

    def _tally(self, name: str, start: float, dur: float) -> None:
        """Add one call of a tallied span to the innermost open span of
        this thread, or, with none open, record it on its own."""
        tallies = getattr(self._tls, "tallies", None)
        if tallies is None:
            self._emit_span(self._new_id(), name, start, dur, None,
                            tracectx.current(), {"calls": 1})
            return
        got = tallies.get(name)
        if got is None:
            tallies[name] = [start, dur, 1]
        else:
            got[1] += dur
            got[2] += 1

    def _emit(self, rec: dict) -> None:
        for tap in self._taps:
            try:
                tap(rec)
            except Exception:
                pass   # a broken tap must never sink the observed run
        if self._f is None:
            return
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        with self._lock:
            if self._closed:
                return
            try:
                self._f.write(line)
                self._f.flush()
            except OSError as e:
                # ENOSPC / read-only fs mid-run: observability must never
                # sink the run it observes — disable the sink with one
                # notice and let the computation finish (counters keep
                # accumulating in memory, they just can't flush)
                self._closed = True
                try:
                    self._f.close()
                except OSError:
                    pass
                print(f"telemetry: sink write to {self.path} failed "
                      f"({e}); disabling the event stream",
                      file=sys.stderr)

    def add_tap(self, fn) -> None:
        """Register ``fn(record_dict)`` to observe every emitted record
        (the flight recorder's feed).  Taps run outside the sink lock on
        the emitting thread and must be fast and non-raising; exceptions
        are swallowed.  The tuple swap keeps iteration lock-free."""
        with self._lock:
            self._taps = (*self._taps, fn)

    def remove_tap(self, fn) -> None:
        with self._lock:
            self._taps = tuple(t for t in self._taps if t is not fn)

    @staticmethod
    def _num(name: str, value) -> float:
        v = float(value)
        if v != v:  # NaN would poison every later aggregate silently
            raise ValueError(f"telemetry value for {name!r} is NaN")
        return v

    # -- recording API ------------------------------------------------------

    def counter_add(self, name: str, value: float = 1) -> None:
        v = self._num(name, value)
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + v

    def gauge_set(self, name: str, value: float) -> None:
        v = self._num(name, value)
        with self._lock:
            self._gauges[name] = v
        self._emit({"ev": "gauge", "name": name,
                    "value": v, "t": round(time.monotonic() - self._t0, 6)})

    def event(self, name: str, **attrs) -> None:
        stack = self._span_stack()
        rec = {"ev": "event", "name": name,
               "t": round(time.monotonic() - self._t0, 6)}
        if stack:
            rec["parent"] = stack[-1]
        tr = tracectx.current()
        if tr is not None:
            rec["trace"] = tr
        if attrs:
            rec["attrs"] = attrs
        self._emit(rec)

    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs)

    def tally_span(self, name: str) -> _Tally:
        return _Tally(self, name)

    # -- snapshots / export -------------------------------------------------

    def counters(self) -> dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def gauges(self) -> dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    def flush_metrics(self) -> None:
        """Write the cumulative counter values (and last gauge values) as
        records.  Values are CUMULATIVE, so ``pluss stats`` takes the last
        record per name — flushing often only adds durability."""
        t = round(time.monotonic() - self._t0, 6)
        for name, v in sorted(self.counters().items()):
            self._emit({"ev": "counter", "name": name, "value": v, "t": t})

    def write_prom(self, path: str | None = None) -> str:
        """Prometheus-textfile-collector export of the current counters and
        gauges (atomic tmp + replace).  Returns the path written.  The
        text itself comes from :func:`render_prom` — the SAME renderer the
        serve daemon's live ``/metrics`` endpoint serves, so a scrape and
        the textfile can never drift in format."""
        path = path or self.prom_path
        if not path:
            raise ValueError("no prometheus textfile path configured")
        text = render_prom(self.counters(), self.gauges())
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
        return path

    def close(self) -> None:
        if self._closed:
            return
        self.flush_metrics()
        self._emit({"ev": "end",
                    "dur": round(time.monotonic() - self._t0, 6)})
        with self._lock:
            self._closed = True
            if self._f is not None:
                try:
                    self._f.flush()
                    os.fsync(self._f.fileno())
                except OSError:
                    pass
                self._f.close()
        if self.prom_path:
            try:
                self.write_prom()
            except OSError as e:
                print(f"telemetry: prometheus export failed: {e}",
                      file=sys.stderr)


class LatencyReservoir:
    """Thread-safe sliding window of the most recent ``capacity`` samples
    with quantile reads — the SLO substrate of the serving layer (p50/p99
    request latency published as gauges).

    A plain ring, not a sketch: at serving rates the window is a few
    thousand floats, and exact quantiles over "the recent past" are what
    an operator actually wants from a gauge.  ``add`` is O(1) under one
    lock; ``quantile`` sorts a snapshot (O(n log n) but only on publish,
    which the server throttles)."""

    __slots__ = ("_cap", "_ring", "_n", "_lock")

    def __init__(self, capacity: int = 2048):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._cap = capacity
        self._ring: list[float] = []
        self._n = 0          # total samples ever added
        self._lock = threading.Lock()

    def add(self, value: float) -> None:
        v = float(value)
        with self._lock:
            if len(self._ring) < self._cap:
                self._ring.append(v)
            else:
                self._ring[self._n % self._cap] = v
            self._n += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    def quantile(self, q: float) -> float | None:
        """The ``q``-quantile (0..1, nearest-rank) of the current window,
        or None when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            snap = list(self._ring)
        if not snap:
            return None
        snap.sort()
        return snap[min(len(snap) - 1, int(q * len(snap)))]


def _prom_name(name: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    if not out or not (out[0].isalpha() or out[0] == "_"):
        out = "_" + out
    return "pluss_" + out


def _prom_value(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def render_prom(counters: dict[str, float], gauges: dict[str, float],
                quantiles: dict[str, dict[str, float]] | None = None
                ) -> str:
    """The one Prometheus text renderer (exposition format 0.0.4): used
    by the shutdown textfile export AND the serve daemon's live
    ``/metrics`` endpoint, so the two surfaces cannot drift.  Counters
    render as ``counter``, gauges as ``gauge``, and ``quantiles`` (name
    -> {"0.5": v, ...}, e.g. a latency reservoir) as ``summary`` series
    with a ``quantile`` label.  Names are sanitized by :func:`_prom_name`
    (prefix ``pluss_``, every non-alphanumeric byte -> ``_``), and every
    family carries ``# HELP``/``# TYPE`` header lines."""
    lines: list[str] = []

    def family(name: str, kind: str, help_text: str) -> str:
        pn = _prom_name(name)
        lines.append(f"# HELP {pn} {help_text}")
        lines.append(f"# TYPE {pn} {kind}")
        return pn

    for name, v in sorted(counters.items()):
        pn = family(name, "counter",
                    f"pluss cumulative counter {name}")
        lines.append(f"{pn} {_prom_value(v)}")
    for name, v in sorted(gauges.items()):
        pn = family(name, "gauge", f"pluss gauge {name}")
        lines.append(f"{pn} {_prom_value(v)}")
    for name, qs in sorted((quantiles or {}).items()):
        pn = family(name, "summary",
                    f"pluss latency reservoir {name}")
        for q, v in sorted(qs.items(), key=lambda kv: float(kv[0])):
            if v is None:
                continue
            lines.append(f'{pn}{{quantile="{float(q)}"}} '
                         f"{_prom_value(v)}")
    return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# module-level session: the fast path every instrumented module calls.

_active: Telemetry | None = None
_bootstrapped = False
_atexit_registered = False
_suspended = 0


def suspend_env_bootstrap() -> None:
    """Hold off the lazy ``PLUSS_TELEMETRY`` bootstrap (telemetry calls
    are dropped meanwhile).  For windows where opening the env-named sink
    would be WRONG — e.g. a multi-process bring-up before this process
    knows its index, where N workers would all truncate one shared path
    (the JAX package's multihost bring-up re-aims, then resumes).
    Explicit :func:`configure` calls are unaffected."""
    global _suspended
    _suspended += 1


def resume_env_bootstrap() -> None:
    global _suspended
    _suspended = max(0, _suspended - 1)


def _bootstrap() -> None:
    global _bootstrapped
    if _suspended:
        return   # stay un-bootstrapped: retry after the suspension lifts
    _bootstrapped = True
    path = os.environ.get("PLUSS_TELEMETRY")
    if path:
        configure(path, os.environ.get("PLUSS_PROM") or None)


def configure(path: str | None, prom_path: str | None = None
              ) -> Telemetry | None:
    """Install (or with ``path=None``, re-read ``PLUSS_TELEMETRY``/
    ``PLUSS_PROM`` from the environment for) the process-wide session.
    An existing session is closed first — one sink at a time.  An
    unopenable sink path (read-only fs, bad component) warns and leaves
    telemetry DISABLED instead of raising: observability must never
    abort the run it would have observed, not even at open time."""
    global _active, _bootstrapped, _atexit_registered
    if path is None:
        _bootstrapped = False
        shutdown()
        _bootstrap()
        return _active
    shutdown()
    _bootstrapped = True
    try:
        _active = Telemetry(path, prom_path
                            or os.environ.get("PLUSS_PROM") or None)
    except OSError as e:
        print(f"telemetry: cannot open sink {path} ({e}); telemetry "
              "disabled", file=sys.stderr)
        return None
    if not _atexit_registered:
        _atexit_registered = True
        atexit.register(shutdown)
    return _active


def shutdown() -> None:
    """Flush metrics, close the sink, and disable telemetry."""
    global _active
    t = _active
    _active = None
    if t is not None:
        t.close()


def active() -> Telemetry | None:
    if not _bootstrapped:
        _bootstrap()
    return _active


def configured() -> bool:
    """Whether a session is already installed, WITHOUT triggering the
    lazy env bootstrap — for probes inside bootstrap-sensitive windows
    (a multi-process bring-up deciding whether to suspend it)."""
    return _active is not None


def enabled() -> bool:
    return active() is not None


def counter_add(name: str, value: float = 1) -> None:
    t = _active if _bootstrapped else active()
    if t is not None:
        t.counter_add(name, value)


def gauge_set(name: str, value: float) -> None:
    t = _active if _bootstrapped else active()
    if t is not None:
        t.gauge_set(name, value)


def event(name: str, **attrs) -> None:
    t = _active if _bootstrapped else active()
    if t is not None:
        t.event(name, **attrs)


def span(name: str, **attrs):
    """A context-manager span, or the shared no-op when disabled."""
    t = _active if _bootstrapped else active()
    if t is None:
        return NOOP_SPAN
    return t.span(name, **attrs)


def tally_span(name: str):
    """A span of work repeated inside an enclosing span (a window of a
    dispatch), recorded once per name per enclosing span (:class:`_Tally`),
    or the shared no-op when disabled."""
    t = _active if _bootstrapped else active()
    if t is None:
        return NOOP_SPAN
    return t.tally_span(name)


def counters() -> dict[str, float]:
    """Cumulative counter snapshot ({} when disabled) — bench uses deltas
    of this around a measured region to stamp its metric lines."""
    t = _active if _bootstrapped else active()
    return t.counters() if t is not None else {}


def gauges() -> dict[str, float]:
    t = _active if _bootstrapped else active()
    return t.gauges() if t is not None else {}


def flush_metrics() -> None:
    t = _active if _bootstrapped else active()
    if t is not None:
        t.flush_metrics()


def trace_event(name: str, **attrs) -> None:
    """An event emitted ONLY when a request trace context is bound.

    The attribution hook of the cache layers (plan cache, residency,
    autotune): inside a serve request the hit/miss lands in the stream
    stamped ``trace=<rid>``; outside one (engine tests, CLI runs) nothing
    is emitted, so those streams are what they were without it.  The
    telemetry None-check comes first, keeping the disabled path free of
    any context lookup."""
    t = _active if _bootstrapped else active()
    if t is not None and tracectx.current() is not None:
        t.event(name, **attrs)


def ensure_session() -> Telemetry:
    """The active session, creating a MEMORY-ONLY one (no sink file) if
    telemetry is disabled.  The serve daemon calls this so its flight
    recorder can ring-buffer records for post-mortems even when the
    operator never armed ``--telemetry`` — the memory session writes no
    bytes anywhere until a dump is triggered."""
    global _active, _bootstrapped, _atexit_registered
    t = active()
    if t is not None:
        return t
    _bootstrapped = True
    _active = Telemetry(None)
    if not _atexit_registered:
        _atexit_registered = True
        atexit.register(shutdown)
    return _active
