"""The traced window: device busy time, the top device operations, and the
idle gaps named by what the host was doing.

Busy time is the method of ``pluss_torch/profile.py::profiled``, copied
here so the yardstick does not move with the program: the sum of every
device operation's time in ``torch.profiler``'s trace (kernels, copies
and memsets).  The device-side images of ``record_function`` ranges are
not operations and are left out.  An idle gap is a stretch of the traced
window in which no device operation ran; it is named by the innermost
benchmark span (a ``record_function`` range) around its middle, and the
host operation running there.  Each device operation is also tied to the
host operations around its launch (the profiler's correlation id names
the operator that launched it; its parents follow), so that a reader can
take the kernels of one operator, such as ``aten::sort``, whatever their
names.
"""

from __future__ import annotations

import contextlib
import sys

import torch


@contextlib.contextmanager
def span(name: str, log: list, clock):
    """A benchmark span: a ``record_function`` range for the profiler and
    a ``(name, seconds)`` record in ``log``."""
    t0 = clock()
    with torch.profiler.record_function(name):
        yield
    log.append((name, clock() - t0))


class Tracer:
    """``torch.profiler`` over whole predictions from the window's first
    on, until ``seconds`` of them are traced; then read back (again over
    the next predictions if the trace held no device operation)."""

    def __init__(self, seconds: float, clock):
        self.seconds, self.clock = seconds, clock
        self.prof = self.rf = self.t0 = None
        self.preds: list = []
        self.traced_s = None
        self.ops, self.busy_s, self.gaps = [], None, []
        self.launched: list = []

    def before(self, p) -> None:
        if self.traced_s is not None:
            return
        if self.prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            self.rf = torch.profiler.record_function("bench.trace")
            self.rf.__enter__()
            self.t0 = self.clock()
        self.preds.append(p)

    def after(self) -> None:
        if self.traced_s is None and self.prof is not None and \
                self.clock() - self.t0 >= self.seconds:
            self._stop()

    def _stop(self) -> None:
        self.rf.__exit__(None, None, None)
        traced_s = self.clock() - self.t0
        t_read = self.clock()
        self.prof.__exit__(None, None, None)
        events = self.prof.events()
        self.prof = None
        self.ops = device_ops(events)
        if self.ops:
            self.traced_s = traced_s
            self.busy_s = sum(s for _, s, _ in self.ops)
            self.gaps = idle_gaps(events)
            self.launched = launched_under(events)
        elif torch.cuda.is_available():
            # the profiler now and then returns no device events for a
            # window: trace the next predictions instead
            self.preds = []
        else:
            self.traced_s = traced_s
        print(f"benchmark: read back {traced_s:.3f} s of device trace in "
              f"{self.clock() - t_read:.3f} s", file=sys.stderr)

    def close(self) -> None:
        if self.prof is not None:
            self._stop()
        if self.traced_s is None:   # no trace read device events
            self.traced_s = 0.0


def _is_device(e) -> bool:
    """A device operation: kernels, copies and memsets, not the device-side
    image of a ``record_function`` range."""
    return e.device_type == torch.autograd.DeviceType.CUDA and \
        not getattr(e, "is_user_annotation", False)


def device_ops(events) -> list[tuple[str, float, int]]:
    """``(name, device seconds, count)`` of every device operation, the
    longest first."""
    by: dict[str, list] = {}
    for e in events:
        if _is_device(e):
            got = by.setdefault(e.name, [0.0, 0])
            got[0] += (e.time_range.end - e.time_range.start) / 1e6
            got[1] += 1
    ops = [(k, s, c) for k, (s, c) in by.items() if s > 0]
    ops.sort(key=lambda o: -o[1])
    return ops


def launched_under(events) -> list[tuple[str, float, frozenset]]:
    """``(name, device seconds, host operations)`` of every device
    operation the profiler tied to the host operation that launched it:
    that operator's name and its parents'."""
    out = []
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA or \
                not getattr(e, "kernels", None):
            continue
        names, h = set(), e
        while h is not None:
            names.add(h.name)
            h = h.cpu_parent
        names = frozenset(names)
        out.extend((k.name, k.duration / 1e6, names) for k in e.kernels)
    return out


def idle_gaps(events, top: int = 10):
    """Idle seconds of the traced window (its ``bench.window`` range)
    summed by what the host was doing, the most first; ``events`` are the
    profiler's."""
    window = next((e.time_range.start, e.time_range.end) for e in events
                  if e.name == "bench.trace" and e.device_type !=
                  torch.autograd.DeviceType.CUDA)
    dev = sorted((e.time_range.start, e.time_range.end) for e in events
                 if _is_device(e))
    host = [e for e in events if e.device_type !=
            torch.autograd.DeviceType.CUDA]
    lo, hi = window
    gaps, cur = [], lo
    for s, e in dev:
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
    if cur < hi:
        gaps.append((cur, hi))
    host.sort(key=lambda h: h.time_range.start)
    by_name: dict[str, float] = {}
    active, nxt = [], 0
    for s, e in sorted(g for g in gaps if g[1] > g[0]):
        mid = (s + e) / 2
        while nxt < len(host) and host[nxt].time_range.start <= mid:
            active.append(host[nxt])
            nxt += 1
        active = [h for h in active if h.time_range.end >= mid]
        bench = [h for h in active if h.name.startswith("bench.")]
        ops = [h for h in active if not h.name.startswith("bench.")]
        inner = lambda hs: min(hs, key=lambda h: h.time_range.end
                               - h.time_range.start).name
        name = f"{inner(bench) if bench else 'outside'}/" \
               f"{inner(ops) if ops else 'host'}"
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
