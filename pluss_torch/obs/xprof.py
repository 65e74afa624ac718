"""Optional profiler integration: ``torch.profiler`` sessions.

The port's counterpart of ``pluss/obs/xprof.py``.  ``PLUSS_XPROF=<dir>``
arms :func:`session`: a refcounted ``torch.profiler`` session around a
top-level operation (engine dispatch, trace replay).  Refcounted because
sessions cannot nest: only the outermost enter starts the profiler, and
only the outermost exit stops it and writes a Chrome trace
(``pluss_torch-<pid>-<n>.json``, open it in ``chrome://tracing`` or
Perfetto) into the directory.

The timeline's names are the telemetry spans': while a profiler records,
every :func:`pluss_torch.obs.span` and every call of a
:func:`pluss_torch.obs.tally_span` opens a ``record_function`` range of
its own name (``engine.dispatch``, ``engine.sort_window``,
``trace.batch``, ...).  A session started here arms a memory-only
telemetry session (:func:`pluss_torch.obs.ensure_session`) when none is
on, so its trace carries those ranges without ``PLUSS_TELEMETRY``, and
closes it again with the profiler.

With the variable unset the session is a near-free no-op (one
``environ.get`` + ``None`` check), and any profiler failure degrades to a
no-op with one stderr notice: observability must never sink the run it
observes.  :func:`chrome_trace` profiles one region into a directory it
is given (the CLI's ``--profile DIR``), under the same rules.
:func:`profiler` is the one place the port builds a profiler (host
operations, plus the card's when there is one): ``pluss_torch.profile``
reads its device times through it as well.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading

from pluss_torch.obs import telemetry

_lock = threading.Lock()
_depth = 0
_broken = False
#: the running session's profiler; module state, not per-frame: with
#: overlapping sessions on different threads exiting out of order, the
#: frame that drops _depth to 0 need not be the frame that started it
_prof = None
#: the memory-only telemetry session the running session armed, if any
_armed = None
_n_traces = 0


def _dir() -> str | None:
    return os.environ.get("PLUSS_XPROF") or None


def enabled() -> bool:
    return _dir() is not None and not _broken


def _arm():
    """A memory-only telemetry session when none is on, so that the
    profiled region's spans open their ranges; returns it, or None when a
    session was on already."""
    if telemetry.enabled():
        return None
    return telemetry.ensure_session()


def _disarm(armed) -> None:
    """Close the session :func:`_arm` made, unless another took its
    place meanwhile."""
    if armed is not None and telemetry._active is armed:
        telemetry.shutdown()


def profiler():
    """A ``torch.profiler.profile`` of host operations, and of the CUDA
    card's when one is available."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


@contextlib.contextmanager
def session():
    """Profile the enclosed region into ``$PLUSS_XPROF`` (outermost wins)."""
    global _depth, _broken, _prof, _armed, _n_traces
    d = _dir()
    if d is None or _broken:
        yield
        return
    with _lock:
        _depth += 1
        if _depth == 1 and _prof is None:
            try:
                _armed = _arm()
                os.makedirs(d, exist_ok=True)
                prof = profiler()
                prof.start()
                _prof = prof
            except Exception as e:  # profiler unusable: degrade, don't sink
                _disarm(_armed)
                _armed = None
                _broken = True
                print(f"xprof: starting torch.profiler into {d} failed, "
                      f"disabling profiling: {e}", file=sys.stderr)
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0 and _prof is not None:
                prof, _prof = _prof, None
                _disarm(_armed)
                _armed = None
                _n_traces += 1
                out = os.path.join(
                    d, f"pluss_torch-{os.getpid()}-{_n_traces}.json")
                try:
                    prof.stop()
                    prof.export_chrome_trace(out)
                except Exception as e:
                    _broken = True
                    print(f"xprof: writing {out} failed: {e}",
                          file=sys.stderr)


@contextlib.contextmanager
def chrome_trace(directory: str):
    """Profile the enclosed region into one Chrome trace
    (``pluss_torch-<pid>-<n>.json``) in ``directory``: the CLI's
    ``--profile``.  A profiler that fails to start or to write is reported
    on stderr, and the region runs (or has run) all the same."""
    global _n_traces
    prof = armed = None
    try:
        armed = _arm()
        os.makedirs(directory, exist_ok=True)
        prof = profiler()
        prof.start()
    except Exception as e:  # profiler unusable: report, don't sink the run
        _disarm(armed)
        prof = armed = None
        print(f"xprof: starting torch.profiler into {directory} failed: "
              f"{e}", file=sys.stderr)
    try:
        yield
    finally:
        _disarm(armed)
        if prof is not None:
            with _lock:
                _n_traces += 1
                out = os.path.join(
                    directory, f"pluss_torch-{os.getpid()}-{_n_traces}.json")
            try:
                prof.stop()
                prof.export_chrome_trace(out)
            except Exception as e:
                print(f"xprof: writing {out} failed: {e}", file=sys.stderr)

