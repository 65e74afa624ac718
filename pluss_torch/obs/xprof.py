"""Optional profiler integration: ``torch.profiler`` sessions + annotations.

The port's counterpart of ``pluss/obs/xprof.py``.  ``PLUSS_XPROF=<dir>``
arms both halves:

- :func:`session` — a refcounted ``torch.profiler`` session around a
  top-level operation (engine run, trace replay).  Refcounted because
  sessions cannot nest: only the outermost enter starts the profiler, and
  only the outermost exit stops it and writes a Chrome trace
  (``pluss_torch-<pid>-<n>.json``, open it in ``chrome://tracing`` or
  Perfetto) into the directory.
- :func:`annotate` — a named ``torch.profiler.record_function`` range
  around one dispatch, so the timeline labels each run or slice with the
  operation that issued it.

With the variable unset both are near-free no-ops (one ``environ.get`` +
``None`` check), and any profiler failure degrades to a no-op with one
stderr notice: observability must never sink the run it observes.
:func:`chrome_trace` profiles one region into a directory it is given
(the CLI's ``--profile DIR``), under the same rule.
:func:`profiler` is the one place the port builds a profiler (host
operations, plus the card's when there is one): ``pluss_torch.profile``
reads its device times through it as well.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading

_lock = threading.Lock()
_depth = 0
_broken = False
#: the running session's profiler; module state, not per-frame: with
#: overlapping sessions on different threads exiting out of order, the
#: frame that drops _depth to 0 need not be the frame that started it
_prof = None
_n_traces = 0


def _dir() -> str | None:
    return os.environ.get("PLUSS_XPROF") or None


def enabled() -> bool:
    return _dir() is not None and not _broken


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
    global _depth, _broken, _prof, _n_traces
    d = _dir()
    if d is None or _broken:
        yield
        return
    with _lock:
        _depth += 1
        if _depth == 1 and _prof is None:
            try:
                os.makedirs(d, exist_ok=True)
                prof = profiler()
                prof.start()
                _prof = prof
            except Exception as e:  # profiler unusable: degrade, don't sink
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
    prof = None
    try:
        os.makedirs(directory, exist_ok=True)
        prof = profiler()
        prof.start()
    except Exception as e:  # profiler unusable: report, don't sink the run
        prof = None
        print(f"xprof: starting torch.profiler into {directory} failed: "
              f"{e}", file=sys.stderr)
    try:
        yield
    finally:
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


def annotate(name: str):
    """Named ``record_function`` range for one dispatch (no-op when off)."""
    if _dir() is None or _broken:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)
