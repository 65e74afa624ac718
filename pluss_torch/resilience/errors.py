"""Structured error taxonomy: every failure a resilient entry point can see.

The port's copy of ``pluss/resilience/errors.py``.  Every
:class:`PlussError` carries three bits:

- ``retryable``  — the SAME attempt may succeed if repeated: transient
  collective failures, quarantined cache entries;
- ``degradable`` — repeating identically fails again, but a degradation
  rung (smaller windows, sliced dispatch, the CPU) routes around it:
  device out-of-memory, a failed kernel build (on the CPU only: see
  :class:`CompileError`);
- ``fatal``      — neither: the input itself is broken (a truncated trace)
  or every rung is spent.  Fatal errors still propagate *classified*, with
  the site and the cause.

:func:`classify` is the one funnel from raw exceptions into the taxonomy.
It maps by type first — ``torch.OutOfMemoryError`` (what the CUDA caching
allocator raises) to :class:`ResourceExhausted`, a failed ``nvcc`` build
(:class:`pluss_torch.ops.build.BuildError`) to :class:`CompileError` —
then by the JAX package's message markers, so the engine's plan-time
budget guard ("... GiB device budget.") is a :class:`ResourceExhausted`
too.  The ladder and the tests key on the resulting types.

The port has no share cap (its share uniques are exact, with no fixed
per-window capacity to overflow), so the JAX package's
``ShareCapOverflow`` class and the share-cap branch of ``classify`` have
no counterpart here.
"""

from __future__ import annotations

import os
import sys


class PlussError(Exception):
    """Base of the classified-failure taxonomy.

    ``site`` names where the failure surfaced (an injection-site name such
    as ``engine.run`` or ``trace.read_batch``); ``cause`` keeps the raw
    exception (also chained via ``__cause__`` when classified by
    :func:`classify`).
    """

    retryable = False
    degradable = False

    def __init__(self, message: str, site: str = "",
                 cause: BaseException | None = None):
        super().__init__(message)
        self.site = site
        self.cause = cause

    @property
    def fatal(self) -> bool:
        return not (self.retryable or self.degradable)

    def __str__(self) -> str:
        base = super().__str__()
        return f"[{self.site}] {base}" if self.site else base


class ResourceExhausted(PlussError):
    """Device (or host) memory exhausted: ``torch.OutOfMemoryError``, the
    engine's sort-budget guard, ``MemoryError``, or a request that can
    never fit its budget (the residency store's ``reserve``).  Degradable:
    the ladder shrinks windows / concurrency until the allocation fits."""

    degradable = True


class CompileError(PlussError):
    """A kernel failed to build (``nvcc``), or the ``compile`` fault fired.
    Degradable, as in the JAX package, for an attempt on the CPU; the
    ladder raises it at once for an attempt on the card, where no rung
    mends a build and the CPU rung would hide the card."""

    degradable = True


class CollectiveError(PlussError):
    """Distributed bring-up or collective communication failed (connect
    timeout, refused connection).  Retryable with backoff."""

    retryable = True


class WorkerDied(PlussError):
    """A participating process stopped heartbeating.  Degradable — the
    coordinator re-runs on its local devices.  ``process_ids`` lists the
    dead processes when known."""

    degradable = True

    def __init__(self, message: str, site: str = "",
                 cause: BaseException | None = None,
                 process_ids: tuple[int, ...] = ()):
        super().__init__(message, site, cause)
        self.process_ids = process_ids


class DataLoss(PlussError):
    """Input bytes are missing or garbled (truncated u64 trace or pack,
    garbage text line).  Fatal: no retry can invent the missing data; the
    message names the byte offset, line or record so the operator can
    repair or re-capture."""


class CacheCorrupt(PlussError):
    """A rebuildable artifact (a journal, a plan-cache entry) failed to
    load.  Retryable: it rebuilds from scratch."""

    retryable = True


class Overloaded(PlussError):
    """A serving admission bound is full: the request was shed before any
    work happened.  Retryable from the client's side, after backing off.

    ``retry_after_ms``, when set, names the back-off the shedding layer
    suggests (the next token of a rate-limited tenant, the breaker's next
    probe slot); ``serve.protocol.error_response`` puts it on the wire."""

    retryable = True

    def __init__(self, message: str, site: str = "",
                 cause: BaseException | None = None,
                 retry_after_ms: int | None = None):
        super().__init__(message, site, cause)
        self.retry_after_ms = retry_after_ms


class DeadlineExceeded(PlussError):
    """A deadline passed before (or while) producing the result.  Fatal for
    the attempt: the caller decides whether to ask again."""


class InvalidRequest(PlussError):
    """A request failed admission (unparseable, an unknown model, a spec
    the analyzers reject, a stream past the size bound).  Fatal;
    ``diagnostics`` carries the analyzer findings as plain dicts when the
    analyzers rejected it."""

    def __init__(self, message: str, site: str = "",
                 cause: BaseException | None = None,
                 diagnostics: tuple = ()):
        super().__init__(message, site, cause)
        self.diagnostics = diagnostics


#: substring markers of out-of-memory errors (the JAX package's, which
#: also cover the port's budget guard and the CUDA allocator's message)
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
                "OOM ", "exceeds the", "device budget")
_COMPILE_MARKERS = ("Compilation failure", "compilation failed",
                    "Mosaic compilation", "XLA compilation",
                    "INTERNAL: Failed to compile", "UNIMPLEMENTED")
_COLLECTIVE_MARKERS = ("DEADLINE_EXCEEDED", "coordination service",
                       "barrier", "collective", "UNAVAILABLE",
                       "failed to connect", "Connection refused",
                       "distributed", "heartbeat")


def classify(exc: BaseException, site: str = "") -> PlussError:
    """Map a raw exception to the taxonomy (idempotent on PlussErrors).

    The returned error chains ``exc`` as ``__cause__``/``cause``, so the
    original traceback is never lost.
    """
    if isinstance(exc, PlussError):
        if site and not exc.site:
            exc.site = site
        return exc
    import torch

    from pluss_torch.ops.build import BuildError

    msg = f"{type(exc).__name__}: {exc}"
    out: PlussError
    if isinstance(exc, (torch.OutOfMemoryError, MemoryError)):
        out = ResourceExhausted(msg, site, exc)
    elif isinstance(exc, BuildError):
        out = CompileError(msg, site, exc)
    elif _any(msg, _OOM_MARKERS):
        out = ResourceExhausted(msg, site, exc)
    elif _any(msg, _COMPILE_MARKERS):
        out = CompileError(msg, site, exc)
    elif isinstance(exc, (ConnectionError, TimeoutError)) \
            or _any(msg, _COLLECTIVE_MARKERS):
        out = CollectiveError(msg, site, exc)
    elif isinstance(exc, EOFError) or _any(msg, ("truncated", "DataLoss")):
        out = DataLoss(msg, site, exc)
    else:
        # unknown failures stay fatal-but-classified: the resilient entry
        # points re-raise them wrapped, so no raw exception escapes
        out = PlussError(msg, site, exc)
    out.__cause__ = exc
    return out


def _any(msg: str, markers: tuple[str, ...]) -> bool:
    return any(m in msg for m in markers)


def quarantine_artifact(path: str, label: str, exc: BaseException,
                        action: str = "rebuilding") -> str:
    """Policy for a corrupt artifact that can be rebuilt (a plan-cache
    entry, a replay checkpoint): rename the bad bytes to ``path +
    '.corrupt'`` so they stay diagnosable, say what happened once on
    stderr, and let the caller rebuild from scratch.  Returns the one-line
    notice (already printed)."""
    quarantine = path + ".corrupt"
    try:
        os.replace(path, quarantine)
        where = f"quarantined to {quarantine}"
    except OSError:
        where = "quarantine rename failed; left in place"
    msg = (f"{label}: corrupt artifact {path} "
           f"({type(exc).__name__}: {exc}); {where}; {action}")
    print(msg, file=sys.stderr)
    return msg
