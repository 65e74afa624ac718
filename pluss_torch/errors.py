"""Classified errors and the corrupt-artifact policy of the port.

The port's copies of ``pluss/resilience/errors.py``'s ``PlussError`` base
(the retryable / degradable / fatal bits), ``ResourceExhausted``,
``DataLoss``, ``CacheCorrupt`` and ``quarantine_artifact``; the rest of
that taxonomy (the resilient entry points and their degradation ladder)
is not ported yet.
"""

from __future__ import annotations

import os
import sys


class PlussError(Exception):
    """Base of the classified failures.

    ``site`` names where the failure surfaced (``trace.load``,
    ``residency.stage``); ``cause`` keeps the raw exception, if any.
    ``retryable``: the same attempt may succeed if repeated;
    ``degradable``: a smaller or slower configuration routes around it;
    ``fatal``: neither.
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
    """Device (or host) memory exhausted, or a request that can never fit
    its budget (the residency store's ``reserve``).  Degradable: the
    caller streams instead, or runs smaller."""

    degradable = True


class DataLoss(PlussError):
    """Input bytes are missing or garbled (truncated u64 trace or pack,
    garbage text line).  Fatal: no retry can invent the missing data; the
    message names the byte offset, line or record so the operator can
    repair or re-capture."""


class CacheCorrupt(PlussError):
    """A rebuildable artifact (a journal) failed to load.  Retryable: it
    rebuilds from scratch."""

    retryable = True


def quarantine_artifact(path: str, label: str, exc: BaseException,
                        action: str = "rebuilding") -> str:
    """Policy for a corrupt artifact that can be rebuilt (a replay
    checkpoint): rename the bad bytes to ``path + '.corrupt'`` so they stay
    diagnosable, say what happened once on stderr, and let the caller
    rebuild from scratch.  Returns the one-line notice (already printed)."""
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
