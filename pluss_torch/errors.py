"""Classified input errors and the corrupt-artifact policy of the port.

The port's copies of ``DataLoss`` and ``quarantine_artifact`` from
``pluss/resilience/errors.py``; the rest of that taxonomy (the resilient
entry points and their degradation ladder) is not ported yet.
"""

from __future__ import annotations

import os
import sys


class DataLoss(Exception):
    """Input bytes are missing or garbled (truncated u64 trace, garbage
    text line).  No retry can invent the missing data; the message names
    the byte or line offset so the operator can repair or re-capture.

    ``site`` names where the failure surfaced (``trace.load``)."""

    def __init__(self, message: str, site: str = ""):
        super().__init__(message)
        self.site = site

    def __str__(self) -> str:
        base = super().__str__()
        return f"[{self.site}] {base}" if self.site else base


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
