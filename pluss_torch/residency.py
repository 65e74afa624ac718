"""Budgeted device-resident trace store.

The port's copy of ``pluss/residency.py``.  A streamed replay pays the
host feed (read, compact, encode, copy) on every run of a trace; this
store keeps the staged trace (the ``[n_batches, bw, window, bpr]`` uint8
tensor :func:`pluss_torch.trace.stage_resident` produces) alive in device
memory across runs, so a repeat replay runs off the card's memory with no
feed at all.

The store is a process-wide singleton (:func:`store`) of read-only
entries:

- keyed by the trace layer (:func:`pluss_torch.trace._residency_key`:
  content fingerprint, size, wire version, window, batch grid, line size,
  device); a regenerated trace or another geometry misses, never serves
  stale ids;
- byte-accounted against a budget: ``PLUSS_HBM_BUDGET`` bytes, parsed
  leniently (a malformed value warns and falls back), by default half of
  the card's total memory (``torch.cuda.mem_get_info``; the JAX package
  reads the device's ``bytes_limit``), or a flat 2 GiB without a card;
- pinned by a reference count while a replay reads them;
- evicted least-recently-used first under pressure, never while pinned:
  :meth:`ResidencyStore.reserve` raises :class:`ResourceExhausted` when
  the pinned bytes leave no room, and the caller streams instead.

The JAX package's ``residency.*`` counters and resident-bytes gauge are
not ported yet (they come with the port's telemetry).
"""

from __future__ import annotations

import functools
import os
import sys
import threading
from dataclasses import dataclass, field
from typing import Any, Hashable

import torch

from pluss_torch.errors import ResourceExhausted

__all__ = ["Entry", "ResidencyStore", "budget_bytes",
           "device_budget_default", "reset", "store"]

#: share of the card's memory the store may claim without PLUSS_HBM_BUDGET:
#: the replay still needs room for its line table and its batch beside it
_DEFAULT_FRACTION = 0.5
#: budget without a card (host memory is the real ceiling there)
_FALLBACK_BUDGET = 2 << 30


def device_budget_default() -> int:
    """Half the card's total memory, or a flat 2 GiB without a card."""
    if torch.cuda.is_available():
        total = torch.cuda.mem_get_info()[1]
        return max(1, int(total * _DEFAULT_FRACTION))
    return _FALLBACK_BUDGET


@functools.lru_cache(maxsize=16)
def _env_bytes(raw: str, default: int) -> int:
    """``PLUSS_HBM_BUDGET``'s value, or ``default`` with one notice on
    stderr when it is malformed or below 1 (never a crash)."""
    if not raw.strip():
        return default
    try:
        v = int(raw)
    except ValueError:
        print(f"pluss_torch: ignoring malformed PLUSS_HBM_BUDGET={raw!r}; "
              f"using the default {default}", file=sys.stderr)
        return default
    if v < 1:
        print(f"pluss_torch: ignoring out-of-range PLUSS_HBM_BUDGET={raw!r} "
              f"(must be >= 1); using the default {default}",
              file=sys.stderr)
        return default
    return v


def budget_bytes() -> int:
    """The effective byte budget (``PLUSS_HBM_BUDGET``, lenient)."""
    return _env_bytes(os.environ.get("PLUSS_HBM_BUDGET", ""),
                      device_budget_default())


@dataclass
class Entry:
    """One resident trace: a read-only device tensor plus its account.

    ``n_run``/``n_lines`` pin the replay identity (refs covered and the
    compactor's final table size): a lookup for another prefix misses,
    because a shorter prefix's ``n_lines`` is not derivable from a longer
    one's.
    """

    key: Hashable
    value: Any
    n_lines: int
    n_run: int
    nbytes: int
    meta: dict = field(default_factory=dict)
    pins: int = 0
    tick: int = 0


class ResidencyStore:
    """Thread-safe LRU byte-budgeted map of resident trace entries."""

    def __init__(self, budget: int | None = None):
        if budget is not None and (not isinstance(budget, int)
                                   or isinstance(budget, bool)
                                   or budget < 1):
            raise ValueError(f"residency budget must be a positive int of "
                             f"bytes, got {budget!r}")
        self._lock = threading.Lock()
        self._entries: dict[Hashable, Entry] = {}
        self._tick = 0
        self._budget = budget

    def budget(self) -> int:
        return self._budget if self._budget is not None else budget_bytes()

    def used_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values())

    def lookup_pin(self, key: Hashable, *,
                   n_run: int | None = None) -> Entry | None:
        """The entry for ``key``, pinned (the caller must :meth:`unpin`),
        or None.  ``n_run``, when given, must equal the entry's: a longer
        staged prefix is a miss, not a masked hit."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None or (n_run is not None and ent.n_run != n_run):
                return None
            ent.pins += 1
            self._tick += 1
            ent.tick = self._tick
            return ent

    def unpin(self, key: Hashable) -> None:
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None and ent.pins > 0:
                ent.pins -= 1

    def reserve(self, nbytes: int, *, site: str = "residency.stage") -> None:
        """Make room for ``nbytes`` more, evicting unpinned entries least
        recently used first.  Raises :class:`ResourceExhausted` when the
        budget can never hold the request, or when only pinned entries are
        left to evict."""
        budget = self.budget()
        with self._lock:
            if nbytes > budget:
                raise ResourceExhausted(
                    f"resident trace of {nbytes} bytes exceeds the device "
                    f"budget of {budget} bytes (PLUSS_HBM_BUDGET)",
                    site=site)
            while (sum(e.nbytes for e in self._entries.values()) + nbytes
                   > budget):
                victims = [e for e in self._entries.values() if e.pins == 0]
                if not victims:
                    raise ResourceExhausted(
                        f"cannot fit {nbytes} bytes under the device budget "
                        f"of {budget} bytes: every resident entry is pinned "
                        f"by a running replay", site=site)
                del self._entries[min(victims, key=lambda e: e.tick).key]

    def put(self, key: Hashable, value: Any, *, n_lines: int, n_run: int,
            nbytes: int, meta: dict | None = None) -> Entry:
        """Publish a staged value, replacing any entry of the key.  The
        producer calls :meth:`reserve` first; ``put`` checks nothing."""
        with self._lock:
            self._tick += 1
            ent = Entry(key=key, value=value, n_lines=int(n_lines),
                        n_run=int(n_run), nbytes=int(nbytes),
                        meta=dict(meta or {}), tick=self._tick)
            self._entries[key] = ent
            return ent

    def discard(self, key: Hashable) -> None:
        with self._lock:
            self._entries.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries),
                    "bytes": sum(e.nbytes for e in self._entries.values()),
                    "budget": self.budget(),
                    "pinned": sum(1 for e in self._entries.values()
                                  if e.pins > 0)}


_store: ResidencyStore | None = None
_store_lock = threading.Lock()


def store() -> ResidencyStore:
    """The process-wide residency store (made on first use)."""
    global _store
    with _store_lock:
        if _store is None:
            _store = ResidencyStore()
        return _store


def reset(budget: int | None = None) -> ResidencyStore:
    """Replace the singleton with an empty store of ``budget`` bytes
    (default: :func:`budget_bytes`).  Device memory frees once no replay
    holds an entry."""
    global _store
    with _store_lock:
        _store = ResidencyStore(budget)
        return _store
