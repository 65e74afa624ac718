"""Crash-safe serve request journal: admission writes, recovery replays.

The daemon's crash-only story: every accepted (non-sleep) request is
appended to an atomic JSONL journal *before* it can reach the device
loop, and marked ``done`` on the first reply.  A SIGKILLed daemon
restarted on the same ``--journal-dir`` replays the still-open entries
through normal admission and parks the answers for reconnecting clients
(``{"op": "result", "id": rid}``) — the PAPER's no-re-execution premise
extended across process death: completed entries are never re-dispatched
and recovered answers are bit-identical to a clean run.

Same file discipline as :class:`pluss_torch.resilience.journal.Journal` (the
sweep journal): one record per line, single ``write`` + flush + fsync
per append, a torn FINAL line (the crash artifact) is dropped with a
warning, corruption anywhere else raises ``CacheCorrupt``.  Record
shapes::

    {"rid": "c3", "st": "open", "obj": {...wire request...},
     "tenant": "acme", "deadline_epoch": 1770000000.5}
    {"rid": "c3", "st": "done"}

Deadlines are stored as wall-clock epoch seconds — the in-process
deadline is monotonic and does not survive a restart.

A long-lived daemon can't grow the file unboundedly: once the line count
passes ``PLUSS_SERVE_JOURNAL_MAX_RECORDS`` the journal is compacted to
only the still-open records via tmp-file + ``os.replace`` (atomic on
POSIX), counted as ``serve.journal.rotations``.
"""

from __future__ import annotations

import json
import os
import sys
import threading

from pluss_torch import obs
from pluss_torch.resilience.errors import CacheCorrupt
from pluss_torch.utils.envknob import env_int

__all__ = ["RequestJournal"]


class RequestJournal:
    """Append-only rid-keyed request journal with atomic compaction."""

    def __init__(self, path: str, max_records: int | None = None) -> None:
        self.path = path
        self.max_records = max_records if max_records is not None \
            else env_int("PLUSS_SERVE_JOURNAL_MAX_RECORDS", 4096)
        self._lock = threading.Lock()
        self._open: dict[str, dict] = {}   # rid -> open record, append order
        self._n_lines = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._load()

    # ------------------------------------------------------------------
    # load / recovery

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as fh:
            raw = fh.read()
        lines = raw.split(b"\n")
        if lines and lines[-1] == b"":
            lines.pop()
        good_end = 0   # byte offset just past the last good line's \n
        for i, line in enumerate(lines):
            try:
                rec = json.loads(line)
                rid, st = rec["rid"], rec["st"]
            except (ValueError, KeyError, TypeError):
                if i == len(lines) - 1:
                    # torn final line: the crash artifact append-fsync
                    # journals are allowed to leave behind.  It must be
                    # truncated AWAY, not just skipped: _write opens in
                    # append mode, so leftover partial bytes would merge
                    # with the next record into one corrupt line — and
                    # THAT poisons the next restart as mid-file
                    # corruption (CacheCorrupt, daemon refuses to start)
                    print(f"pluss: serve journal {self.path}: dropping "
                          "torn final line (crash artifact)",
                          file=sys.stderr)
                    self._truncate(good_end)
                    break
                raise CacheCorrupt(
                    f"serve journal {self.path} line {i + 1} is corrupt; "
                    "delete the file to reset", site="serve.journal")
            good_end += len(line) + 1
            self._n_lines += 1
            if st == "open":
                self._open[rid] = rec
            else:
                self._open.pop(rid, None)
        else:
            if good_end > len(raw):
                # the final record parsed but its trailing newline was
                # torn off (the one-byte-short crash): complete the line
                # so the next append starts a fresh one
                with open(self.path, "ab") as fh:
                    fh.write(b"\n")
                    fh.flush()
                    os.fsync(fh.fileno())

    def _truncate(self, offset: int) -> None:
        with open(self.path, "r+b") as fh:
            fh.truncate(offset)
            fh.flush()
            os.fsync(fh.fileno())

    # ------------------------------------------------------------------
    # the admission-side protocol: append -> complete

    def append(self, rid: str, obj: dict, tenant: str = "",
               deadline_epoch: float | None = None) -> None:
        """Journal one accepted request (crash-safe, fsynced)."""
        rec: dict = {"rid": rid, "st": "open", "obj": obj, "tenant": tenant}
        if deadline_epoch is not None:
            rec["deadline_epoch"] = deadline_epoch
        with self._lock:
            self._write(rec)
            self._open[rid] = rec
            obs.counter_add("serve.journal.appended")
            self._maybe_compact()

    def complete(self, rid: str) -> None:
        """Mark a journaled request answered (no-op if unknown/done)."""
        with self._lock:
            if rid not in self._open:
                return
            self._write({"rid": rid, "st": "done"})
            self._open.pop(rid, None)
            obs.counter_add("serve.journal.completed")
            self._maybe_compact()

    # ------------------------------------------------------------------
    # introspection

    def unanswered(self) -> list[dict]:
        """Still-open records, in append order (the recovery worklist)."""
        with self._lock:
            return list(self._open.values())

    def is_open(self, rid: str) -> bool:
        with self._lock:
            return rid in self._open

    def __len__(self) -> int:
        with self._lock:
            return len(self._open)

    # ------------------------------------------------------------------
    # file discipline (lock held)

    def _write(self, rec: dict) -> None:
        line = json.dumps(rec, sort_keys=True,
                          separators=(",", ":")) + "\n"
        with open(self.path, "a", encoding="utf-8") as fh:
            fh.write(line)              # one write: a crash tears at most
            fh.flush()                  # the final line
            os.fsync(fh.fileno())
        self._n_lines += 1

    def _maybe_compact(self) -> None:
        # only when there is something to reclaim — a journal that is
        # all-open at the cap must not rewrite itself on every append
        if self.max_records and self._n_lines >= self.max_records \
                and self._n_lines > len(self._open):
            self._compact()

    def _compact(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            for rec in self._open.values():
                fh.write(json.dumps(rec, sort_keys=True,
                                    separators=(",", ":")) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)      # atomic: readers see old XOR new
        self._n_lines = len(self._open)
        obs.counter_add("serve.journal.rotations")
