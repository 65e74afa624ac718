"""Atomic JSONL checkpoint journal: the resume substrate of ``pack_file``.

The port's copy of ``pluss/resilience/journal.py``, line for line the same
format, so a pack journal written by either package resumes in the other.
One journal is one append-only file of JSON lines, each
``{"key": {...}, **payload}``:

- every record is a single line, written with one ``write()`` + flush +
  fsync, so a crash can only tear the final line;
- the reader drops a torn final line with a notice (the expected
  post-crash state) and raises :class:`CacheCorrupt` naming the line for a
  corrupt line anywhere else (something other than a crash touched the
  file; the journal can be deleted and rebuilt).

Keys are canonicalized (sorted-key JSON), so dict order never splits a
logical key in two.
"""

from __future__ import annotations

import json
import os
import sys

from pluss_torch.resilience.errors import CacheCorrupt


def _canon(key: dict) -> str:
    return json.dumps(key, sort_keys=True, separators=(",", ":"))


class Journal:
    """Append-only JSONL journal with canonical-key lookup."""

    def __init__(self, path: str):
        self.path = path
        self._by_key: dict[str, dict] = {}
        self._load()

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            raw = f.read()
        lines = raw.split(b"\n")
        # a trailing newline leaves one empty tail element
        if lines and lines[-1] == b"":
            lines.pop()
        for i, line in enumerate(lines):
            try:
                rec = json.loads(line)
                if not isinstance(rec, dict) or "key" not in rec:
                    raise ValueError("not a journal record")
            except ValueError as e:
                if i == len(lines) - 1:
                    print(f"pluss_torch journal: dropping torn final line "
                          f"of {self.path} (crash artifact)",
                          file=sys.stderr)
                    break
                raise CacheCorrupt(
                    f"corrupt journal line {i + 1} of {self.path}: {e} "
                    "(delete the journal to rebuild from scratch)",
                    site="journal.load", cause=e) from e
            self._by_key[_canon(rec["key"])] = rec

    def __len__(self) -> int:
        return len(self._by_key)

    def get(self, key: dict) -> dict | None:
        """The last record for ``key``, or None (later records win)."""
        return self._by_key.get(_canon(key))

    def record(self, key: dict, **payload) -> dict:
        """Append one record durably (single write + flush + fsync)."""
        rec = {"key": key, **payload}
        line = json.dumps(rec, sort_keys=True) + "\n"
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        # append mode: a crash between open and write leaves the file
        # untouched or with a torn final line, both handled by _load
        with open(self.path, "a") as f:
            f.write(line)
            f.flush()
            os.fsync(f.fileno())
        self._by_key[_canon(key)] = rec
        return rec
