"""Crash flight recorder: a bounded ring of recent telemetry records
inside the serve daemon, dumped to disk when something goes wrong (the
port's copy of ``pluss/obs/flight.py``).

Post-mortems today require having armed ``--telemetry`` BEFORE the
incident; the events leading into a watchdog abandon or a breaker trip
are otherwise simply gone.  The flight recorder closes that gap: it taps
the telemetry session (creating a MEMORY-ONLY session when none is
configured — zero bytes written anywhere in steady state) and keeps the
last ``ring`` records in a deque.  On a trigger — watchdog abandon,
breaker open, forced drain, escaped dispatch exception — the ring is
dumped atomically to ``flight-<rid-or-ts>.jsonl`` in the configured
directory, as a VALID telemetry stream: a fresh ``meta`` record first,
the ring's records (their original timestamps and trace stamps intact),
then a cumulative counter snapshot, and NO ``end`` record — exactly the
shape of a stream truncated by a crash, which ``stats --check``
accepts (dangling span parents in a truncated stream are notes, not
violations).  ``stats flight-*.jsonl [--trace rid]`` then reads it
like any other stream.

Ring size via ``PLUSS_FLIGHT_RING`` (default 4096 records); dump
directory via the server's ``--flight-dir`` / ``PLUSS_FLIGHT_DIR``
(default: the current directory).  Dumps are throttled per reason
(default 10 s) so a flapping trigger cannot fill the disk.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time

from pluss_torch.obs import telemetry
from pluss_torch.utils.envknob import env_float, env_int

#: record kinds held in the ring: stream bodies only (a dump writes its
#: own meta, and an ``end`` would mark the dump as a finished stream,
#: turning its legitimately-dangling span parents into violations)
_RING_KINDS = ("span", "counter", "gauge", "event")


class FlightRecorder:
    """Tap → ring → atomic dump.  Thread-safe; the tap runs on every
    emitting thread and must stay O(1) (one deque append)."""

    def __init__(self, out_dir: str | None = None,
                 ring: int | None = None,
                 throttle_s: float | None = None):
        self.out_dir = out_dir or os.environ.get("PLUSS_FLIGHT_DIR") or "."
        cap = ring if ring is not None \
            else env_int("PLUSS_FLIGHT_RING", 4096, minimum=16)
        self.throttle_s = throttle_s if throttle_s is not None \
            else env_float("PLUSS_FLIGHT_THROTTLE_S", 10.0, 0.0)
        self._ring: collections.deque = collections.deque(maxlen=cap)
        self._lock = threading.Lock()
        self._tel: telemetry.Telemetry | None = None
        self._last_dump: dict[str, float] = {}
        self.dumps: list[str] = []

    # -- lifecycle ----------------------------------------------------------

    def arm(self) -> None:
        """Start recording.  Installs the tap on the active telemetry
        session, creating a memory-only one when telemetry is disabled —
        the daemon's instrumentation then feeds the ring (and nothing
        else: no sink file exists until a dump fires)."""
        if self._tel is not None:
            return
        self._tel = telemetry.ensure_session()
        self._tel.add_tap(self._tap)

    def disarm(self) -> None:
        if self._tel is not None:
            self._tel.remove_tap(self._tap)
            self._tel = None

    def _tap(self, rec: dict) -> None:
        if rec.get("ev") in _RING_KINDS:
            self._ring.append(rec)

    # -- dumping ------------------------------------------------------------

    def dump(self, reason: str, rid: str | None = None) -> str | None:
        """Write the ring as ``flight-<rid-or-ts>.jsonl``; returns the
        path, or None when throttled or the write failed (a flight dump
        must never take the daemon down with it)."""
        now = time.monotonic()
        with self._lock:
            last = self._last_dump.get(reason)
            if last is not None and now - last < self.throttle_s:
                return None
            self._last_dump[reason] = now
            snap = list(self._ring)
        tel = self._tel
        tag = _sanitize(rid) if rid else f"{time.time():.3f}"
        path = os.path.join(self.out_dir, f"flight-{tag}.jsonl")
        meta = {"ev": "meta", "schema": telemetry.SCHEMA_VERSION,
                "pid": os.getpid(), "argv": sys.argv[:8],
                "t_wall": round(time.time(), 3), "clock": "monotonic",
                "flight_reason": reason}
        if rid:
            meta["flight_trace"] = rid
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(json.dumps(meta, separators=(",", ":")) + "\n")
                for rec in snap:
                    f.write(json.dumps(rec, separators=(",", ":")) + "\n")
                if tel is not None:
                    t = round(time.monotonic() - tel._t0, 6)
                    for name, v in sorted(tel.counters().items()):
                        f.write(json.dumps(
                            {"ev": "counter", "name": name, "value": v,
                             "t": t}, separators=(",", ":")) + "\n")
            os.replace(tmp, path)
        except (OSError, TypeError, ValueError) as e:
            print(f"flight recorder: dump for {reason!r} failed: {e}",
                  file=sys.stderr)
            return None
        from pluss_torch import obs

        obs.counter_add("flight.dumps")
        obs.event("flight.dump", reason=reason, path=path,
                  records=len(snap))
        self.dumps.append(path)
        print(f"flight recorder: {reason} -> {path} "
              f"({len(snap)} ring record(s))", file=sys.stderr)
        return path


def _sanitize(rid: str) -> str:
    out = "".join(c if c.isalnum() or c in "-_." else "_" for c in rid)
    return out[:80] or "rid"
