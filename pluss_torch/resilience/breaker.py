"""Device circuit breaker: fail fast when the accelerator is flapping.

The port's copy of ``pluss/resilience/breaker.py``.

A flapping device (OOM loops, a wedged runtime, a link that drops
every collective) makes each request pay the FULL failure price —
dispatch, classified error, ladder retries — before the client learns
anything.  The breaker front-runs that: after ``threshold`` classified
device failures inside a sliding ``window_s``, it *opens* and the serve
layer stops dispatching to the device at all (spec requests brown out
through a CPU-device rung, trace replays shed typed ``Overloaded``).
After a jittered ``cooldown_s`` the breaker goes *half-open* and admits
exactly one probe dispatch; a probe success closes the breaker, a probe
failure re-opens it with a doubled (capped) cooldown.

::

                 threshold failures in window_s
        closed ---------------------------------> open
          ^                                        |
          | probe ok                    cooldown   |
          |                            (jittered,  |
          |                             doubling)  v
          +------------------------------------ half-open
                        probe fails: back to open

The breaker is deliberately policy-free about WHAT counts as a failure:
callers feed it :meth:`record_failure` only for errors they classified
as device-side (``ResourceExhausted`` escaping the degradation ladder, a
watchdog-abandoned dispatch) — client errors and deadline misses must
never trip it.  Unlike the JAX package's serve layer, the port's does not
feed it ``CompileError``: there that is a hand-written kernel's failed
build, which an open breaker would turn into a CPU brown-out.

Thread-safe; all transitions are telemetry-visible as ``{name}.open`` /
``{name}.probe`` / ``{name}.close`` / ``{name}.reopen`` counters and a
``{name}.state`` gauge (0 closed / 1 half-open / 2 open), emitted only
on transition so an idle breaker writes nothing.
"""

from __future__ import annotations

import random
import threading
import time

__all__ = ["CircuitBreaker"]

#: gauge encoding of the breaker state (``{name}.state``).
STATE_CODE = {"closed": 0, "half_open": 1, "open": 2}


class CircuitBreaker:
    """Sliding-window circuit breaker with a jittered, doubling cooldown.

    Parameters
    ----------
    threshold:   classified failures inside ``window_s`` that open the
                 breaker (>= 1).
    window_s:    sliding failure-counting window, seconds.
    cooldown_s:  base open->half-open delay; each failed probe doubles
                 it (capped at ``max_cooldown_s``), a successful probe
                 resets it.
    jitter:      fractional jitter on the cooldown (0.2 -> up to +20%),
                 so a fleet of breakers doesn't probe in lockstep.
    seed:        RNG seed for the jitter; ``None`` draws from the OS so
                 real daemons desynchronize, tests pass a seed.
    name:        telemetry prefix (``serve.breaker`` in the daemon).
    clock:       injectable monotonic clock for tests.
    """

    def __init__(self, threshold: int = 5, window_s: float = 30.0,
                 cooldown_s: float = 5.0, max_cooldown_s: float = 60.0,
                 jitter: float = 0.2, seed: int | None = None,
                 name: str = "breaker", clock=time.monotonic) -> None:
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        if window_s <= 0 or cooldown_s <= 0:
            raise ValueError("window_s and cooldown_s must be > 0")
        self.threshold = int(threshold)
        self.window_s = float(window_s)
        self.base_cooldown_s = float(cooldown_s)
        self.max_cooldown_s = max(float(max_cooldown_s), float(cooldown_s))
        self.jitter = max(0.0, float(jitter))
        self.name = name
        self._clock = clock
        self._rng = random.Random(seed)
        self._lock = threading.RLock()
        self._state = "closed"
        self._failures: list[float] = []     # failure timestamps (window)
        self._cooldown_s = self.base_cooldown_s
        self._open_until = 0.0
        self._probing = False                # half-open: one probe in flight

    # ------------------------------------------------------------------
    # state

    @property
    def state(self) -> str:
        """``closed`` / ``open`` / ``half_open`` (cooldown-aware)."""
        with self._lock:
            self._tick()
            return self._state

    @property
    def state_code(self) -> int:
        return STATE_CODE[self.state]

    def retry_after_s(self) -> float:
        """Seconds until the next probe slot; 0 when not open."""
        with self._lock:
            self._tick()
            if self._state != "open":
                return 0.0
            return max(0.0, self._open_until - self._clock())

    # ------------------------------------------------------------------
    # the dispatch-side protocol: allow -> record_{success,failure}

    def allow(self) -> bool:
        """May the caller dispatch to the device right now?

        In half-open state exactly one caller gets ``True`` (the probe);
        everyone else keeps getting ``False`` until that probe resolves
        via :meth:`record_success` / :meth:`record_failure`.
        """
        with self._lock:
            self._tick()
            if self._state == "closed":
                return True
            if self._state == "open":
                return False
            if self._probing:
                return False
            self._probing = True
            self._emit_counter("probe")
            return True

    def record_success(self) -> None:
        with self._lock:
            self._tick()
            if self._state == "half_open":
                self._probing = False
                self._failures.clear()
                self._cooldown_s = self.base_cooldown_s
                self._transition("closed", "close")

    def release_probe(self) -> None:
        """Release a half-open probe that ended without device evidence.

        Every ``allow() == True`` in half-open MUST resolve — via
        :meth:`record_success`, :meth:`record_failure`, or this.  A probe
        dispatch can die in ways that say nothing about the device (a
        deadline blown inside the ladder, a client-classified error,
        every batch member already claimed by the watchdog so nothing
        dispatched at all); without this release the probe slot would
        leak and ``allow()`` would answer ``False`` forever — the
        breaker wedged half-open until process restart.  The state stays
        half-open and the NEXT caller gets the probe.  No-op unless an
        unresolved probe is actually held."""
        with self._lock:
            if self._state == "half_open" and self._probing:
                self._probing = False

    def record_failure(self) -> None:
        """One classified device failure (never client/deadline errors)."""
        with self._lock:
            self._tick()
            now = self._clock()
            if self._state == "half_open":
                # the probe failed: back off harder before the next one
                self._probing = False
                self._cooldown_s = min(self._cooldown_s * 2.0,
                                       self.max_cooldown_s)
                self._open(now, "reopen")
                return
            if self._state == "open":
                return
            self._failures.append(now)
            cutoff = now - self.window_s
            self._failures = [t for t in self._failures if t > cutoff]
            if len(self._failures) >= self.threshold:
                self._failures.clear()
                self._open(now, "open")

    # ------------------------------------------------------------------
    # internals (lock held)

    def _tick(self) -> None:
        if self._state == "open" and self._clock() >= self._open_until:
            self._probing = False
            self._transition("half_open", "half_open")

    def _open(self, now: float, counter: str) -> None:
        self._open_until = now + self._cooldown_s \
            * (1.0 + self.jitter * self._rng.random())
        self._transition("open", counter)

    def _transition(self, state: str, counter: str) -> None:
        self._state = state
        self._emit_counter(counter)
        try:                                    # keep resilience import-light
            from pluss_torch import obs

            obs.gauge_set(f"{self.name}.state", float(STATE_CODE[state]))
        except Exception:
            pass

    def _emit_counter(self, counter: str) -> None:
        try:
            from pluss_torch import obs

            obs.counter_add(f"{self.name}.{counter}")
        except Exception:
            pass
