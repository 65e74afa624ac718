"""Multi-window SLO error-budget burn-rate over serve request outcomes
(the port's copy of ``pluss/obs/slo.py``).

The router tier the ROADMAP wants cannot weight daemons on cumulative
counters: ``serve.shed`` forever remembers a bad minute from last week.
What a balancer needs is *burn rate* — the fraction of the error budget
the daemon is consuming RIGHT NOW — and the standard multi-window form
(one fast window to catch a cliff, one slow window to catch a smolder)
so a transient blip doesn't flap the readiness signal.

The monitor buckets outcomes per second (``record(ok=...)``), prunes
past the slow window, and exposes ``burn(window_s)`` = (bad / total) /
``target``: burn 1.0 means failing at exactly the budgeted rate, 14.4
(the classic fast-page multiplier) means the whole month's budget would
be gone in ~2 hours.  Good/bad totals also land on the cumulative
counters ``serve.slo.good`` / ``serve.slo.bad`` for the stream record.

Transitions are the only events: when the fast or slow window crosses
its burn threshold, one ``slo.burn`` event records ``state="burning"``
(or ``"recovered"``) with the measured burn — a steady-state daemon
emits nothing, however long it burns or idles.  Live gauges
(``serve.slo.burn_fast``/``burn_slow``) are published by the server's
existing SLO publish loop, not per-request.

Knobs (:mod:`pluss_torch.utils.envknob` warn-and-default discipline):
``PLUSS_SLO_TARGET`` (budgeted bad fraction, default 0.01),
``PLUSS_SLO_FAST_S`` / ``PLUSS_SLO_SLOW_S`` (window lengths, default
60 / 600), ``PLUSS_SLO_BURN_FAST`` / ``PLUSS_SLO_BURN_SLOW`` (burn
thresholds, default 14.4 / 3.0 — the conventional paging pair), and
``PLUSS_SLO_MIN_COUNT`` (default 100): a window with fewer outcomes
than this never reports burning — a burn RATE on three requests is
noise, and paging/readiness decisions need volume behind them.
"""

from __future__ import annotations

import threading
import time

from pluss_torch import obs
from pluss_torch.utils.envknob import env_float, env_int


def _knobs() -> dict:
    return {
        "target": env_float("PLUSS_SLO_TARGET", 0.01, 1e-6),
        "fast_s": env_float("PLUSS_SLO_FAST_S", 60.0, 1.0),
        "slow_s": env_float("PLUSS_SLO_SLOW_S", 600.0, 1.0),
        "burn_fast": env_float("PLUSS_SLO_BURN_FAST", 14.4, 0.0),
        "burn_slow": env_float("PLUSS_SLO_BURN_SLOW", 3.0, 0.0),
        "min_count": env_int("PLUSS_SLO_MIN_COUNT", 100, minimum=1),
    }


class SloMonitor:
    """Per-second outcome buckets with multi-window burn-rate reads.

    ``record`` is O(1) amortized (one dict update + a prune bounded by
    elapsed seconds); ``burn`` sums at most ``window_s`` buckets.  All
    state mutates under one lock — record() is called from connection
    and device-loop threads concurrently.
    """

    def __init__(self, target: float | None = None,
                 fast_s: float | None = None,
                 slow_s: float | None = None,
                 burn_fast: float | None = None,
                 burn_slow: float | None = None,
                 min_count: int | None = None,
                 clock=time.monotonic):
        k = _knobs()
        self.target = float(target if target is not None else k["target"])
        self.fast_s = float(fast_s if fast_s is not None else k["fast_s"])
        self.slow_s = float(slow_s if slow_s is not None else k["slow_s"])
        self.slow_s = max(self.slow_s, self.fast_s)
        self.burn_fast = float(burn_fast if burn_fast is not None
                               else k["burn_fast"])
        self.burn_slow = float(burn_slow if burn_slow is not None
                               else k["burn_slow"])
        self.min_count = int(min_count if min_count is not None
                             else k["min_count"])
        self._clock = clock
        self._lock = threading.Lock()
        #: second -> [total, bad]
        self._buckets: dict[int, list[float]] = {}
        self._burning = {"fast": False, "slow": False}
        obs.gauge_set("serve.slo.target", self.target)

    # -- recording ----------------------------------------------------------

    def record(self, ok: bool) -> None:
        """One finished request outcome.  ``ok=False`` covers every way a
        request burns budget: admission shed, deadline exceeded, watchdog
        abandon, forced-drain retryable — the caller decides."""
        now = self._clock()
        sec = int(now)
        with self._lock:
            b = self._buckets.setdefault(sec, [0.0, 0.0])
            b[0] += 1
            if not ok:
                b[1] += 1
            self._prune(now)
        obs.counter_add("serve.slo.bad" if not ok else "serve.slo.good")
        self._check_transitions()

    def _prune(self, now: float) -> None:
        horizon = int(now - self.slow_s) - 1
        if len(self._buckets) > self.slow_s + 2:
            for sec in [s for s in self._buckets if s < horizon]:
                del self._buckets[sec]

    # -- reads --------------------------------------------------------------

    def _window(self, window_s: float) -> tuple[float, float]:
        now = self._clock()
        lo = int(now - window_s)
        total = bad = 0.0
        with self._lock:
            for sec, (t, b) in self._buckets.items():
                if sec >= lo:
                    total += t
                    bad += b
        return total, bad

    def burn(self, window_s: float) -> float:
        """Error-budget burn rate over the trailing window: (bad/total) /
        target.  0.0 on an idle window — no traffic burns no budget."""
        total, bad = self._window(window_s)
        if total <= 0:
            return 0.0
        return (bad / total) / self.target

    def burn_rates(self) -> tuple[float, float]:
        return self.burn(self.fast_s), self.burn(self.slow_s)

    def burning_fast(self) -> bool:
        """The readiness-gate signal: the fast window is over threshold
        (the daemon is torching its budget right now).  Volume-gated:
        below ``min_count`` outcomes in the window it reports False — a
        burn rate computed on a handful of requests is noise."""
        total, bad = self._window(self.fast_s)
        if total < self.min_count:
            return False
        return (bad / total) / self.target >= self.burn_fast

    # -- transition events --------------------------------------------------

    def _check_transitions(self) -> None:
        for window, thresh, wsec in (("fast", self.burn_fast, self.fast_s),
                                     ("slow", self.burn_slow, self.slow_s)):
            total, bad = self._window(wsec)
            if total < self.min_count:
                continue   # same volume gate as burning_fast
            rate = (bad / total) / self.target
            burning = rate >= thresh
            with self._lock:
                was = self._burning[window]
                if burning == was:
                    continue
                self._burning[window] = burning
            obs.event("slo.burn", window=window,
                      state="burning" if burning else "recovered",
                      burn=round(rate, 3), threshold=thresh)
