"""Admission control: a bounded, tenant-fair request queue that SHEDS.

The serving failure mode this module exists for: under overload an
unbounded queue converts every request into a slow request (everyone
waits behind everyone), while a blocking bounded queue converts the
ACCEPT path into the bottleneck (connection handlers wedge, clients see
silence).  The correct shape — the one every production admission layer
converges on — is a bounded queue whose ``submit`` fails FAST with a
typed :class:`~pluss_torch.resilience.errors.Overloaded` the client can key
backoff on, so the deepest a request can ever queue is ``max_queue``
dispatches' worth of work.

Fairness is two mechanisms layered on that bound:

- **Deficit round-robin pop**: requests queue per ``tenant`` id and
  ``pop`` serves the tenants in DRR order (quantum = cost = one
  request), so a flooding client fills only ITS deque — everyone else
  still gets one pop per ring pass.  A single tenant (the anonymous
  ``""`` included) degenerates to the exact old FIFO.
- **Token-bucket rate limit** at ``submit`` (``PLUSS_SERVE_TENANT_RPS``
  / ``PLUSS_SERVE_TENANT_BURST``; 0 rps = off, the default): a tenant
  over its refill rate is shed typed, and the shed carries
  ``retry_after_ms`` — the time to its next token — so clients back off
  by instruction instead of by guesswork.

The queue also owns deadline hygiene on the way OUT: ``pop`` lazily
drops requests that expired while queued (returning them separately so
the server can answer each with a typed ``DeadlineExceeded`` — a shed
response beats a mystery timeout), and ``take_matching`` lets the
batcher coalesce compatible requests from ANYWHERE in the queue onto one
dispatch — batching is the one sanctioned ordering violation, bounded by
the batcher's ``max_batch``.

Queue depth is published as the ``serve.queue_depth`` gauge on every
transition (with ``serve.queue_hbm_bytes`` and
``serve.fairness.active_tenants`` alongside); sheds count under
``serve.shed``, rate-limit sheds additionally under
``serve.fairness.rate_limited``.
"""

from __future__ import annotations

import collections
import threading
import time

from pluss_torch import obs
from pluss_torch.resilience.errors import Overloaded
from pluss_torch.serve.protocol import Request

#: DRR quantum and per-request cost.  Equal by design: every tenant with
#: queued work gets exactly one request served per ring pass — request
#: count IS the fairness currency here (admission already bounds each
#: request's device cost via the static pricing gate, so weighting by
#: predicted cost would double-charge).
_QUANTUM = 1.0
_COST = 1.0

#: hostile-tenant guard: the token-bucket table never grows past this —
#: a HARD bound.  Full, idle buckets are evicted first (they hold no
#: state a refill wouldn't recreate); when none qualify, the stalest
#: bucket by last-touch time goes instead
_MAX_BUCKETS = 4096

#: suggested client back-off for a queue-full shed, where no token-refill
#: instant exists to derive one from
_FULL_RETRY_MS = 100


class AdmissionQueue:
    """Bounded tenant-fair queue of admitted requests (thread-safe)."""

    def __init__(self, max_queue: int = 128, tenant_rps: float = 0.0,
                 tenant_burst: float | None = None):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if tenant_rps < 0:
            raise ValueError(f"tenant_rps must be >= 0, got {tenant_rps}")
        self.max_queue = max_queue
        self.tenant_rps = float(tenant_rps)
        self.tenant_burst = float(tenant_burst) if tenant_burst \
            else max(1.0, 2.0 * self.tenant_rps)
        # invariant: a tenant is in _q iff it is in _ring; pop retires
        # emptied tenants from both together
        self._q: dict[str, collections.deque[Request]] = {}
        self._ring: collections.deque[str] = collections.deque()
        self._deficit: dict[str, float] = {}
        self._buckets: dict[str, list[float]] = {}   # tenant -> [tokens, t]
        self._count = 0
        self._cv = threading.Condition()
        self._closed = False

    def __len__(self) -> int:
        with self._cv:
            return self._count

    def _gauge(self) -> None:
        obs.gauge_set("serve.queue_depth", float(self._count))
        obs.gauge_set("serve.queue_hbm_bytes",
                      float(sum(r.hbm_bytes for dq in self._q.values()
                                for r in dq)))
        obs.gauge_set("serve.fairness.active_tenants",
                      float(sum(1 for dq in self._q.values() if dq)))

    def close(self) -> None:
        """Stop admitting; queued requests stay poppable (drain)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    # ------------------------------------------------------------------
    # submit side: bound + token bucket

    def submit(self, req: Request) -> None:
        """Enqueue or shed.  Raises :class:`Overloaded` when the bound is
        reached, the queue is draining, or the request's tenant is over
        its rate limit — the caller answers the client with the typed
        error; nothing ever blocks here."""
        with self._cv:
            if self._closed:
                obs.counter_add("serve.shed")
                raise Overloaded("server is draining; not admitting",
                                 site="serve.admission")
            if self._count >= self.max_queue:
                obs.counter_add("serve.shed")
                raise Overloaded(
                    f"admission queue full ({self.max_queue} deep); "
                    "back off and retry", site="serve.admission",
                    retry_after_ms=_FULL_RETRY_MS)
            retry_ms = self._take_token(req.tenant)
            if retry_ms is not None:
                obs.counter_add("serve.shed")
                obs.counter_add("serve.fairness.rate_limited")
                raise Overloaded(
                    f"tenant {req.tenant or 'default'!r} over its rate "
                    f"limit ({self.tenant_rps:g} rps); back off",
                    site="serve.admission",
                    retry_after_ms=int(retry_ms) + 1)
            dq = self._q.get(req.tenant)
            if dq is None:
                dq = self._q[req.tenant] = collections.deque()
                self._ring.append(req.tenant)
            dq.append(req)
            self._count += 1
            self._gauge()
            self._cv.notify()

    def _take_token(self, tenant: str) -> float | None:
        """None admits (one token consumed); otherwise the milliseconds
        until this tenant's next token."""
        if self.tenant_rps <= 0:
            return None
        now = time.monotonic()
        b = self._buckets.get(tenant)
        if b is None:
            if len(self._buckets) >= _MAX_BUCKETS:
                for k in [k for k, v in self._buckets.items()
                          if v[0] >= self.tenant_burst and k not in self._q]:
                    del self._buckets[k]
                while len(self._buckets) >= _MAX_BUCKETS:
                    # hard bound: a flood of unique tenant ids leaves no
                    # bucket full (each was just decremented), so fall
                    # back to evicting the stalest by last-touch time —
                    # the forgotten debt is at most one burst, the table
                    # size is a guarantee
                    stalest = min(self._buckets,
                                  key=lambda k: self._buckets[k][1])
                    del self._buckets[stalest]
            b = self._buckets[tenant] = [self.tenant_burst, now]
        b[0] = min(self.tenant_burst,
                   b[0] + (now - b[1]) * self.tenant_rps)
        b[1] = now
        if b[0] >= 1.0:
            b[0] -= 1.0
            return None
        return (1.0 - b[0]) / self.tenant_rps * 1e3

    # ------------------------------------------------------------------
    # pop side: deficit round-robin across tenants

    def pop(self, timeout: float | None = None, chooser=None
            ) -> tuple[Request | None, list[Request]]:
        """``(head, expired)``: the next still-live request in DRR order
        (None on timeout / empty-and-closed), plus any requests that
        expired while queued — the caller owes each of those a
        ``DeadlineExceeded`` response.

        ``chooser`` (the placement hook), when given, is called with the
        served tenant's live deque as a tuple and returns the index to
        dispatch — fairness is untouched (DRR still picks WHICH tenant;
        the hook only reorders within that tenant's own backlog), and a
        misbehaving chooser degrades to FIFO."""
        expired: list[Request] = []
        with self._cv:
            while True:
                req = self._pop_drr(expired, chooser)
                if req is not None:
                    self._gauge()
                    return req, expired
                # gauge only on actual depth TRANSITIONS: an idle daemon's
                # 4 Hz poll timeout must not append an identical record to
                # the stream every 250 ms for its whole (long) life — the
                # same record-flood class as the telemetry heartbeat throttle
                if self._closed:
                    if expired:
                        self._gauge()
                    return None, expired
                if not self._cv.wait(timeout):
                    if expired:
                        self._gauge()
                    return None, expired

    def _pop_drr(self, expired: list[Request],
                 chooser=None) -> Request | None:
        """One DRR scan (lock held): serve the first tenant whose deficit
        covers a request, drain expired heads, retire emptied tenants."""
        for _ in range(len(self._ring)):
            if not self._ring:
                return None
            t = self._ring[0]
            dq = self._q.get(t)
            while dq and dq[0].expired():
                expired.append(dq.popleft())
                self._count -= 1
            if not dq:
                self._ring.popleft()
                self._q.pop(t, None)
                self._deficit.pop(t, None)
                continue
            self._deficit[t] = self._deficit.get(t, 0.0) + _QUANTUM
            if self._deficit[t] >= _COST:
                self._deficit[t] -= _COST
                idx = 0
                if chooser is not None and len(dq) > 1:
                    try:
                        idx = int(chooser(tuple(dq)))
                    except Exception:  # noqa: BLE001 — chooser is advisory
                        idx = 0
                    # head is proven live by the drain loop above; a
                    # chosen mid-queue request may have expired — leave
                    # it for the lazy drain and serve the head instead
                    if not 0 <= idx < len(dq) or dq[idx].expired():
                        idx = 0
                req = dq[idx]
                del dq[idx]
                self._count -= 1
                self._ring.rotate(-1)     # the NEXT tenant leads next pop
                return req
            self._ring.rotate(-1)
        return None

    # ------------------------------------------------------------------
    # batcher surface (key-matched coalescing across all tenants)

    def take_matching(self, key: tuple,
                      limit: int) -> tuple[list[Request], list[Request]]:
        """``(matches, expired)``: remove up to ``limit`` queued requests
        whose batch key equals ``key`` (scanning every tenant's deque:
        coalescing may jump both the FIFO and the DRR ring — a shared
        dispatch serves everyone in it at once, so it can only HELP the
        tenants it skips ahead of).  Expired MATCHING requests are
        drained too (second list; the caller owes each a
        ``DeadlineExceeded``) — leaving them queued would make the
        batcher's linger loop spin on a queue that looks non-empty but
        never yields a member."""
        if limit <= 0:
            return [], []
        out: list[Request] = []
        expired: list[Request] = []
        with self._cv:
            for t in list(self._ring):
                dq = self._q.get(t)
                if not dq:
                    continue
                kept: collections.deque[Request] = collections.deque()
                while dq and len(out) < limit:
                    req = dq.popleft()
                    if req.batch_key() != key:
                        kept.append(req)
                    elif req.expired():
                        expired.append(req)
                    else:
                        out.append(req)
                kept.extend(dq)
                self._q[t] = kept
                if len(out) >= limit:
                    break
            self._count -= len(out) + len(expired)
            if out or expired:
                self._gauge()
        return out, expired

    def wait_for_arrival(self, timeout: float) -> bool:
        """Block until something (anything) is queued, up to ``timeout``.
        The batcher's adaptive delay uses this to sleep exactly until a
        coalescing candidate COULD exist instead of polling."""
        with self._cv:
            if self._count:
                return True
            self._cv.wait(timeout)
            return bool(self._count)

    def co_tenant_specs(self, key: tuple, limit: int = 4
                        ) -> list[tuple[tuple, object, object]]:
        """The co-tenants a dispatch for ``key`` would share the device
        cache with: up to ``limit`` queued spec requests with DISTINCT
        non-matching batch keys, as ``(batch_key, spec, cfg)`` triples.
        Feeds the interference advisory — a read-only peek; nothing
        is removed from the queue."""
        out: dict[tuple, tuple] = {}
        with self._cv:
            for dq in self._q.values():
                for r in dq:
                    if r.kind != "spec" or r.spec is None:
                        continue
                    k = r.batch_key()
                    if k == key or k in out:
                        continue
                    out[k] = (k, r.spec, r.cfg)
                    if len(out) >= limit:
                        return list(out.values())
        return list(out.values())

    def has_other_work(self, key: tuple) -> bool:
        """Whether a NON-matching request is queued — the adaptive batch
        window closes early when holding the dispatch would add latency
        to somebody else's unrelated work."""
        with self._cv:
            return any(r.batch_key() != key
                       for dq in self._q.values() for r in dq)
