"""Shared-dispatch batching: coalesce compatible requests onto ONE dispatch.

The windowed engine is naturally batchable in exactly one way that is
also bit-exact: requests whose plans share a compiled shape — equal
:func:`pluss_torch.engine.dispatch_key`, i.e. the same window / n_windows /
cls grid and schedule — resolve to the SAME plan and the SAME
executable, so one windowed-engine call answers all of them, and the
demux hands each member its own result view
(:meth:`~pluss_torch.engine.SamplerResult.tenant_view`).  At serving scale
this is the dominant win: a thousand tenants asking about the same
workload grid cost one dispatch, not a thousand (the amortize-compiled-
plans story of PAPER.md §0 made concrete).  Trace-replay requests
coalesce under the same rule (equal ``(path, fmt, cls, window)``).

The ADAPTIVE window is the standard max-delay/max-batch discipline:

- a batch ships immediately once ``max_batch`` members coalesce;
- otherwise the leader waits at most ``max_delay_ms`` for stragglers —
  so a singleton's worst-case added latency is one small constant;
- the wait aborts early when (a) UNRELATED work is queued (holding the
  only device loop would tax somebody else's latency), or (b) the
  leader's own deadline is tighter than the delay.

Per-batch occupancy lands in ``serve.batches`` / ``serve.batched_requests``
(their ratio is the mean occupancy) and the last batch's size in the
``serve.batch_occupancy`` gauge.
"""

from __future__ import annotations

import time

from pluss_torch import obs
from pluss_torch.obs import tracectx
from pluss_torch.serve.admission import AdmissionQueue
from pluss_torch.serve.protocol import Request


class Batcher:
    """Forms batches of compatible requests from the admission queue."""

    def __init__(self, queue: AdmissionQueue, max_batch: int = 16,
                 max_delay_ms: float = 10.0, placer=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_delay_ms < 0:
            raise ValueError(
                f"max_delay_ms must be >= 0, got {max_delay_ms}")
        self.queue = queue
        self.max_batch = max_batch
        self.max_delay_s = max_delay_ms / 1e3
        self.batching = max_batch > 1
        #: optional interference-aware placement
        #: (:class:`pluss_torch.serve.placement.Placer`): its ``choose`` steers
        #: the pop's within-tenant pick and ``note_dispatch`` records
        #: each lead so the NEXT pick composes against it
        self.placer = placer

    def next_batch(self, timeout: float | None = 0.25
                   ) -> tuple[list[Request], list[Request]]:
        """``(batch, expired)``: the next coalesced batch (possibly a
        singleton; empty on pop timeout or drained-and-closed queue) plus
        any requests found expired on the way — the server answers those
        with ``DeadlineExceeded``."""
        chooser = self.placer.choose if self.placer is not None else None
        lead, expired = self.queue.pop(timeout, chooser=chooser)
        if lead is None:
            return [], expired
        if self.placer is not None:
            self.placer.note_dispatch(lead)
        batch = [lead]
        if not self.batching or lead.kind == "sleep":
            self._account(batch)
            return batch, expired
        key = lead.batch_key()
        got, dead = self.queue.take_matching(key,
                                             self.max_batch - len(batch))
        batch += got
        expired += dead
        # adaptive linger: only worth it while the batch is short, the
        # leader can afford it, and nobody ELSE is waiting on the loop
        deadline = time.monotonic() + self.max_delay_s
        rem = lead.remaining_s()
        if rem is not None:
            # keep at least half the leader's budget for the dispatch
            deadline = min(deadline, time.monotonic() + rem / 2)
        while (len(batch) < self.max_batch
               and not self.queue.has_other_work(key)):
            wait = deadline - time.monotonic()
            if wait <= 0:
                break
            if not self.queue.wait_for_arrival(min(wait, 0.005)):
                continue
            got, dead = self.queue.take_matching(
                key, self.max_batch - len(batch))
            batch += got
            expired += dead
            if not got and not dead and self.queue.has_other_work(key):
                break
        self._account(batch)
        return batch, expired

    @staticmethod
    def _account(batch: list[Request]) -> None:
        obs.counter_add("serve.batches")
        obs.counter_add("serve.batched_requests", len(batch))
        obs.gauge_set("serve.batch_occupancy", float(len(batch)))
        if len(batch) > 1:
            # trace-linked coalesce evidence, stamped under the lead:
            # which rids shared this dispatch and who led it (the batch
            # span's `traces` attr carries the same list; this event is
            # the batcher-side half of the story)
            with tracectx.bind(batch[0].id):
                obs.trace_event("serve.coalesced", size=len(batch),
                                traces=[r.id for r in batch])
