"""Interference-aware dispatch placement: analysis drives serving.

The advisory stack STAMPS co-tenancy verdicts (PL801/PL802) onto
responses but never acts on them.  This module closes that loop: when
``PLUSS_SERVE_PLACEMENT=on``, the batcher's lead selection consults the
same static composition (:mod:`pluss_torch.analysis.interference`) and places
queued co-tenants onto dispatch windows that minimize predicted
interference — greedily choosing, among the DRR-selected tenant's
queued requests, the one whose workload composes most benignly with the
PREVIOUSLY dispatched workload (adjacent dispatch windows are the pairs
that actually share the device cache).

Strictly advisory-ORDERING, by construction:

- fairness is untouched — the DRR ring still picks which tenant is
  served; placement only reorders WITHIN that tenant's own deque;
- results are bit-identical to the advisory-only path (the A/B control,
  ``PLUSS_SERVE_PLACEMENT=off``, the default): every request is computed
  by the same engine path with the same inputs — dispatch ORDER is the
  only degree of freedom;
- any refusal (PL803-shaped pairs) or internal error degrades to cost
  0.0 / plain FIFO order, counted under ``serve.placement.errors`` —
  placement must never fail serving.

Pairwise costs are memoized per unordered dispatch-key pair (the key
already fixes spec shape + schedule + window grid), bounded the same way
as the advisory cache.
"""

from __future__ import annotations

import threading
from typing import Sequence

from pluss_torch import obs
from pluss_torch.serve.protocol import Request
from pluss_torch.utils.envknob import env_choice

#: hard bound on the pairwise-cost memo: arbitrary key pairs from a
#: long-lived daemon must not grow it forever (clear-on-overflow, same
#: discipline as the advisory cache)
_MEMO_MAX = 256

#: starvation guard: greedy min-cost picking can defer a costly-pair
#: request indefinitely while cheaper work keeps arriving.  After this
#: many consecutive pops that reorder past the SAME head request, the
#: head is served unconditionally — placement trades at most this much
#: extra queueing against any single request, structurally (counted in
#: pops, so the bound holds at any dispatch timescale).
_MAX_HEAD_SKIPS = 8


def placement_enabled() -> bool:
    """The ``PLUSS_SERVE_PLACEMENT`` knob — off by default so the
    advisory-only path stays the A/B control."""
    return env_choice("PLUSS_SERVE_PLACEMENT", "off",
                      ("off", "on")) == "on"


def pair_cost(spec_a, cfg_a, spec_b, cfg_b) -> float:
    """Predicted interference cost of running workload B's dispatch
    adjacent to workload A's: the summed miss-ratio inflation both sides
    suffer under the static co-tenancy composition.  A pair the model
    refuses (outside the composition contract) costs 0.0 — a typed
    "don't know", never a made-up number."""
    from pluss_torch.analysis import interference as itf
    from pluss_torch.analysis import ri as ri_mod

    inputs = []
    for spec, cfg in ((spec_a, cfg_a), (spec_b, cfg_b)):
        pred = ri_mod.derive(spec, cfg)
        if not pred.derivable or pred.accesses <= 0:
            return 0.0
        inputs.append(itf.WorkloadInput(
            spec.name, pred.noshare, pred.share, cfg,
            float(pred.accesses), int(pred.accesses), spec=spec))
    rep = itf.compose(inputs, cfg_a)
    return float(sum(max(v.inflation, 0.0) for v in rep.verdicts))


class Placer:
    """Greedy chain placement: remembers the last dispatched spec and
    scores candidates against it.  Thread-compatible with the single
    device loop that drives it (the memo has its own lock so stats
    readers never race it)."""

    def __init__(self):
        self._memo: dict[frozenset, float] = {}
        self._lock = threading.Lock()
        self._prev: tuple | None = None   # (batch_key, spec, cfg)
        #: (head request id, consecutive reorders past it) — the
        #: starvation guard's state
        self._head_skips: tuple[str | None, int] = (None, 0)

    def note_dispatch(self, lead: Request) -> None:
        """Record the workload that just took the device — the next
        choice minimizes interference against THIS."""
        if lead.kind == "spec" and lead.spec is not None:
            self._prev = (lead.batch_key(), lead.spec, lead.cfg)
        else:
            self._prev = None

    def choose(self, candidates: Sequence[Request]) -> int:
        """Index of the candidate to dispatch next (the admission pop's
        chooser hook).  0 — plain FIFO — whenever there is no previous
        dispatch to compose against, a single candidate, or any internal
        error."""
        prev = self._prev
        if prev is None or len(candidates) < 2:
            return 0
        try:
            costs = [self._cost(prev, r) for r in candidates]
            # min() keeps the FIRST minimum: equal-cost candidates stay
            # in FIFO order, so placement is a total no-op on uniform
            # traffic
            best = min(range(len(costs)), key=lambda i: (costs[i], i))
            head_id = getattr(candidates[0], "id", None)
            hid, skips = self._head_skips
            if hid != head_id:
                skips = 0
            if best != 0 and skips >= _MAX_HEAD_SKIPS:
                best = 0   # starvation guard: the head has waited enough
                obs.counter_add("serve.placement.head_rescues")
            self._head_skips = ((head_id, skips + 1) if best != 0
                                else (None, 0))
            obs.counter_add("serve.placement.choices")
            if best != 0:
                obs.counter_add("serve.placement.reorders")
            obs.gauge_set("serve.placement.last_cost",
                          float(costs[best]))
            return best
        except Exception:  # noqa: BLE001 — placement must never fail serving
            obs.counter_add("serve.placement.errors")
            return 0

    def _cost(self, prev: tuple, req: Request) -> float:
        if req.kind != "spec" or req.spec is None:
            return 0.0
        key = frozenset((prev[0], req.batch_key()))
        if len(key) == 1:
            # same dispatch key: it would coalesce with (or repeat) the
            # previous executable — no cross-workload interference
            return 0.0
        with self._lock:
            if key in self._memo:
                obs.counter_add("serve.placement.memo_hits")
                return self._memo[key]
        cost = pair_cost(prev[1], prev[2], req.spec, req.cfg)
        with self._lock:
            if len(self._memo) >= _MEMO_MAX:
                self._memo.clear()
            self._memo[key] = cost
        return cost
