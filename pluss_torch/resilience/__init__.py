"""Resilience layer of the port: classified failures, degradation ladders,
checkpoints.

The port's copy of ``pluss.resilience``:

- :mod:`pluss_torch.resilience.errors` — the ``PlussError`` taxonomy
  (``retryable`` / ``degradable`` / ``fatal``) and :func:`classify`, which
  maps ``torch.OutOfMemoryError``, failed kernel builds, the engine's
  budget guard, connection failures and trace ``DataLoss`` into it;
- :mod:`pluss_torch.resilience.faults` — the deterministic fault injector
  (``PLUSS_FAULT_PLAN="oom@2,corrupt_cache"``) behind named sites in the
  engine, the sharded backend, the plan cache, the trace feed and the
  multihost bring-up and heartbeat;
- :mod:`pluss_torch.resilience.ladder` — the degradation-ladder executors
  :func:`run_resilient` and :func:`replay_file_resilient`, which stamp
  every result with the rungs taken;
- :mod:`pluss_torch.resilience.journal` — the atomic JSONL journal behind
  ``pack_file``'s resume and ``sweep --resume``;
- :mod:`pluss_torch.resilience.breaker` — the device circuit breaker the
  serving layer wraps around device dispatch (closed → open after N
  classified failures in a window → half-open probe).

The JAX package's ``ShareCapOverflow`` has no counterpart (the port has no
share cap).
"""

from __future__ import annotations

from pluss_torch.resilience.errors import (
    CacheCorrupt,
    CollectiveError,
    CompileError,
    DataLoss,
    DeadlineExceeded,
    InvalidRequest,
    Overloaded,
    PlussError,
    ResourceExhausted,
    WorkerDied,
    classify,
)
from pluss_torch.resilience.breaker import CircuitBreaker
from pluss_torch.resilience.faults import FaultPlan
from pluss_torch.resilience.journal import Journal
from pluss_torch.resilience.ladder import (
    LADDER,
    SERVE_LADDER,
    SHARD_LADDER,
    Retry,
    replay_file_resilient,
    run_resilient,
)

__all__ = [
    "PlussError", "ResourceExhausted", "CompileError", "CollectiveError",
    "WorkerDied", "DataLoss", "CacheCorrupt", "Overloaded",
    "DeadlineExceeded", "InvalidRequest", "classify", "CircuitBreaker",
    "FaultPlan",
    "Journal", "LADDER", "SERVE_LADDER", "SHARD_LADDER", "Retry",
    "run_resilient",
    "replay_file_resilient",
]
