"""The degradation ladder: bounded retry-with-backoff around every runner.

The port's counterpart of ``pluss/resilience/ladder.py``.  One executor
(:func:`run_resilient` for the sampler, :func:`replay_file_resilient` for
trace replay) owns all recovery policy:

1. classify the raw failure (:func:`pluss_torch.resilience.errors.classify`);
2. **retryable** errors repeat the same attempt under a bounded
   exponential backoff;
3. **degradable** errors descend the ladder, one rung per failure:

   ========================  =============================================
   rung                      effect
   ========================  =============================================
   ``shrink_window``         scan window /8 (more, smaller sort windows)
   ``raise_n_windows``       window /8 again (window count rises further)
   ``sliced_pipeline``       ``engine.run_sliced`` at ``thread_batch=1``
   ``cpu_fallback``          that attempt runs on the host CPU, default
                             window
   ========================  =============================================

   (the ``shard`` backend's ladder is ``shrink_window`` →
   ``single_device`` → ``cpu_fallback``; trace replay's is
   ``serial_feed`` → ``shrink_window`` → ``cpu_fallback``);
4. **fatal** errors — and a ladder that runs dry — propagate *classified*:
   a resilient entry point never leaks a raw exception.  A
   :class:`~pluss_torch.resilience.errors.CompileError` of an attempt on
   the card is fatal too: a kernel that does not build must surface, not
   move the work to the CPU.

Every rung preserves results bit for bit (window size, dispatch slicing,
feed and device are result-invariant knobs), so a degraded run's
histogram still equals the clean one; the price is speed, and the stamp
shows it: the result carries ``degradations`` (the rung names),
surfaced by ``engine.describe_path(..., degradations=)``.

Where the JAX package's ``cpu_fallback`` pins the whole process to the CPU
platform (and stamps later results ``cpu_pinned``), the port's device is
an argument of each call: the rung moves only its own attempt to the CPU,
and a later ``engine.run(spec)`` still runs on the card.  So ``cpu_pinned``
never appears here.  Plain ``engine.run`` and ``trace.replay_file`` never
fall back at all: they raise the raw error.

Before the next attempt, the loop drops the failed attempt's frame locals
(``traceback.clear_frames``): the classified error keeps the message and
the chain, but not the CUDA tensors the frames held, which would
otherwise keep device memory taken from the rung meant to fit.
"""

from __future__ import annotations

import dataclasses
import sys
import time
import traceback

from pluss_torch.resilience.errors import (
    CompileError,
    DeadlineExceeded,
    classify,
)

#: rung order of the sampler's ladder
LADDER: tuple[str, ...] = ("shrink_window", "raise_n_windows",
                           "sliced_pipeline", "cpu_fallback")

#: ladder of the device-sharded backend: degrade toward fewer devices
#: (``single_device`` is ``engine.run`` on the first listed device)
SHARD_LADDER: tuple[str, ...] = ("shrink_window", "single_device",
                                 "cpu_fallback")

#: ladder of trace replay (no thread dimension to slice): first drop the
#: parallel feed pool back to the single reader (fewer in-flight host and
#: device buffers; checkpoint-less runs also shed the compressed wire for
#: the plain pack, and the residency store), then shrink the window, then
#: leave the card
TRACE_LADDER: tuple[str, ...] = ("serial_feed", "shrink_window",
                                 "cpu_fallback")

#: ladder of a multi-tenant serving request: the sampler's without
#: ``cpu_fallback`` (a serving layer keeps every request on the device it
#: was given; a request that exhausts these rungs fails classified)
SERVE_LADDER: tuple[str, ...] = ("shrink_window", "raise_n_windows",
                                 "sliced_pipeline")


@dataclasses.dataclass
class Retry:
    """Bounded exponential backoff shared by every resilient loop.

    The sleep is full-jitter (``U(0, min(backoff*2^attempt, cap))``), so
    callers that failed together do not retry together; ``jitter_seed``
    pins the draws for reproducible tests, ``None`` seeds from the OS.
    """

    max_attempts: int = 8
    backoff_s: float = 0.05
    backoff_cap_s: float = 2.0
    jitter_seed: int | None = None

    def __post_init__(self) -> None:
        import random

        self._rng = random.Random(self.jitter_seed)

    def sleep(self, attempt: int) -> None:
        if self.backoff_s > 0:
            bound = min(self.backoff_s * (2 ** attempt),
                        self.backoff_cap_s)
            time.sleep(bound * self._rng.random())


def _log(msg: str) -> None:
    print(f"resilience: {msg}", file=sys.stderr, flush=True)


def _release_frames(exc: BaseException) -> None:
    """Clear the locals of every frame in ``exc``'s tracebacks and chain
    (a failed attempt's tensors live there), keeping the exceptions and
    their messages."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if exc.__traceback__ is not None:
            traceback.clear_frames(exc.__traceback__)
        exc = exc.__cause__ or exc.__context__


def _on_card(device) -> bool:
    """Whether an attempt with this ``device`` argument runs on the card
    (None is the card: the port's default device)."""
    import torch

    return device is None or torch.device(device).type == "cuda"


def _resilient_loop(make_attempt, apply_rung, rungs: tuple[str, ...],
                    retry: Retry, label: str, on_card,
                    deadline: float | None = None):
    """Shared control flow: returns (result, degradations tuple).

    ``make_attempt(state)`` runs one attempt from the mutable state dict;
    ``apply_rung(state, rung)`` mutates state for a degradation rung;
    ``on_card(state)`` says whether that state's attempt runs on the card.
    ``deadline``: optional ``time.monotonic()`` instant after which the
    loop stops re-attempting (raising :class:`DeadlineExceeded`); a
    running attempt is never interrupted.
    """
    degradations: list[str] = []
    rung_idx = 0
    retries = 0
    state: dict = {}
    while True:
        if deadline is not None and time.monotonic() > deadline:
            raise DeadlineExceeded(
                f"deadline passed after {retries} attempt(s)"
                + (f" (degradations: {','.join(degradations)})"
                   if degradations else ""),
                site=label)
        try:
            return make_attempt(state), tuple(degradations)
        except BaseException as e:  # noqa: BLE001 — classify funnels all
            if isinstance(e, (KeyboardInterrupt, SystemExit)):
                raise
            err = classify(e, site=label)
            _release_frames(err)
            del e
            if isinstance(err, CompileError) and on_card(state):
                raise err
            retries += 1
            if retries >= retry.max_attempts:
                _log(f"{label}: retry budget ({retry.max_attempts}) "
                     f"exhausted at {err}")
                raise err
            from pluss_torch import obs

            if err.degradable and rung_idx < len(rungs):
                rung = rungs[rung_idx]
                rung_idx += 1
                apply_rung(state, rung)
                degradations.append(rung)
                obs.counter_add("resilience.rungs_taken")
                obs.counter_add(f"resilience.rungs_taken.{rung}")
                obs.event("resilience.rung", rung=rung, label=label,
                          error=type(err).__name__,
                          cause=type(err.cause).__name__
                          if err.cause is not None else None)
                _log(f"{label}: {type(err).__name__} at "
                     f"{err.site or label}; degrading -> {rung}")
            elif err.retryable:
                obs.counter_add("resilience.retries")
                _log(f"{label}: transient {type(err).__name__}; "
                     f"retry {retries}/{retry.max_attempts}")
            else:
                raise err
            retry.sleep(retries - 1)


def run_resilient(spec, cfg=None, *, backend: str = "vmap", device=None,
                  devices=None, assignment=None, start_point=None,
                  window_accesses: int | None = None,
                  retry: Retry | None = None,
                  rungs: tuple[str, ...] | None = None,
                  deadline_s: float | None = None):
    """Degradation-ladder wrapper of ``engine.run`` and
    ``parallel.shard_run``, on ``device`` (default: the CUDA card).

    Returns the :class:`~pluss_torch.engine.SamplerResult` with
    ``degradations`` stamped (``()`` for a clean first attempt).  Raises
    only :class:`~pluss_torch.resilience.errors.PlussError` subclasses.
    ``backend``: ``vmap`` (the default), ``seq`` (``engine.run``'s one
    thread at a time) or ``shard``: ``shard_run`` over ``devices``
    (default :func:`~pluss_torch.parallel.shard.default_devices` of
    ``device``) under :data:`SHARD_LADDER`, whose ``single_device`` rung
    runs ``engine.run`` on the first listed device.  ``rungs`` overrides
    the ladder; ``deadline_s`` bounds the retry and degrade churn from now
    (a running attempt is never interrupted).
    """
    from pluss_torch.config import DEFAULT

    if backend not in ("vmap", "seq", "shard"):
        raise ValueError(f"unknown backend {backend!r} (choices: vmap, "
                         "seq, shard)")
    cfg = cfg if cfg is not None else DEFAULT
    retry = retry or Retry()
    if rungs is None:
        rungs = SHARD_LADDER if backend == "shard" else LADDER
    if backend == "shard":
        from pluss_torch.parallel.shard import _as_devices, default_devices

        devices = _as_devices(devices) if devices is not None \
            else default_devices(device=device)
        device = devices[0]

    def make_attempt(state: dict):
        from pluss_torch import engine

        kw = dict(assignment=assignment, start_point=start_point,
                  window_accesses=state.get("window", window_accesses))
        mode = state.get("mode", backend)
        if mode == "shard":
            from pluss_torch.parallel.shard import shard_run

            return shard_run(spec, cfg, devices=devices, **kw)
        kw["device"] = state.get("device", device)
        if mode == "sliced":
            return engine.run_sliced(spec, cfg, thread_batch=1, **kw)
        return engine.run(spec, cfg, backend="seq" if mode == "seq"
                          else "vmap", **kw)

    def apply_rung(state: dict, rung: str) -> None:
        from pluss_torch.engine import WINDOW_TARGET

        if rung in ("shrink_window", "raise_n_windows"):
            cur = state.get("window") or window_accesses or WINDOW_TARGET
            state["window"] = max(cur // 8, 1 << 10)
        elif rung == "sliced_pipeline":
            state["mode"] = "sliced"
        elif rung == "single_device":
            state["mode"] = "vmap"
        elif rung == "cpu_fallback":
            # this attempt only: the device is an argument of each call
            state["device"] = "cpu"
            state["mode"] = "vmap"
            state.pop("window", None)  # host memory: the default window
        else:
            raise AssertionError(f"unknown rung {rung}")

    res, degradations = _resilient_loop(
        make_attempt, apply_rung, rungs, retry,
        label=f"run[{spec.name}]",
        on_card=lambda state: _on_card(state.get("device", device)),
        deadline=(time.monotonic() + deadline_s
                  if deadline_s is not None else None))
    res.degradations = degradations
    return res


def replay_file_resilient(path: str, fmt: str = "u64", *,
                          retry: Retry | None = None,
                          rungs: tuple[str, ...] | None = None, **kw):
    """Degradation-ladder wrapper of ``trace.replay_file`` (every keyword,
    ``device`` and the checkpoint ones included, passes through).  Stamps
    ``degradations`` on the ReplayResult.  ``rungs`` overrides
    :data:`TRACE_LADDER`."""
    retry = retry or Retry()
    rungs = TRACE_LADDER if rungs is None else rungs
    ckpt = bool(kw.get("checkpoint_path"))
    if ckpt and kw.get("wire") in (None, "auto"):
        # the wire joins the checkpoint identity: resolve it once, so a
        # rung (or the CPU rung re-aiming `auto`) never re-resolves it
        # mid-run and discards the durable prefix as another run
        from pluss_torch import engine, trace

        kw = {**kw, "wire": trace._resolve_wire(
            kw.get("wire"), engine.resolve_device(kw.get("device")))}

    def make_attempt(state: dict):
        from pluss_torch import trace

        return trace.replay_file(path, fmt, **{**kw, **state})

    def apply_rung(state: dict, rung: str) -> None:
        from pluss_torch import trace

        if rung == "serial_feed":
            # the single reader: sheds the pool's in-flight batches before
            # touching the window.  Checkpoint-less runs also take the
            # plain pack (no device-side decode buffers) — the wire is part
            # of a checkpoint's identity, so a checkpointed run keeps its
            # own.  The residency store is shed too: if the failure was
            # the resident path, a retry through it fails the same way
            state["feed_workers"] = 1
            if not ckpt:
                state["wire"] = "pack"
            state["resident_cache"] = False
        elif rung == "shrink_window":
            cur = state.get("window", kw.get("window") or trace.TRACE_WINDOW)
            state["window"] = max(cur // 4, 1 << 14)
        elif rung == "cpu_fallback":
            state["device"] = "cpu"   # this attempt only
        else:
            raise AssertionError(f"unknown rung {rung}")

    res, degradations = _resilient_loop(
        make_attempt, apply_rung, rungs, retry, label=f"trace[{path}]",
        on_card=lambda state: _on_card(state.get("device",
                                                 kw.get("device"))))
    res.degradations = degradations
    return res


def degradation_label(base: str, degradations: tuple[str, ...]) -> str:
    """``describe_path``-style label with the degradation stamp appended
    (``template+sort [degraded: shrink_window,cpu_fallback]``)."""
    if not degradations:
        return base
    return f"{base} [degraded: {','.join(degradations)}]"
