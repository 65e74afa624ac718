"""Warm-start layer of the port: the runtime salt and a single-flight
registry for expensive builds.

The port's copy of what ``pluss/plancache.py`` holds that has a torch
analogue:

- :func:`runtime_salt` — the identity of the runtime a tuned artifact was
  measured on: the torch and CUDA versions, the device's name and compute
  capability (``sm_XY``), and the histogram grid constant the kernels bake
  in (``nbins=49``); ``cpu`` names the host device.  The autotuner's
  sidecar (:mod:`pluss_torch.autotune`) is keyed by it, so a geometry
  measured on one card is never consulted on another.
- :class:`CompileRegistry` — in-process single-flight: N concurrent
  requests for one key run ONE build; waiters share the result or the
  SAME raised exception, so a failed build rejects every waiter with the
  identical typed error.  (``functools.lru_cache`` does not dedupe
  concurrent builds: two threads racing a cold key both build.)  The
  engine's plan memo and :func:`pluss_torch.engine.precompile` go through
  it, so the serving daemon's warm thread, its background compile and its
  device loop, and the sweep's precompile thread, plan one key once.

What the JAX module also holds has no analogue here and is not ported:
``arm_xla_cache`` (XLA's persistent compilation cache), the AOT executable
sidecars (``aot_supported``, ``aot_path``, ``aot_load``, ``aot_save``,
``LazyAotFn``) and ``_kernel_flavor``.  The port compiles no XLA programs:
its kernels are built once by ``nvcc`` into ``pluss_torch/_build/``, named
by a hash of their sources (:mod:`pluss_torch.ops.build`), and its host
plans persist in the disk plan cache (``engine._plan_cache_root``).
"""

from __future__ import annotations

import functools
import threading

from pluss_torch import obs


def runtime_salt(device=None) -> str:
    """Runtime identity of ``device`` (default: the CUDA card; with no
    card and no device this raises, as every entry point of the port
    does)."""
    from pluss_torch import engine

    dev = engine.resolve_device(device)
    if dev.type == "cuda":
        return _cuda_salt(dev.index if dev.index is not None else 0)
    return _salt(dev.type)


@functools.lru_cache(maxsize=None)
def _cuda_salt(index: int) -> str:
    import torch

    name = torch.cuda.get_device_name(index)
    major, minor = torch.cuda.get_device_capability(index)
    return _salt(f"{name}/sm_{major}{minor}")


def _salt(device_part: str) -> str:
    import torch

    from pluss_torch.config import NBINS

    return (f"torch={torch.__version__}/cuda={torch.version.cuda}/"
            f"{device_part}/nbins={NBINS}")


class _Flight:
    __slots__ = ("done", "result", "exc")

    def __init__(self):
        self.done = threading.Event()
        self.result = None
        self.exc: BaseException | None = None


class CompileRegistry:
    """Single-flight deduplication of concurrent expensive builds.

    The first caller for a key is the LEADER and runs ``build()``;
    callers arriving while that build is in flight block on it and
    receive the leader's result — or the leader's exception object
    re-raised, so a failed build rejects every waiter with the same
    typed error instead of each waiter retrying the doomed build.
    Entries are dropped on completion: failures are never cached (the
    next cold caller retries fresh) and results live in the caller's own
    memo (the engine's plan ``lru_cache``), so the registry holds no
    long-lived references.
    """

    def __init__(self, gauge: str | None = None):
        self._lock = threading.Lock()
        self._inflight: dict = {}
        self._gauge = gauge

    def inflight(self) -> int:
        """Builds currently in flight (the serve SLO publisher exports
        this as the ``serve.compile_inflight`` gauge)."""
        with self._lock:
            return len(self._inflight)

    def _publish(self) -> None:
        if self._gauge:
            obs.gauge_set(self._gauge, float(len(self._inflight)))

    def do(self, key, build):
        """Return ``build()``'s value for ``key``, building at most once
        across concurrent callers.  Do not nest ``do`` calls for one key
        inside ``build`` (the leader would wait on itself)."""
        with self._lock:
            fl = self._inflight.get(key)
            leader = fl is None
            if leader:
                fl = _Flight()
                self._inflight[key] = fl
                self._publish()
        if not leader:
            obs.counter_add("engine.compile_singleflight_waits")
            fl.done.wait()
            if fl.exc is not None:
                raise fl.exc
            return fl.result
        try:
            fl.result = build()
            return fl.result
        except BaseException as e:
            fl.exc = e
            raise
        finally:
            with self._lock:
                self._inflight.pop(key, None)
                self._publish()
            fl.done.set()
