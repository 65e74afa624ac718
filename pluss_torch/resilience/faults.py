"""Deterministic seeded fault injection behind named sites.

The port's copy of ``pluss/resilience/faults.py``: the same plan grammar,
site table and seeded plans, so one ``PLUSS_FAULT_PLAN`` fires in the same
sequence in both packages.  A plan is an ordered list of ``kind[@n]``
entries — never a probability — consulted at named sites the code already
passes through:

==================  ======================  =================================
fault kind          site                    effect at the armed hit
==================  ======================  =================================
``oom``             ``engine.run``          raises ``torch.OutOfMemoryError``
                                            ("CUDA out of memory"), what the
                                            card's allocator throws
``shard_oom``       ``shard.run``           same, at the sharded entry point
``compile``         ``engine.compile``      raises a failed kernel build
                                            (``ops.build.BuildError``)
``corrupt_cache``   ``plan_cache.get``      garbles the cache file before the
                                            load (quarantine path)
``trace_loss``      ``trace.read_batch``    raises ``DataLoss`` mid-stream
``collective``      ``multihost.init``      raises a connect failure
                                            (``ConnectionError``)
``kill_worker``     ``multihost.heartbeat`` ``os._exit(43)`` on process ``n``
``hang``            ``serve.dispatch``      sleeps ``PLUSS_FAULT_HANG_S``
                                            (default 30 s): a wedged dispatch
                                            for the serve watchdog
``dispatch_fail``   ``serve.dispatch``      raises a synthetic device failure
                                            (``RESOURCE_EXHAUSTED``) before the
                                            ladder: trips the serve breaker
==================  ======================  =================================

The JAX package's ``share_cap`` kind (at ``engine.finalize``) is refused
by :meth:`FaultPlan.parse`: the port has no share cap, so the entry could
never fire, and an armed fault that never fires would pass silently.

Plan grammar (``PLUSS_FAULT_PLAN``): comma-separated ``kind`` or
``kind@n``.  ``@n`` means "fire at the n-th hit of the fault's site"
(default 1), except ``kill_worker@n`` where ``n`` is the *process index*
to kill.  Each entry fires exactly once.  Example: ``oom,oom@2`` injects
an out-of-memory error on the first two ``engine.run`` attempts (forcing
two ladder rungs).

Site checks are host-side and O(1); with no plan installed (the default)
``check()`` is a no-op.
"""

from __future__ import annotations

import dataclasses
import os

from pluss_torch.resilience.errors import DataLoss

#: fault kind -> site it arms (the single source for docs and validation)
KIND_SITE: dict[str, str] = {
    "oom": "engine.run",
    "shard_oom": "shard.run",
    "compile": "engine.compile",
    "corrupt_cache": "plan_cache.get",
    "trace_loss": "trace.read_batch",
    "collective": "multihost.init",
    "kill_worker": "multihost.heartbeat",
    "hang": "serve.dispatch",
    "dispatch_fail": "serve.dispatch",
}

#: kinds of the JAX package that the port refuses, with the reason
_REFUSED = {"share_cap": "the port has no share cap (its share uniques "
                         "are exact), so a share_cap fault could never "
                         "fire"}

#: kinds the JAX package's single-process chaos soak draws from; the
#: port's :meth:`FaultPlan.random` draws the same sequence from them
SOAK_KINDS = ("oom", "compile", "share_cap", "corrupt_cache")


@dataclasses.dataclass
class _Entry:
    kind: str
    n: int            # site hit number to fire at (kill_worker: process id)
    fired: bool = False

    @property
    def site(self) -> str:
        return KIND_SITE.get(self.kind, "")


class FaultPlan:
    """One parsed, stateful plan: per-site hit counters + one-shot entries."""

    def __init__(self, entries: list[_Entry]):
        self.entries = entries
        self.hits: dict[str, int] = {}

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        entries = []
        for tok in (t.strip() for t in text.split(",")):
            if not tok:
                continue
            kind, _, num = tok.partition("@")
            if kind in _REFUSED:
                raise ValueError(f"fault kind {kind!r} in plan {text!r} is "
                                 f"not supported: {_REFUSED[kind]}")
            if kind not in KIND_SITE:
                raise ValueError(
                    f"unknown fault kind {kind!r} in plan {text!r} "
                    f"(known: {', '.join(sorted(KIND_SITE))})")
            try:
                n = int(num) if num else 1
            except ValueError:
                raise ValueError(
                    f"bad occurrence {num!r} in {tok!r}") from None
            if n < 0 or (n < 1 and kind != "kill_worker"):
                raise ValueError(f"occurrence must be >= 1 in {tok!r}")
            entries.append(_Entry(kind, n))
        return cls(entries)

    @classmethod
    def random(cls, seed: int, n_faults: int = 2,
               kinds: tuple[str, ...] = SOAK_KINDS) -> "FaultPlan":
        """Seeded random plan, reproducible from ``seed`` alone: the JAX
        package's draw sequence.  A drawn ``share_cap`` entry is dropped
        (the port has no share cap), so the plan keeps the other draws
        where the JAX one has them."""
        import random

        rng = random.Random(seed)
        entries = [_Entry(rng.choice(kinds), rng.randint(1, 2))
                   for _ in range(n_faults)]
        return cls([e for e in entries if e.kind not in _REFUSED])

    def describe(self) -> str:
        return ",".join(f"{e.kind}@{e.n}" for e in self.entries)

    def _armed(self, site: str, bump: bool = True) -> _Entry | None:
        """The entry firing at this hit of ``site``, if any (one per hit)."""
        if bump:
            self.hits[site] = self.hits.get(site, 0) + 1
        hit = self.hits.get(site, 0)
        for e in self.entries:
            if not e.fired and e.site == site and e.n == hit \
                    and e.kind != "kill_worker":
                e.fired = True
                return e
        return None

    def check(self, site: str) -> None:
        """Raise the planned exception when an entry is armed for this hit."""
        e = self._armed(site)
        if e is None or e.kind == "corrupt_cache":
            # corruption is applied by corrupt(), not raised; the site hit
            # was still counted so @n stays meaningful
            if e is not None:
                e.fired = False  # re-arm: corrupt() consumes it
            return
        _record_fired(e, site)
        tag = f"(injected {e.kind}@{e.n} at {site})"
        if e.kind in ("oom", "shard_oom"):
            import torch

            raise torch.OutOfMemoryError(
                f"CUDA out of memory. Tried to allocate a device buffer "
                f"{tag}")
        if e.kind == "compile":
            from pluss_torch.ops.build import BuildError

            raise BuildError(f"native build failed: nvcc compilation "
                             f"failed {tag}")
        if e.kind == "trace_loss":
            raise DataLoss(f"trace bytes lost mid-stream {tag}", site=site)
        if e.kind == "hang":
            # the wedged-dispatch stand-in: block the dispatching thread
            # long enough for the serve watchdog to abandon it, then return
            # normally (the stale device loop must exit on its own)
            import time

            from pluss_torch.utils.envknob import env_float

            time.sleep(env_float("PLUSS_FAULT_HANG_S", 30.0, minimum=0.0))
            return
        if e.kind == "dispatch_fail":
            # the JAX package's message: classify maps it by its marker to
            # ResourceExhausted, the device evidence that trips the breaker
            raise RuntimeError(
                f"RESOURCE_EXHAUSTED: injected device dispatch failure "
                f"{tag}")
        if e.kind == "collective":
            raise ConnectionError(f"failed to connect to coordinator {tag}")
        raise AssertionError(f"no site of the port fires {e.kind}")

    def should_kill(self, site: str, process_index: int) -> bool:
        """True when a ``kill_worker`` entry targets this process (the
        caller performs the ``os._exit``)."""
        for e in self.entries:
            if not e.fired and e.kind == "kill_worker" and e.site == site \
                    and e.n == process_index:
                e.fired = True
                _record_fired(e, site)
                return True
        return False

    def corrupt(self, site: str, path: str) -> bool:
        """Garble ``path`` in place when a ``corrupt_cache`` entry is armed
        (counts its own site hit).  Returns True when corruption happened."""
        self.hits[site] = self.hits.get(site, 0) + 1
        hit = self.hits[site]
        for e in self.entries:
            if not e.fired and e.kind == "corrupt_cache" and e.site == site \
                    and e.n == hit:
                e.fired = True
                if os.path.exists(path):
                    with open(path, "r+b") as f:
                        f.write(b"\x00CHAOS\x00")  # clobber the pickle magic
                    _record_fired(e, site)
                    return True
        return False


def _record_fired(e: _Entry, site: str) -> None:
    """Telemetry of one injected fault actually firing: beside the
    ladder's rung events, the stream alone says what was injected and
    what recovery ran."""
    from pluss_torch import obs

    obs.counter_add("resilience.faults_fired")
    obs.counter_add(f"resilience.faults_fired.{e.kind}")
    obs.event("resilience.fault_injected", kind=e.kind, site=site, n=e.n)


# ---------------------------------------------------------------------------
# module-level plan: installed explicitly (tests) or read from the env
# (PLUSS_FAULT_PLAN), cached per env value so counters persist in-process.

_installed: FaultPlan | None = None
_env_plan: FaultPlan | None = None
_env_text: str | None = None


def install(plan: FaultPlan | None) -> None:
    """Install (or clear, with None) the process-wide fault plan."""
    global _installed
    _installed = plan


def active() -> FaultPlan | None:
    global _env_plan, _env_text
    if _installed is not None:
        return _installed
    text = os.environ.get("PLUSS_FAULT_PLAN")
    if not text:
        _env_plan = _env_text = None
        return None
    if text != _env_text:
        _env_plan, _env_text = FaultPlan.parse(text), text
    return _env_plan


def check(site: str) -> None:
    """Production-side hook: no-op unless a plan arms this site hit."""
    plan = active()
    if plan is not None:
        plan.check(site)


def corrupt(site: str, path: str) -> bool:
    plan = active()
    return plan.corrupt(site, path) if plan is not None else False


def should_kill(site: str, process_index: int) -> bool:
    plan = active()
    return plan.should_kill(site, process_index) if plan is not None \
        else False
