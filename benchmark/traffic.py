"""The one traffic generator: a mix file's parameters -> the predictions.

Every cell is a closed loop with one client: the next prediction starts
when the previous one has ended.  A mix (``benchmark/traffic/<mix>.json``)
says what each prediction runs:

- ``"run"``: on a loop nest, ``"full"`` (every access, ``engine.run``) or
  ``"sampled"`` (``sampling.sampled_run``'s uniform estimate at ``"rate"``,
  the one the reference implements, with a new sampling seed for each
  prediction, drawn from ``--seed``); on a trace configuration
  (``"kind": "trace"``), ``"replay"`` (the trace file made in set-up from
  ``--seed``, :func:`trace_rng`, replayed whole by every prediction);
- ``"resident_cache"``: a replay's use of the program's residency store
  (default false): set-up's warm-up stages the trace into it, and every
  window prediction replays the resident copy;
- ``"schedules"``: optional ``[[thread_num, chunk_size], ...]``; each
  prediction takes the next one, from the head of the list, so every seed
  runs the same schedules (a schedule's plan cost grows with its chunk, so
  a start the seed set would change the window's work); without it every
  prediction runs the configuration's schedule;
- ``"plan_cache"``: whether the program's plan caches are on (default
  true): its disk cache, and the process's plan memo, which the harness
  clears before each prediction when off; ``"check"``: how many distinct predictions, drawn from the seed,
  the reference checks (default 1).

The set-up warms one prediction of the cell's own shape: the
configuration's schedule, and a sampling seed no window prediction gets
(a replay: the same trace).

A served configuration (``"kind": "serve"``) takes an open loop instead,
``"run": "open"`` (:func:`arrivals`): requests are sent on a schedule
whether or not earlier ones have been answered, at ``"rate_per_s"``
requests a second, one every ``1 / rate_per_s`` seconds, each to a tenant
of the configuration; a request with no answer ``"timeout_s"`` seconds
after it was due (default 120) has failed.  :mod:`benchmark.serve` runs it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

RUNS = ("full", "sampled", "replay")
KEYS = {"run", "rate", "schedules", "plan_cache", "check", "resident_cache"}
OPEN = "open"
OPEN_KEYS = {"run", "rate_per_s", "timeout_s"}


@dataclasses.dataclass(frozen=True)
class Prediction:
    """One prediction's input: the schedule, and for a sampled run its
    sampling seed (the mix gives the rate).  A replay's input is the trace
    alone: every replay prediction is ``Prediction(0, 0)``."""

    thread_num: int
    chunk_size: int
    sample_seed: int | None = None

    @property
    def key(self) -> tuple:
        return (self.thread_num, self.chunk_size, self.sample_seed)


def check_mix(mix: dict, config: dict) -> None:
    """Refuse a mix the generator cannot run on ``config``, before any
    set-up."""
    serve = config.get("kind") == "serve"
    if serve or mix.get("run") == OPEN:
        _check_open(mix, serve)
        return
    if set(mix) - KEYS:
        raise ValueError(f"unknown traffic keys {sorted(set(mix) - KEYS)}; "
                         f"known: {sorted(KEYS)}")
    if mix.get("run") not in RUNS:
        raise ValueError(f"traffic 'run' must be one of {RUNS}, got "
                         f"{mix.get('run')!r}")
    trace = config.get("kind") == "trace"
    if (mix["run"] == "replay") != trace:
        raise ValueError(f"a {mix['run']!r} mix cannot run on a "
                         f"{'trace' if trace else 'loop-nest'} configuration")
    if "resident_cache" in mix and (mix["run"] != "replay" or not
                                    isinstance(mix["resident_cache"], bool)):
        raise ValueError("'resident_cache' is a replay's, true or false")
    if mix["run"] == "sampled" and not 0 < float(mix.get("rate", 0)) <= 1:
        raise ValueError("a sampled mix needs a 'rate' in (0, 1]")
    for s in mix.get("schedules") or ():
        if len(s) != 2 or min(s) < 1:
            raise ValueError(f"bad schedule {s!r}: [thread_num, chunk_size]")


def _check_open(mix: dict, serve: bool) -> None:
    if not serve:
        raise ValueError("an 'open' mix runs only on a serve configuration")
    if mix.get("run") != OPEN:
        raise ValueError(f"a {mix.get('run')!r} mix cannot run on a serve "
                         "configuration; it takes an 'open' mix")
    if set(mix) - OPEN_KEYS:
        raise ValueError(f"unknown open traffic keys "
                         f"{sorted(set(mix) - OPEN_KEYS)}; known: "
                         f"{sorted(OPEN_KEYS)}")
    if not float(mix.get("rate_per_s", 0)) > 0:
        raise ValueError("an open mix needs a 'rate_per_s' above 0")
    if not float(mix.get("timeout_s", 120)) > 0:
        raise ValueError("an open mix's 'timeout_s' is above 0")


def _seq(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed % (1 << 64), stream]))


def trace_rng(seed: int) -> np.random.Generator:
    """The generator a trace configuration's file is written from."""
    return _seq(seed, 3)


def warmup(mix: dict, config: dict, seed: int) -> Prediction:
    if mix["run"] == "replay":
        return Prediction(0, 0)
    s = _seq(seed, 1).integers(0, 1 << 31) if mix["run"] == "sampled" \
        else None
    return Prediction(config["thread_num"], config["chunk_size"],
                      None if s is None else int(s))


def predictions(mix: dict, config: dict, seed: int):
    """The window's predictions, endless, in order."""
    scheds = mix.get("schedules")
    draw = _seq(seed, 0)
    i = 0
    while True:
        if mix["run"] == "replay":
            yield Prediction(0, 0)
            continue
        if scheds:
            T, CS = scheds[i % len(scheds)]
        else:
            T, CS = config["thread_num"], config["chunk_size"]
        s = int(draw.integers(0, 1 << 31)) if mix["run"] == "sampled" \
            else None
        yield Prediction(T, CS, s)
        i += 1


def checked(keys: list, mix: dict, seed: int) -> list:
    """The distinct prediction inputs the reference checks: ``check`` of
    them (all, when fewer ran), drawn from the seed."""
    distinct = sorted(set(keys), key=keys.index)
    n = min(len(distinct), int(mix.get("check", 1)))
    pick = _seq(seed, 2).choice(len(distinct), n, replace=False)
    return [distinct[i] for i in sorted(pick.tolist())]


def arrivals(mix: dict, n_tenants: int, seed: int,
             seconds: float) -> list[tuple[float, int]]:
    """An open mix's window: ``(due seconds from the window's start,
    tenant index)`` of every request due in its first ``seconds``, in due
    order.

    ``n = round(rate_per_s * seconds)`` requests (at least 1), one every
    ``seconds / n`` from 0.  The tenants are as near equal in number as
    ``n`` allows, in an order drawn from the seed.  So every seed offers
    the same arrivals and the same requests, in another order."""
    n = max(1, round(float(mix["rate_per_s"]) * seconds))
    due = np.arange(n) * (seconds / n)
    tenants = _seq(seed, 5).permutation(np.arange(n) % n_tenants)
    return list(zip(due.tolist(), tenants.tolist()))
