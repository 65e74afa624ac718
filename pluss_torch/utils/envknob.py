"""Lenient, warn-once environment knobs (PLUSS_* tuning variables).

The port's copy of ``pluss/utils/envknob.py``.  One policy for every
layer that reads a tuning variable (the trace batching knobs and
``PLUSS_WIRE``, ``PLUSS_PLAN_CACHE_MAX``, ``PLUSS_HBM_BUDGET``): a
malformed or out-of-range value never crashes an import or an hours-long
run — it warns once, naming the variable, and falls back to the default.
Parsing is memoized per (knob, raw value), so a knob read from a loop
warns once, not every read.  Explicit keyword arguments at the call
sites keep their loud validation: lenience is for the environment only.
"""

from __future__ import annotations

import functools
import os
import sys


def env_int(name: str, default: int, minimum: int = 1) -> int:
    return _parse(name, os.environ.get(name, ""), default, minimum, int)


def env_choice(name: str, default: str, choices: tuple[str, ...]) -> str:
    """Enumerated env knob (e.g. PLUSS_WIRE): unknown values warn once
    and fall back to the default, same policy as the numeric knobs."""
    return _parse_choice(name, os.environ.get(name, ""), default,
                         tuple(choices))


@functools.lru_cache(maxsize=64)
def _parse_choice(name: str, raw: str, default: str,
                  choices: tuple[str, ...]) -> str:
    v = raw.strip()
    if not v:
        return default
    if v not in choices:
        print(f"pluss_torch: ignoring unknown {name}={raw!r} (choices: "
              f"{', '.join(choices)}); using the default {default!r}",
              file=sys.stderr)
        return default
    return v


@functools.lru_cache(maxsize=64)
def _parse(name: str, raw: str, default, minimum, conv):
    if not raw.strip():
        return default
    try:
        v = conv(raw)
    except ValueError:
        print(f"pluss_torch: ignoring malformed {name}={raw!r}; using the "
              f"default {default}", file=sys.stderr)
        return default
    if v < minimum:
        print(f"pluss_torch: ignoring out-of-range {name}={raw!r} (must be "
              f">= {minimum}); using the default {default}",
              file=sys.stderr)
        return default
    return v
