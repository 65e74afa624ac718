"""Lenient, warn-once environment knobs (PLUSS_* tuning variables).

The port's copy of ``pluss/utils/envknob.py``.  One policy for every
layer that reads a tuning variable (the trace batching knobs and
``PLUSS_WIRE``, ``PLUSS_PLAN_CACHE_MAX``, ``PLUSS_HBM_BUDGET``, the
analysis budgets and the ``PLUSS_CACHE_*`` hierarchy knobs): a
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


def env_float(name: str, default: float, minimum: float) -> float:
    return _parse(name, os.environ.get(name, ""), default, minimum, float)


def env_choice(name: str, default: str, choices: tuple[str, ...]) -> str:
    """Enumerated env knob (e.g. PLUSS_WIRE): unknown values warn once
    and fall back to the default, same policy as the numeric knobs."""
    return _parse_choice(name, os.environ.get(name, ""), default,
                         tuple(choices))


def env_bool(name: str, default: bool | None = None) -> bool | None:
    """Boolean env knob (``PLUSS_AUTOTUNE``).  An unset knob returns
    ``default`` unchanged (None keeps it tri-state); ``0``/``false``/
    ``no``/``off`` really mean off; anything else warns once and falls
    back to the default."""
    return _parse_bool(name, os.environ.get(name, ""), default)


_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


@functools.lru_cache(maxsize=64)
def _parse_bool(name: str, raw: str, default: bool | None) -> bool | None:
    v = raw.strip().lower()
    if not v:
        return default
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    print(f"pluss_torch: ignoring malformed {name}={raw!r} (want one of "
          f"{', '.join(_TRUE + _FALSE)}); using the default {default}",
          file=sys.stderr)
    return default


def env_int_list(name: str, default: tuple[int, ...],
                 minimum: int = 1) -> tuple[int, ...]:
    """Comma-separated ascending int list (e.g. PLUSS_CACHE_LEVELS): a
    malformed element, an out-of-range value or a non-ascending order
    warns once and falls back to the whole default — a partly applied
    hierarchy would model a cache that does not exist."""
    return _parse_int_list(name, os.environ.get(name, ""), tuple(default),
                           minimum)


@functools.lru_cache(maxsize=64)
def _parse_int_list(name: str, raw: str, default: tuple[int, ...],
                    minimum: int) -> tuple[int, ...]:
    if not raw.strip():
        return default
    try:
        vs = tuple(int(x) for x in raw.split(","))
    except ValueError:
        print(f"pluss_torch: ignoring malformed {name}={raw!r}; using the "
              f"default {','.join(map(str, default))}", file=sys.stderr)
        return default
    if not vs or any(v < minimum for v in vs) \
            or any(a >= b for a, b in zip(vs, vs[1:])):
        print(f"pluss_torch: ignoring out-of-range {name}={raw!r} "
              f"(elements must be >= {minimum} and strictly ascending); "
              f"using the default {','.join(map(str, default))}",
              file=sys.stderr)
        return default
    return vs


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
