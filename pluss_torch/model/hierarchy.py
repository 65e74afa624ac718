"""AET-exact cache-hierarchy model: multi-level, set-associative, and
non-LRU miss-ratio read-offs from ONE reuse-interval histogram.

The port's copy of ``pluss/model/hierarchy.py``.

The reference carries the AET (Average Eviction Time) histogram→MRC
conversion as an internal step of ``pluss_AET`` (PAPER.md §0.4) and
reads exactly one number off it: the fully-associative LRU curve at one
cache size.  This module productizes the conversion:

- **Multi-level read-offs** (:func:`level_readoffs`): one
  :func:`pluss_torch.mrc.aet_mrc` call prices every level of a declared
  L1/L2/LLC hierarchy (``PLUSS_CACHE_LEVELS``, KB, ascending) — global
  miss ratio per level plus the local (per-level) miss ratio
  ``MR(c_l) / MR(c_{l-1})``, the number a hierarchy simulator would
  charge each level with under inclusive LRU stacking.
- **Set-associativity** (``PLUSS_CACHE_ASSOC``): over the same survival
  map, the expected stack distance D(t) at eviction time t is the AET
  cumulative ``S(t)``; with S = C/A sets, a reuse of time t misses when
  its set collects >= A distinct intervening lines — modeled as
  P(Poisson(D(t)/S) >= A), the standard AET-A extension.  ``assoc = 0``
  (the default) means fully associative and keeps the exact LRU curve.
- **Non-LRU policy** (``PLUSS_CACHE_POLICY=random``): random
  replacement's steady state is the scalar fixed point
  ``m = [cold + sum_t cnt(t) * (1 - (1 - m/C)^t)] / total`` — each
  intervening access evicts the resident line with probability m/C.
- **Exact plateau** (:func:`aet_plateau`): the first cache size whose
  miss ratio equals the compulsory floor — exact float equality via
  :func:`pluss_torch.mrc.plateau_of`.  Where it exists it COLLAPSES the heuristic
  heuristic ``c_hi`` bracket to a point: the bracket proved the plateau
  lies in [c_lo, c_hi]; AET names the plateau itself.

Associativity and policy are approximations over an exact reuse
histogram and say so in the doc (``"model"`` field); the
fully-associative LRU read-off is the reference-exact curve.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from pluss_torch import mrc as mrc_mod
from pluss_torch.config import DEFAULT, SamplerConfig
from pluss_torch.utils.envknob import env_choice, env_int, env_int_list

#: default declared hierarchy, KB ascending: a CPU-host-shaped
#: L1 / L2 / LLC with the LLC at the SamplerConfig default cache_kb so
#: the last level's read-off is the number `cli predict` already pins
DEFAULT_LEVELS_KB = (32, 512, 2560)

_RANDOM_FP_TOL = 1e-12
_RANDOM_FP_MAX_ITERS = 200


@dataclasses.dataclass(frozen=True)
class HierarchyConfig:
    """Declared cache hierarchy: level sizes (KB, ascending), ways per
    set (0 = fully associative), replacement policy."""

    levels_kb: tuple[int, ...] = DEFAULT_LEVELS_KB
    assoc: int = 0
    policy: str = "lru"

    @classmethod
    def from_env(cls) -> "HierarchyConfig":
        """Environment knobs, envknob warn-and-default (malformed values
        must never crash an analyze/sweep/serve entry point)."""
        return cls(
            levels_kb=env_int_list("PLUSS_CACHE_LEVELS", DEFAULT_LEVELS_KB),
            assoc=env_int("PLUSS_CACHE_ASSOC", 0, minimum=0),
            policy=env_choice("PLUSS_CACHE_POLICY", "lru",
                              ("lru", "random")),
        )


def cache_geometry(cache_kb: int | None = None,
                   cache_levels: str | None = None,
                   assoc: int | None = None,
                   policy: str | None = None
                   ) -> tuple[int | None, HierarchyConfig]:
    """ONE parser for the CLI's cache-geometry surface — analyze,
    cotenancy, and tune all build their geometry here, so the three
    modes can never drift (``cli cotenancy --cache-kb`` must move the
    verdict point and ``analyze``'s ``hierarchy:`` block together).

    Returns ``(llc_kb, HierarchyConfig)``: ``llc_kb`` is the resolved
    largest-cache capacity in KB — the SamplerConfig ``cache_kb`` /
    verdict-point override — or None when neither flag names one (the
    defaults already agree: ``DEFAULT_LEVELS_KB[-1]`` is the
    SamplerConfig default).  Precedence: the ``PLUSS_CACHE_*`` env knobs
    are the base; ``cache_levels`` (``"32:512:8192"``, colon- or
    comma-separated KB ascending) and ``assoc``/``policy`` override
    them; a bare ``cache_kb`` retargets the LLC, dropping declared
    levels at or above it, so the verdict point and the hierarchy
    read-off always agree about the largest cache.  Declaring the LLC
    twice (``cache_kb`` AND ``cache_levels``) or a malformed/non-
    ascending level list raises ``ValueError`` — callers turn it into a
    usage error, never a traceback."""
    hier = HierarchyConfig.from_env()
    if cache_kb is not None and cache_levels is not None:
        raise ValueError("give --cache-kb or --cache-levels, not both "
                         "(each declares the largest cache)")
    llc_kb: int | None = None
    if cache_levels is not None:
        try:
            levels = tuple(int(t) for t in
                           cache_levels.replace(":", ",").split(",") if t)
        except ValueError:
            raise ValueError(
                f"malformed --cache-levels {cache_levels!r} (want "
                "colon- or comma-separated KB, e.g. 32:512:8192)")
        if not levels or any(k <= 0 for k in levels) \
                or list(levels) != sorted(set(levels)):
            raise ValueError(
                f"--cache-levels {cache_levels!r} must be positive and "
                "strictly ascending")
        hier = dataclasses.replace(hier, levels_kb=levels)
        llc_kb = levels[-1]
    elif cache_kb is not None:
        if cache_kb <= 0:
            raise ValueError(f"--cache-kb must be positive, got {cache_kb}")
        kept = tuple(k for k in hier.levels_kb if k < cache_kb)
        hier = dataclasses.replace(hier, levels_kb=kept + (cache_kb,))
        llc_kb = int(cache_kb)
    if assoc is not None:
        if assoc < 0:
            raise ValueError(f"--assoc must be >= 0, got {assoc}")
        hier = dataclasses.replace(hier, assoc=int(assoc))
    if policy is not None:
        if policy not in ("lru", "random"):
            raise ValueError(f"unknown cache policy {policy!r}")
        hier = dataclasses.replace(hier, policy=policy)
    return llc_kb, hier


def entries_of_kb(kb: int) -> int:
    """Cache entries (lines the AET axis counts) of a KB capacity — the
    same ``kb * 1024 / sizeof(double)`` scale as
    :attr:`pluss_torch.config.SamplerConfig.aet_cache_entries`."""
    return kb * 1024 // 8


def _stack_distance_at(rihist: dict, t: np.ndarray) -> np.ndarray:
    """Expected stack distance D(t): the AET cumulative survival
    ``S(t) = sum_{u=0..t-1} P(u)`` evaluated at times ``t`` — expected
    distinct lines touched inside a reuse window of length t."""
    ks, vs = mrc_mod.survival(rihist)
    max_rt = int(max((k for k in rihist if k >= 0), default=0))
    ends = np.append(ks[1:] - 1, max(max_rt, int(ks[-1])))
    lens = (ends - ks + 1).astype(np.float64)
    seg_cum = np.cumsum(vs * lens)
    t = np.asarray(t, np.float64)
    j = np.maximum(np.searchsorted(ks, t, side="right") - 1, 0)
    prev = np.where(j > 0, seg_cum[j - 1], 0.0)
    return prev + vs[j] * np.maximum(t - ks[j], 0.0)


def assoc_miss_ratio(rihist: dict, entries: int, assoc: int,
                     cfg: SamplerConfig = DEFAULT) -> float:
    """Set-associative miss ratio at one cache size: a reuse of time t
    misses when its set (1 of S = C/A) collects >= A of the D(t)
    expected intervening distinct lines — P(Poisson(D(t)/S) >= A).
    ``assoc >= C`` (or 0) degenerates to the exact fully-assoc curve."""
    total = float(sum(rihist.values()))
    if total == 0.0 or entries <= 0:
        return 1.0
    if assoc <= 0 or assoc >= entries:
        curve = mrc_mod.aet_mrc(rihist, cfg)
        return float(curve[min(entries, len(curve) - 1)])
    sets = max(entries // assoc, 1)
    keys = np.array(sorted(k for k in rihist if k >= 0), np.float64)
    cold = float(rihist.get(-1, 0.0))
    if keys.size == 0:
        return 1.0
    cnts = np.array([rihist[int(k)] for k in keys], np.float64)
    lam = _stack_distance_at(rihist, keys) / sets
    # P(Poisson(lam) >= A) = 1 - sum_{j<A} lam^j e^-lam / j!
    j = np.arange(assoc, dtype=np.float64)[:, None]
    lgj = np.array([math.lgamma(x + 1.0) for x in range(assoc)],
                   np.float64)[:, None]
    with np.errstate(divide="ignore"):
        logterm = j * np.log(np.maximum(lam[None, :], 1e-300)) \
            - lam[None, :] - lgj
    p_hit = np.minimum(np.exp(logterm).sum(axis=0), 1.0)
    miss = float((cnts * (1.0 - p_hit)).sum()) + cold
    return miss / total


def random_miss_ratio(rihist: dict, entries: int) -> float:
    """Random-replacement miss ratio at one cache size: the scalar fixed
    point of ``m = [cold + sum_t cnt(t) (1 - (1 - m/C)^t)] / total``."""
    total = float(sum(rihist.values()))
    if total == 0.0 or entries <= 0:
        return 1.0
    keys = np.array(sorted(k for k in rihist if k >= 0), np.float64)
    cold = float(rihist.get(-1, 0.0))
    if keys.size == 0:
        return 1.0
    cnts = np.array([rihist[int(k)] for k in keys], np.float64)
    m = 1.0
    for _ in range(_RANDOM_FP_MAX_ITERS):
        surv = (1.0 - min(m / entries, 1.0)) ** keys
        nxt = (cold + float((cnts * (1.0 - surv)).sum())) / total
        if abs(nxt - m) < _RANDOM_FP_TOL:
            return nxt
        m = nxt
    return m


def aet_plateau(rihist: dict,
                cfg: SamplerConfig = DEFAULT) -> tuple[int | None, float]:
    """(exact plateau cache size or None, compulsory floor): the AET
    curve's first index at the cold/total floor.  A non-None value is
    the EXACT point the heuristic bracket [c_lo, c_hi] only bounded."""
    curve = mrc_mod.aet_mrc(rihist, cfg)
    total = float(sum(rihist.values()))
    floor = float(rihist.get(-1, 0.0)) / total if total else 1.0
    return mrc_mod.plateau_of(rihist, curve), floor


def level_readoffs(rihist: dict, cfg: SamplerConfig = DEFAULT,
                   hier: HierarchyConfig | None = None) -> list[dict]:
    """Per-level read-offs from one histogram: for each declared level,
    its entry count (AET axis, capped at the modeled range), global miss
    ratio under the configured assoc/policy, and the local miss ratio
    relative to the previous (smaller) level."""
    hier = hier or HierarchyConfig.from_env()
    out: list[dict] = []
    curve = mrc_mod.aet_mrc(rihist, cfg)
    prev_mr: float | None = None
    for kb in hier.levels_kb:
        entries = entries_of_kb(kb)
        capped = min(entries, len(curve) - 1)
        if hier.policy == "random":
            mr = random_miss_ratio(rihist, entries)
            model = "aet-random"
        elif hier.assoc > 0:
            mr = assoc_miss_ratio(rihist, entries, hier.assoc, cfg)
            model = f"aet-assoc{hier.assoc}"
        else:
            mr = float(curve[capped])
            model = "aet-lru-exact"
        local = mr / prev_mr if prev_mr else mr
        out.append({
            "size_kb": int(kb),
            "entries": int(entries),
            "modeled_entries": int(capped),
            "miss_ratio": mr,
            "local_miss_ratio": min(local, 1.0),
            "model": model,
        })
        prev_mr = mr if mr > 0 else None
    return out


def hierarchy_doc(rihist: dict, cfg: SamplerConfig = DEFAULT,
                  hier: HierarchyConfig | None = None) -> dict:
    """JSON-shaped hierarchy block: levels + exact plateau."""
    hier = hier or HierarchyConfig.from_env()
    plateau, floor = aet_plateau(rihist, cfg)
    return {
        "levels": level_readoffs(rihist, cfg, hier),
        "assoc": hier.assoc,
        "policy": hier.policy,
        "plateau_c": plateau,
        "compulsory_floor": floor,
    }


def render_hierarchy(doc: dict, indent: str = "  ") -> list[str]:
    """Text lines for the ``hierarchy:`` block of analyze/sweep."""
    lines = ["hierarchy:"]
    for lv in doc["levels"]:
        lines.append(
            f"{indent}{lv['size_kb']:>6} KB  miss {lv['miss_ratio']:.6g}"
            f"  local {lv['local_miss_ratio']:.6g}  [{lv['model']}]")
    if doc["plateau_c"] is not None:
        lines.append(f"{indent}plateau: exact at c={doc['plateau_c']} "
                     f"(floor {doc['compulsory_floor']:.6g})")
    else:
        lines.append(f"{indent}plateau: beyond the modeled range "
                     f"(floor {doc['compulsory_floor']:.6g})")
    return lines
