"""AET -> miss-ratio curve, exact C++ semantics in closed form (host, numpy).

The port's copy of ``pluss/mrc.py``.  The reference's ``pluss_AET``
(``pluss_utils.h:758-804``) computes P(reuse > t) from the final histogram,
then sweeps cache sizes c advancing a time cursor while ``sum_P < c``.
Because P is a step function over histogram keys, the cursor's running sum
is piecewise linear in t, so the first t with ``S(t) >= c`` has a closed
form per segment and the whole curve falls out of a searchsorted.

P construction (pluss_utils.h:761-781): iterate keys descending, excluding
the cold key -1 but seeding the accumulator with its count; P[k] =
acc/total before adding k's own count; finally P[0] is forced to 1.0.
"""

from __future__ import annotations

import numpy as np

from pluss_torch import obs
from pluss_torch.config import DEFAULT, MRC_DEDUP_EPS, SamplerConfig


def survival(rihist: dict) -> tuple[np.ndarray, np.ndarray]:
    """(keys ascending, P values) of the AET survival map, C++ semantics."""
    total = float(sum(rihist.values()))
    if total == 0.0:
        return np.array([0], np.int64), np.array([1.0])
    keys = sorted(k for k in rihist if k != -1)
    acc = float(rihist.get(-1, 0.0))
    P = {}
    for k in reversed(keys):
        P[k] = acc / total
        acc += float(rihist[k])
    P[0] = 1.0  # pluss_utils.h:781 overwrites/creates key 0
    ks = np.array(sorted(P), np.int64)
    vs = np.array([P[int(k)] for k in ks])
    return ks, vs


def aet_times(rihist: dict, cfg: SamplerConfig = DEFAULT) -> np.ndarray:
    """AET eviction times t*(c) for c = 0..min(max_key, cache entries): the
    first cursor position with cumulative survival ``S(t) >= c``."""
    if not rihist:
        return np.array([0], np.int64)
    max_rt = max(rihist.keys())
    if max_rt < 0:
        return np.array([0], np.int64)
    ks, vs = survival(rihist)
    # segments [ks[j], ks[j+1]-1] with constant step value vs[j]; the cursor
    # never passes max_rt (pluss_utils.h:787)
    ends = np.append(ks[1:] - 1, max_rt)
    lens = (ends - ks + 1).astype(np.float64)
    seg_cum = np.cumsum(vs * lens)            # S at each segment end
    c_max = min(max_rt, cfg.aet_cache_entries)
    cs = np.arange(0, c_max + 1, dtype=np.float64)
    j = np.searchsorted(seg_cum, cs, side="left")
    j = np.minimum(j, len(ks) - 1)
    prev_cum = np.where(j > 0, seg_cum[j - 1], 0.0)
    # first t in segment j with S(t) >= c: t = ks[j] + ceil((c-prev)/v) - 1
    v = vs[j]
    need = np.maximum(cs - prev_cum, 0.0)
    steps = np.ceil(need / np.where(v > 0, v, 1.0))
    t = ks[j] + np.maximum(steps - 1, 0).astype(np.int64)
    return np.minimum(t, max_rt)


def survival_at(rihist: dict, t: np.ndarray) -> np.ndarray:
    """P(reuse > t) of ``rihist``'s survival step function at times ``t``."""
    ks, vs = survival(rihist)
    seg_of_t = np.maximum(np.searchsorted(ks, t, side="right") - 1, 0)
    return vs[seg_of_t]


def aet_mrc(rihist: dict, cfg: SamplerConfig = DEFAULT) -> np.ndarray:
    """Miss ratio per cache size c = 0..min(max_key, cache entries) — the
    reference's ``_MRC[c]`` (pluss_utils.h:786-802).  Empty -> [1.0]."""
    with obs.span("mrc.aet_mrc"):
        if not rihist:
            return np.array([1.0])
        if max(rihist.keys()) < 0:
            return np.array([1.0])
        return survival_at(rihist, aet_times(rihist, cfg))


def plateau_of(rihist: dict, mrc: np.ndarray) -> int | None:
    """Exact plateau location: the first cache size whose miss ratio is
    the curve's terminal compulsory-miss value, or None if the curve
    never reaches it inside the modeled cache range.

    The terminal value is ``cold/total`` by the same float division the
    survival map performs (the descending accumulator's FIRST emitted P
    is exactly ``acc/total`` with ``acc`` still the seed cold count), so
    reaching the floor is an exact float equality, not an epsilon test;
    the curve is non-increasing, so the matching suffix is one run and
    its first index IS the plateau."""
    total = float(sum(rihist.values()))
    if total == 0.0:
        return 0
    floor = float(rihist.get(-1, 0.0)) / total
    if float(mrc[-1]) != floor:
        return None
    hit = np.flatnonzero(np.asarray(mrc) == floor)
    return int(hit[0])


def dedup_lines(mrc: np.ndarray) -> list[tuple[int, float]]:
    """The reference's run-collapsing printer (pluss_utils.h:851-883): for
    each run of c whose miss ratios differ from the run head by < 1e-5,
    the head and (if distinct) the tail."""
    n = len(mrc)
    lines: list[tuple[int, float]] = []
    i1 = 0
    while i1 < n:
        i2 = i1
        while i2 + 1 < n and mrc[i1] - mrc[i2 + 1] < MRC_DEDUP_EPS:
            i2 += 1
        lines.append((i1, float(mrc[i1])))
        if i1 != i2:
            lines.append((i2, float(mrc[i2])))
        i1 = i2 + 1
    return lines


def write_mrc(path: str, mrc: np.ndarray) -> None:
    """``pluss_write_mrc_to_file`` (pluss_utils.h:885-913)."""
    with open(path, "w") as f:
        f.write("miss ratio\n")
        for c, v in dedup_lines(mrc):
            f.write(f"{c}, {v:g}\n")


def l2_error(a: np.ndarray, b: np.ndarray) -> float:
    """Relative L2 distance on the common prefix — the acceptance metric
    (BASELINE.md: MRC within 1% L2 error)."""
    n = min(len(a), len(b))
    if n == 0:
        return 0.0
    x, y = np.asarray(a[:n], float), np.asarray(b[:n], float)
    denom = float(np.linalg.norm(y)) or 1.0
    return float(np.linalg.norm(x - y)) / denom
