"""Affine dependence / race detection on the parallel dimension.

The port's copy of ``pluss/analysis/deps.py``.

PLUSS trusts the ``#pragma pluss parallel`` assertion: the outermost loop
of every nest is chunked over simulated threads with no further checking.
This pass proves or refutes that trust statically.  For a pair of
references on the same array the question is whether two DISTINCT parallel
iterations can touch the same element::

    addr_1(k1, i⃗) = addr_2(k2, j⃗),   k1 != k2

with both sides affine (:class:`pluss_torch.analysis.walk.AddrForm`).  The test
is exact in ``k`` — the parallel axis is enumerated (it is the quantity
under test, and the per-``k`` inner domains of triangular nests make it
non-rectangular) — and Banerjee-style in the inner indices: at fixed
``(k1, k2)`` the inner contribution must land in its exact interval
``[lo1-hi2, hi1-lo2]`` AND satisfy the GCD divisibility condition.  A
refutation is therefore a proof; a confirmation is conservative in the
usual dependence-analysis sense (interval + gcd, not full ILP), which is
the right polarity for a race detector.

Granularity is the ELEMENT, not the cache line: races are a property of
data addresses.  The share/reuse machinery is line-granular, so the
cross-check against the engine's dynamic share split
(``tests/test_analysis.py``) uses sizes where rows align to lines.

Classification (:func:`classify`) answers three questions per reference,
all consumed by the share-span pass and the dynamic cross-check:

- ``carried_level``: the OUTERMOST loop level that can carry a self-reuse
  of the reference (0 = the parallel loop; None = no self-reuse at all).
- ``cross_parallel``: some same-array reference pair (including itself)
  conflicts across distinct parallel iterations — under chunked
  scheduling some schedule places the two iterations on different
  simulated threads, so this is exactly "the reuse can cross threads".
  Same-nest pairs compare parallel indices (``k1 != k2``); pairs in
  DIFFERENT nests are also reuses (the per-thread last-access tables
  persist across the back-to-back nests) and compare parallel VALUES.
  Races (PL30x) stay same-nest: nests never run concurrently.
- ``cross_observed``: the directed refinement — this reference can be the
  LATER access of such a pair (``k_prev < k_obs`` within a nest, or the
  partner sitting in an earlier nest).  Dynamically the later access is
  where the reuse (and the share test) is observed, so this is the bit a
  ``share_span`` annotation encodes.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from pluss_torch.analysis.diagnostics import Diagnostic, Severity, shown
from pluss_torch.analysis.walk import (AddrForm, RefSite, addr_form,
                                 inner_profile, ref_sites)
from pluss_torch.spec import LoopNestSpec, SpecContractError


@dataclasses.dataclass(frozen=True)
class SiteProfile:
    site: RefSite
    form: AddrForm
    alive: np.ndarray   # [trip0] bool
    lo: np.ndarray      # [trip0] inner-contribution min
    hi: np.ndarray      # [trip0] inner-contribution max


@dataclasses.dataclass(frozen=True)
class RefClass:
    site: RefSite
    carried_level: int | None
    cross_parallel: bool
    cross_observed: bool


def _profile(site: RefSite) -> SiteProfile | None:
    try:
        form = addr_form(site)
    except SpecContractError:
        return None  # the contract pass owns this report
    alive, lo, hi = inner_profile(form)
    return SiteProfile(site, form, alive, lo, hi)


#: k1-axis block size of the pair test: bounds transient memory to
#: ~6 * BLOCK * trip0 int64 cells per test instead of O(trip0^2), so a
#: ``--verify`` pre-pass at n=4096 stays tens of MB, not gigabytes.
_PAIR_BLOCK = 1024


def _feasible(p1: SiteProfile, p2: SiteProfile, rel,
              delta: int = 0) -> bool:
    """True when ``addr_1(k1, ·) - addr_2(k2, ·) = delta`` has a feasible
    solution with ``rel(k1, k2)`` (a broadcastable boolean relation on the
    two parallel-index grids).  Exact over k; GCD + interval (Banerjee)
    over inner indices.  ``delta=0`` is the same-element (race) test; the
    false-sharing pass probes the sub-line offsets ``0 < |delta| < E``.
    """
    f1, f2 = p1.form, p2.form
    g = math.gcd(f1.inner_gcd(), f2.inner_gcd())
    k2 = np.arange(f2.trip0, dtype=np.int64)[None, :]
    base2 = f2.const + f2.k_coef * k2
    for b0 in range(0, f1.trip0, _PAIR_BLOCK):
        k1 = np.arange(b0, min(b0 + _PAIR_BLOCK, f1.trip0),
                       dtype=np.int64)[:, None]
        sl = slice(b0, b0 + len(k1))
        # need: (inner_1 - inner_2) = D(k1, k2)
        D = base2 - (f1.const + f1.k_coef * k1) + delta
        L = p1.lo[sl, None] - p2.hi[None, :]
        H = p1.hi[sl, None] - p2.lo[None, :]
        divisible = (D % g == 0) if g else (D == 0)
        mask = p1.alive[sl, None] & p2.alive[None, :] & rel(k1, k2)
        if bool(np.any(mask & (D >= L) & (D <= H) & divisible)):
            return True
    return False


def _pair_conflict(p1: SiteProfile, p2: SiteProfile,
                   directed: bool = False) -> bool:
    """Same-nest pair test: distinct parallel iterations, ``k1 != k2``
    (``directed``: ``k1 > k2``, i.e. site 1 is the later access).  The
    undirected test is symmetric in (p1, p2)."""
    if p1.form.trip0 != p2.form.trip0 or p1.form.trip0 <= 1:
        return False
    rel = (lambda k1, k2: k1 > k2) if directed \
        else (lambda k1, k2: k1 != k2)
    return _feasible(p1, p2, rel)


def _cross_nest_conflict(p1: SiteProfile, p2: SiteProfile) -> bool:
    """Different-nest pair test: nests run back-to-back over the SAME
    per-thread last-access tables (LoopNestSpec docstring), so a later
    nest's access can observe a reuse of an earlier nest's — at ANY pair
    of parallel indices.  "Crosses the parallel dimension" then means the
    two occurrences' parallel VALUES differ (the nests may disagree on
    start/step, e.g. ludcmp's descending back-substitution).  Symmetric.
    """
    l1, l2 = p1.site.chain[0], p2.site.chain[0]
    rel = lambda k1, k2: (l1.start + l1.step * k1) \
        != (l2.start + l2.step * k2)
    return _feasible(p1, p2, rel)


def _self_carried_levels(p: SiteProfile) -> list[int]:
    """Loop levels that can carry a self-reuse of the reference.

    Level 0 uses the exact-in-k pair test.  Level ``d >= 1`` asks for two
    occurrences with equal indices above ``d``, differing index AT ``d``,
    and equal addresses: ``B_d*Δ_d + Σ_{l>d} B_l*Δ_l = 0`` with
    ``Δ_d != 0`` — tested with static-maximum delta ranges (gcd +
    interval), conservative like the inner half of the pair test.
    """
    out = []
    if _pair_conflict(p, p):
        out.append(0)
    form = p.form
    maxes = [lv[-1] for lv in form.levels]        # static max trips
    for d in range(1, len(form.coefs) + 1):
        td = maxes[d - 1]
        if td < 2:
            continue
        bd = form.coefs[d - 1]
        if bd == 0:
            out.append(d)
            continue
        span = 0
        g = 0
        for l in range(d + 1, len(form.coefs) + 1):
            c, t = form.coefs[l - 1], maxes[l - 1]
            if c and t >= 2:
                span += abs(c) * (t - 1)
                g = math.gcd(g, abs(c))
        deltas = np.arange(1, td, dtype=np.int64) * bd
        feasible = (np.abs(deltas) <= span)
        feasible &= (deltas % g == 0) if g else (deltas == 0)
        if bool(feasible.any()):
            out.append(d)
    return out


@dataclasses.dataclass
class Analysis:
    """One spec's profiled sites + classification, computed ONCE and shared
    by the race pass and the share-span pass (profiling and the pair tests
    are the expensive half of the lint).

    ``classes`` is keyed by the site's tree PATH — globally unique even
    when ref names collide (name collisions are only a PL406 warning, and
    must never shadow another ref's diagnostics).  ``groups`` is per
    (nest, array): the race pass's scope, since nests execute sequentially
    and only same-nest conflicts are parallel races.  ``array_groups`` is
    per array across nests: the REUSE scope, since per-thread last-access
    tables persist across nests.
    """

    profiles: list[SiteProfile]
    groups: dict[tuple[int, str], list[SiteProfile]]
    array_groups: dict[str, list[SiteProfile]]
    classes: dict[str, RefClass]
    _memo: dict[tuple, bool]
    _index: dict[int, int]  # id(profile) -> position

    def conflict(self, p: SiteProfile, q: SiteProfile) -> bool:
        """Memoized same-nest undirected pair test (symmetric)."""
        key = ("same", *sorted((self._index[id(p)], self._index[id(q)])))
        if key not in self._memo:
            self._memo[key] = _pair_conflict(p, q)
        return self._memo[key]

    def xconflict(self, p: SiteProfile, q: SiteProfile) -> bool:
        """Memoized cross-nest conflict test (symmetric)."""
        key = ("x", *sorted((self._index[id(p)], self._index[id(q)])))
        if key not in self._memo:
            self._memo[key] = _cross_nest_conflict(p, q)
        return self._memo[key]


def analyze(spec: LoopNestSpec,
            skip_nests: frozenset[int] = frozenset()) -> Analysis:
    sites = [s for s in ref_sites(spec) if s.nest not in skip_nests]
    profiles = [p for p in map(_profile, sites) if p is not None]
    groups: dict[tuple[int, str], list[SiteProfile]] = {}
    arrays: dict[str, list[SiteProfile]] = {}
    for p in profiles:
        groups.setdefault((p.site.nest, p.site.ref.array), []).append(p)
        arrays.setdefault(p.site.ref.array, []).append(p)
    ana = Analysis(profiles, groups, arrays, {}, {},
                   {id(p): i for i, p in enumerate(profiles)})
    for p in profiles:
        group = groups[(p.site.nest, p.site.ref.array)]
        cross = any(ana.conflict(p, q) for q in group)
        # directed (k1 > k2) is a sub-relation of undirected (k1 != k2):
        # only partners the memoized undirected test confirmed can succeed
        observed = cross and any(_pair_conflict(p, q, directed=True)
                                 for q in group if ana.conflict(p, q))
        # cross-nest reuse: the per-thread LAT persists across nests, so
        # an earlier nest's touch of the same address at a different
        # parallel VALUE is an observable parallel-crossing reuse here
        for q in arrays[p.site.ref.array]:
            if q.site.nest == p.site.nest:
                continue
            earlier = q.site.nest < p.site.nest
            if cross and (observed or not earlier):
                continue  # nothing left to learn from this pair
            if ana.xconflict(p, q):
                cross = True
                observed = observed or earlier
        levels = _self_carried_levels(p)
        ana.classes[p.site.path] = RefClass(
            site=p.site,
            carried_level=min(levels) if levels else None,
            cross_parallel=cross,
            cross_observed=observed,
        )
    return ana


def classify(spec: LoopNestSpec,
             skip_nests: frozenset[int] = frozenset()) -> dict[str, RefClass]:
    """Per-reference classification, keyed by tree path."""
    return analyze(spec, skip_nests).classes


def check(spec: LoopNestSpec,
          skip_nests: frozenset[int] = frozenset(),
          analysis: Analysis | None = None) -> list[Diagnostic]:
    """Race diagnostics: PL301 (write-write) / PL302 (read-write) per
    conflicting same-array pair, one diagnostic per (nest, array, code)
    aggregating the pairs; PL303 INFO classification for every annotated
    (``share_span``) reference.

    Conflicts are WARNINGS, not errors: PLUSS models intentionally racy
    kernels (floyd_warshall's parallel-invariant stores, seidel2d's whole
    nest) — their locality is exactly what the sampler measures.  The
    lint's job is to make the pragma's assertion visible, not to forbid
    it.
    """
    diags: list[Diagnostic] = []
    ana = analysis if analysis is not None else analyze(spec, skip_nests)
    for (ni, array), group in sorted(ana.groups.items()):
        pairs: dict[str, list[str]] = {"PL301": [], "PL302": []}
        first_path: dict[str, str] = {}
        for i, p in enumerate(group):
            for q in group[i:]:
                if not (p.site.ref.is_write or q.site.ref.is_write):
                    continue
                if not ana.conflict(p, q):
                    continue
                code = "PL301" if (p.site.ref.is_write
                                   and q.site.ref.is_write) else "PL302"
                pairs[code].append(f"{p.site.ref.name}~{q.site.ref.name}")
                first_path.setdefault(code, p.site.path)
        for code, names in pairs.items():
            if not names:
                continue
            kind = "write-write" if code == "PL301" else "read-write"
            diags.append(Diagnostic(
                code=code, severity=Severity.WARNING,
                message=f"{kind} conflict on '{array}' across parallel "
                        f"iterations: {shown(names)} — the parallel "
                        "pragma asserts this is intended",
                path=first_path[code], nest=ni, array=array,
            ))
    for path, rc in sorted(ana.classes.items()):
        if rc.site.ref.share_span is None:
            continue
        lvl = rc.carried_level
        diags.append(Diagnostic(
            code="PL303", severity=Severity.INFO,
            message=(f"reuse carried at level "
                     f"{'none' if lvl is None else lvl}"
                     + (" (parallel)" if lvl == 0 else "")
                     + f"; cross-thread observable: {rc.cross_observed}"),
            path=path, nest=rc.site.nest, ref=rc.site.ref.name,
            array=rc.site.ref.array,
        ))
    return diags
