"""Footprint & MRC bound prover: distinct-line counts, schedule-aware.

The port's copy of ``pluss/analysis/footprint.py``.

PLUSS predicts a miss-ratio curve without running the program; this pass
closes the loop by predicting, *statically*, the quantities that anchor
that curve — and in a form strong enough to be a machine-checkable
soundness oracle for both the analyzer and the sampler:

- **Per-(thread, array) footprint**: the exact number of distinct cache
  lines each simulated thread touches under the real chunk schedule.
  This IS the engine's cold-miss count (the per-thread last-access tables
  flush one cold entry per distinct line at the end of the run), so
  ``predicted_cold(spec, cfg) == res.noshare_dense[:, 0]`` exactly — for
  every supported nest shape, including the quadratic contract (the
  per-``k`` domain folding of :mod:`pluss_torch.analysis.walk` is exact there).
- **Per-level footprints**: sound lower/upper bounds on the distinct
  lines one iteration of each loop level touches — the candidate
  working-set sizes where the MRC bends (Cascaval-style symbolic reuse
  analysis reads the same quantity off the dependence structure).
- **MRC bracket** (:func:`mrc_bracket`): closed-form bounds the sampled
  curve must satisfy.  The *floor* is exact: the curve's terminal plateau
  value equals ``cold/N`` (AET's survival function bottoms out at the
  cold fraction).  The plateau *location* is bracketed by ``[c_lo,
  c_hi]``: ``c_hi`` comes from the telescoping bound (per-line reuse
  times within one thread sum to at most that thread's stream length, so
  the AET cursor integral is at most ``cold + Σ_t FP_t·L_t / N`` at
  T=1; dilation-scaled for T>1), and ``c_lo`` from a *guaranteed* reuse
  time — a single-reference array invariant at some loop level with a
  line-injective finer map must produce a reuse of exactly that level's
  closed-form stride, which lower-bounds the histogram's largest key and
  hence where the curve can flatten.

Everything here is host-side numpy over the spec — no torch, no stream
enumeration (address SETS are enumerated per reference, which is the
array size, not the access count).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from pluss_torch.analysis.schedule import owner_of
from pluss_torch.analysis.walk import (addr_form, inner_profile, loop_sites,
                                 ref_sites)
from pluss_torch.config import DEFAULT, SamplerConfig
from pluss_torch.spec import (LoopNestSpec, SpecContractError, flatten_nest,
                        nest_has_bounds, nest_has_varying_start,
                        nest_iteration_size_affine, nest_iteration_sizes)

#: cells per enumeration block (the k axis is blocked to stay under it)
_ENUM_BUDGET = 1 << 22


@dataclasses.dataclass(frozen=True)
class LevelFootprint:
    """Distinct-line bounds of ONE iteration of one loop's body."""

    nest: int
    path: str
    depth: int
    lines_lo: int
    lines_hi: int


@dataclasses.dataclass
class Footprint:
    """Schedule-aware footprint report of one spec."""

    arrays: tuple[str, ...]
    per_array: np.ndarray            # [A] distinct lines, whole run
    per_thread: np.ndarray           # [T, A] distinct lines per thread
    accesses: int                    # total accesses (closed form)
    per_thread_accesses: np.ndarray  # [T]
    levels: tuple[LevelFootprint, ...]

    @property
    def total(self) -> int:
        return int(self.per_array.sum())

    @property
    def cold(self) -> np.ndarray:
        """Predicted per-thread cold-miss counts [T] — the engine's
        ``noshare_dense[:, 0]``."""
        return self.per_thread.sum(axis=1).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class MrcBracket:
    """Static bounds the sampled (CRI + AET) MRC must satisfy."""

    floor: float          # exact terminal plateau value (cold fraction)
    c_lo: int             # plateau cannot start before this cache size
    c_hi: int             # plateau must be reached by this cache size
    guaranteed_reuse: int  # the closed-form reuse time behind c_lo (0=none)

    def refined(self, c_exact: int) -> "MrcBracket":
        """Collapse the heuristic bounds onto an exact plateau location
        proven by the symbolic reuse-interval pass (:mod:`pluss_torch.analysis
        .ri`) — the floor and the guaranteed-reuse witness are already
        exact and carry over unchanged."""
        return MrcBracket(self.floor, c_exact, c_exact,
                          self.guaranteed_reuse)


def _grid_levels(form) -> list[int]:
    """Inner levels that must be enumerated: nonzero-coefficient levels
    plus any level an enumerated level's bound references."""
    dims = {l for l in range(1, len(form.coefs) + 1)
            if form.coefs[l - 1] != 0}
    for l in sorted(dims):
        lv = form.levels[l - 1]
        if lv[0] == "idx":
            dims.add(lv[1])
    return sorted(dims)


def _site_line_masks(site, cfg: SamplerConfig, count: int,
                     T: int, glob: np.ndarray, pt: np.ndarray) -> None:
    """OR the site's touched lines into the array's global [count] and
    per-thread [T, count] boolean masks (exact, schedule-aware)."""
    try:
        form = addr_form(site)
    except SpecContractError:
        return
    alive, _, _ = inner_profile(form)
    ks = np.nonzero(alive)[0].astype(np.int64)
    if not len(ks):
        return
    own = owner_of(cfg)
    dims = _grid_levels(form)
    trips = [form.levels[l - 1][-1] for l in dims]
    box = int(np.prod(trips, dtype=np.int64)) if dims else 1
    # Monotone fast path: when the ADDRESS is k-independent (k_coef ==
    # 0) and every k-bounded level's domain moves monotonically with k
    # (slopes all >= 0 or all <= 0 — idx-bounded levels are fine either
    # way: their constraint is per-m-value and m's own range is covered
    # by the same argument), the line set at a thread's EXTREME owned k
    # is a superset of every other owned k's.  One box evaluation per
    # thread replaces trip0 of them — without this, a k-invariant sweep
    # like gemm's B or a growing triangle like syrk_tri's A[j][k]
    # enumerates trip0 copies of a million-cell box.
    k_slopes = [form.levels[l - 1][2] for l in dims
                if form.levels[l - 1][0] == "k"]
    stamp_threads: dict[int, np.ndarray] | None = None
    if form.k_coef == 0 and (all(b >= 0 for b in k_slopes)
                             or all(b <= 0 for b in k_slopes)):
        pick = (lambda a: a.max()) if all(b >= 0 for b in k_slopes) \
            else (lambda a: a.min())
        reps: dict[int, list[int]] = {}
        tids = own(ks)
        for t in np.unique(tids):
            reps.setdefault(int(pick(ks[tids == t])), []).append(int(t))
        stamp_threads = {k_: np.asarray(ts) for k_, ts in reps.items()}
        ks = np.asarray(sorted(stamp_threads), np.int64)
    kblock = max(1, _ENUM_BUDGET // max(1, box))
    nd = 1 + len(dims)

    def axis(arr, ax):
        return np.asarray(arr, np.int64).reshape(
            (1,) * ax + (-1,) + (1,) * (nd - ax - 1))

    for b0 in range(0, len(ks), kblock):
        kb = ks[b0:b0 + kblock]
        kx = axis(kb, 0)
        addr = form.const + form.k_coef * kx
        valid = np.ones((len(kb),) + tuple(trips), bool)
        idxs = {}
        for ax, l in enumerate(dims, start=1):
            idxs[l] = axis(np.arange(trips[ax - 1]), ax)
            addr = addr + form.coefs[l - 1] * idxs[l]
        for ax, l in enumerate(dims, start=1):
            lv = form.levels[l - 1]
            if lv[0] == "k":
                _, a, bb, trip = lv
                valid = valid & (idxs[l] < np.clip(a + bb * kx, 0, trip))
            elif lv[0] == "idx":
                _, m, a, bb, trip = lv
                ref = idxs.get(m)
                if ref is None:   # out-of-contract chain: static maximum
                    continue
                valid = valid & (idxs[l] < np.clip(a + bb * ref, 0, trip))
        line = addr * cfg.ds // cfg.cls
        valid = valid & (line >= 0) & (line < count)
        if stamp_threads is not None:
            lineb = np.broadcast_to(line, valid.shape)
            for i, k_ in enumerate(kb.tolist()):
                row = lineb[i][valid[i]]
                glob[row] = True
                for t in stamp_threads[k_]:
                    pt[t, row] = True
            continue
        line = np.broadcast_to(line, valid.shape)[valid]
        tid = np.broadcast_to(own(kx), valid.shape)[valid]
        glob[line] = True
        pt[tid, line] = True


def per_thread_accesses(spec: LoopNestSpec,
                        cfg: SamplerConfig = DEFAULT,
                        skip_nests: frozenset[int] = frozenset()
                        ) -> np.ndarray:
    """[T] exact access counts per simulated thread (closed form — the
    engine's per-thread stream lengths).  ``skip_nests`` must match the
    line-mask accounting's: a contract-rejected nest contributes neither
    lines nor accesses, or every ``cold/N`` quantity downstream skews."""
    T = cfg.thread_num
    out = np.zeros(T, np.int64)
    own = owner_of(cfg)
    for ni, nest in enumerate(spec.nests):
        if nest.trip <= 0 or ni in skip_nests:
            continue
        ks = np.arange(nest.trip, dtype=np.int64)
        np.add.at(out, own(ks), nest_iteration_sizes(nest, ks))
    return out


def _distinct_addr_stats(coefs, trips) -> tuple[int, int] | None:
    """(count, span) of the exact distinct-value set of ``Σ c_l·x_l``
    over the box, or None past the enumeration budget.  Partial sums are
    deduplicated per axis — exact, and keeps the working set bounded by
    the value span rather than the box volume."""
    vals = np.zeros(1, np.int64)
    for c, t in zip(coefs, trips):
        if c == 0 or t <= 1:
            continue
        vals = (vals[:, None]
                + c * np.arange(t, dtype=np.int64)[None, :]).ravel()
        if vals.size > _ENUM_BUDGET:
            return None
        vals = np.unique(vals)
    return len(vals), int(vals.max() - vals.min())


def _level_bounds(spec: LoopNestSpec, cfg: SamplerConfig,
                  skip_nests: frozenset[int]) -> tuple[LevelFootprint, ...]:
    """Sound (lo, hi) distinct-line bounds of one body iteration of every
    loop: hi = Σ per-ref exact maxima (union ≤ sum), lo = max per-ref
    minima (union ≥ any member)."""
    E = max(1, cfg.cls // cfg.ds)
    sites = ref_sites(spec)
    out = []
    for loop, chain, ni, path in loop_sites(spec):
        if ni in skip_nests:
            continue
        dl = len(chain)   # this loop's depth in its nest
        lo = hi = 0
        ok = True
        for s in sites:
            if s.nest != ni or len(s.chain) <= dl or s.chain[dl] is not loop:
                continue
            try:
                form = addr_form(s)
            except SpecContractError:
                continue
            coefs, t_hi, t_lo = [], [], []
            for l in range(dl + 1, len(s.chain)):
                lv = form.levels[l - 1]
                trip = lv[-1]
                coefs.append(form.coefs[l - 1])
                t_hi.append(trip)
                if lv[0] == "const":
                    t_lo.append(trip)
                else:
                    a, b = lv[-3], lv[-2]
                    ref_hi = form.trip0 - 1 if lv[0] == "k" \
                        else form.levels[lv[1] - 1][-1] - 1
                    t_lo.append(int(np.clip(min(a, a + b * ref_hi),
                                            0, trip)))
            s_hi = _distinct_addr_stats(coefs, t_hi)
            s_lo = _distinct_addr_stats(coefs, t_lo)
            if s_hi is None or s_lo is None:
                ok = False
                break
            n_hi, span_hi = s_hi
            n_lo, _ = s_lo
            hi += min(n_hi, span_hi // E + 1)
            lo = max(lo, -(-n_lo // E))
        if ok and (lo or hi):
            out.append(LevelFootprint(ni, path, dl, lo, hi))
    return tuple(out)


def footprints(spec: LoopNestSpec, cfg: SamplerConfig = DEFAULT,
               skip_nests: frozenset[int] = frozenset()) -> Footprint:
    """Exact schedule-aware footprint of a spec (line space = the
    engine's: ``cfg.ds`` bytes/element, ``cfg.cls``-byte lines, arrays on
    line boundaries)."""
    T = cfg.thread_num
    names = tuple(a for a, _ in spec.arrays)
    counts = spec.line_counts(cfg)
    globs = {a: np.zeros(c, bool) for (a, _), c in zip(spec.arrays, counts)}
    pts = {a: np.zeros((T, c), bool)
           for (a, _), c in zip(spec.arrays, counts)}
    for site in ref_sites(spec):
        if site.nest in skip_nests or site.ref.array not in globs:
            continue
        arr = site.ref.array
        _site_line_masks(site, cfg, counts[spec.array_index(arr)],
                         T, globs[arr], pts[arr])
    per_array = np.array([int(globs[a].sum()) for a in names], np.int64)
    per_thread = np.stack([pts[a].sum(axis=1) for a in names],
                          axis=1).astype(np.int64)
    pta = per_thread_accesses(spec, cfg, skip_nests)
    return Footprint(
        arrays=names,
        per_array=per_array,
        per_thread=per_thread,
        accesses=int(pta.sum()),
        per_thread_accesses=pta,
        levels=_level_bounds(spec, cfg, skip_nests),
    )


def predicted_cold(spec: LoopNestSpec,
                   cfg: SamplerConfig = DEFAULT) -> np.ndarray:
    """[T] predicted cold-miss counts — must equal the engine's
    ``res.noshare_dense[:, 0]`` exactly (the soundness oracle)."""
    return footprints(spec, cfg).cold


def _line_injective(coefs, trips, E: int) -> bool:
    """True when the (line-space) map ``Σ c_l·x_l // E`` is injective over
    the box — each line touched at most once per traversal."""
    cs = []
    for c, t in zip(coefs, trips):
        if c == 0 or t <= 1:
            continue
        if E > 1:
            if c % E:
                return False
            c //= E
        cs.append((abs(c), t))
    cs.sort()
    span = 0
    for c, t in cs:
        if span >= c:
            return False
        span += c * (t - 1)
    return True


def guaranteed_reuse(spec: LoopNestSpec,
                     cfg: SamplerConfig = DEFAULT) -> int:
    """Largest reuse time PROVEN to occur: a single-reference array,
    invariant at some loop level with a line-injective finer map, touches
    each of its lines once per level iteration — consecutive touches are
    exactly the level's closed-form position stride apart.  0 when no
    reference qualifies (the bracket's lower bound then degenerates)."""
    E = max(1, cfg.cls // cfg.ds)
    T, CS = cfg.thread_num, cfg.chunk_size
    by_arr: dict[str, list] = {}
    for s in ref_sites(spec):
        by_arr.setdefault(s.ref.array, []).append(s)
    best = 0
    for arr, ss in by_arr.items():
        if len(ss) != 1:
            continue   # other refs could split the per-line gaps
        s = ss[0]
        nest = spec.nests[s.nest]
        # the proof uses constant strides and shift-invariant positions
        if nest_has_bounds(nest) or nest_has_varying_start(nest):
            continue
        try:
            form = addr_form(s)
        except SpecContractError:
            continue
        frs = [fr for fr in flatten_nest(nest) if fr.ref is s.ref]
        if not frs:
            continue
        fr = frs[0]
        d = len(s.chain)
        if any(t < 1 for t in fr.trips):
            continue

        def noshare_gap(gap: int) -> bool:
            # the guaranteed reuse must land in the NOSHARE histogram
            # (share events take the racetrack rebinning instead)
            span = s.ref.share_span
            return gap >= 1 and not (span is not None and 2 * gap > span)

        for l in range(1, d):
            if form.coefs[l - 1] != 0 or fr.trips[l] < 2:
                continue
            if not _line_injective(form.coefs[l:], fr.trips[l + 1:], E):
                continue
            gap = fr.pos_strides[l]
            if noshare_gap(gap):
                best = max(best, gap)
        n0, n1 = nest_iteration_size_affine(nest)
        if form.k_coef == 0 and nest.trip >= 2 and n1 == 0 \
                and (T == 1 or CS >= 2) \
                and _line_injective(form.coefs, fr.trips[1:], E):
            if noshare_gap(n0):
                best = max(best, n0)
    return best


def mrc_bracket(spec: LoopNestSpec, cfg: SamplerConfig = DEFAULT,
                fp: Footprint | None = None) -> MrcBracket:
    """Static bounds on the sampled MRC (see module docstring).

    The floor is exact for any T.  The plateau-location bounds are proven
    for T=1 (no CRI dilation); for T>1 ``c_hi`` scales the telescoping
    bound by the dilation factor T plus an NBD tail allowance, and
    ``c_lo`` halves the guaranteed key once more (dilated masses rebin at
    ≥ half the pre-dilation key) — both validated by the bracket tests.
    """
    if fp is None:
        fp = footprints(spec, cfg)
    N = max(fp.accesses, 1)
    cold = int(fp.cold.sum())
    floor = cold / N
    L = fp.per_thread_accesses
    fp_t = fp.per_thread.sum(axis=1)
    l_max = int(L.max(initial=0))
    base = ((l_max + 1) * cold + int((fp_t * L).sum())) / N
    T = cfg.thread_num
    if T == 1:
        c_hi = int(math.ceil(base)) + 1
    else:
        c_hi = int(math.ceil(T * base
                             + 64 * T * math.sqrt(max(l_max, 1)))) + 1
    t_g = guaranteed_reuse(spec, cfg)
    c_lo = 0
    if t_g >= 1 and cold:
        key = 1 << (t_g.bit_length() - 1)
        if T > 1:
            key //= 2
        c_lo = (key * cold) // N
    return MrcBracket(floor, int(c_lo), c_hi, t_g)
