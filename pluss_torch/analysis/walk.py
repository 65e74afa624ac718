"""Shared spec-tree walking and affine address forms for the analyzer.

The port's copy of ``pluss/analysis/walk.py``.

Every pass reasons about the same two objects:

- :class:`RefSite` — one static reference plus its enclosing loop chain
  and a printable tree path (``nests[0].body[1].body[2]``).
- :class:`AddrForm` — the reference's element address as an affine form of
  the parallel INDEX ``k`` and the per-level inner indices::

      addr = const + k_coef*k + sum(coefs[l-1] * idx_l)   for levels l >= 1

  derived from ``addr = addr_base + sum(c_l * value_l)`` with
  ``value_l = start_l + start_coef_l*k + step_l*idx_l`` (and
  ``value_0 = start_0 + step_0*k``), exactly the engine's address rule
  (:func:`pluss_torch.engine._ref_window`).

The iteration domain is captured per level as ``("const", trip)``,
``("k", a, b, trip)`` (trip ``a + b*k``, clamped to ``[0, trip]``) or
``("idx", m, a, b, trip)`` (trip ``a + b*idx_m`` — the quad contract).
:func:`inner_profile` turns that into exact per-``k`` vectors:
aliveness (does the ref execute at ``k`` at all) and min/max of the
inner-index contribution — interval arithmetic is exact for an affine
function over a box, and the one dependent-level case (quad) is folded by
enumerating the referenced index, so the profile stays exact for every
in-contract nest shape.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from pluss_torch.spec import Loop, LoopNestSpec, Ref, SpecContractError


@dataclasses.dataclass(frozen=True)
class RefSite:
    ref: Ref
    chain: tuple[Loop, ...]   # enclosing loops, outermost (parallel) first
    nest: int                 # index into spec.nests
    path: str                 # "nests[0].body[1].body[2]"

    @property
    def depth(self) -> int:
        return len(self.chain)


def ref_sites(spec: LoopNestSpec) -> list[RefSite]:
    """All references of the spec with their chains and tree paths."""
    out: list[RefSite] = []

    def walk(item, chain: tuple[Loop, ...], ni: int, path: str) -> None:
        if isinstance(item, Ref):
            out.append(RefSite(item, chain, ni, path))
            return
        for bi, b in enumerate(item.body):
            walk(b, chain + (item,), ni, f"{path}.body[{bi}]")

    for ni, nest in enumerate(spec.nests):
        walk(nest, (), ni, f"nests[{ni}]")
    return out


def loop_sites(spec: LoopNestSpec):
    """All loops as ``(loop, chain_of_enclosing_loops, nest_index, path)``."""
    out = []

    def walk(item, chain: tuple[Loop, ...], ni: int, path: str) -> None:
        if isinstance(item, Ref):
            return
        out.append((item, chain, ni, path))
        for bi, b in enumerate(item.body):
            walk(b, chain + (item,), ni, f"{path}.body[{bi}]")

    for ni, nest in enumerate(spec.nests):
        walk(nest, (), ni, f"nests[{ni}]")
    return out


@dataclasses.dataclass(frozen=True)
class AddrForm:
    const: int
    k_coef: int
    coefs: tuple[int, ...]                 # per inner level 1..depth-1
    levels: tuple[tuple, ...]              # domain descriptor per inner level
    trip0: int                             # parallel trip count

    def inner_gcd(self) -> int:
        """gcd of the inner coefficients whose level can move (trip >= 2) —
        the divisibility half of the Banerjee/GCD feasibility test.  0 when
        no inner index can move (the inner contribution is then exactly 0)."""
        g = 0
        for c, lv in zip(self.coefs, self.levels):
            if c and lv[-1] >= 2:
                g = math.gcd(g, abs(c))
        return g


def addr_form(site: RefSite) -> AddrForm:
    """The site's address as an affine form of (k, inner indices).

    Raises :class:`SpecContractError` (PL403) for addr terms outside the
    chain — callers skip such refs; the contract pass reports them.
    """
    d = len(site.chain)
    coefs = [0] * d
    for depth, coef in site.ref.addr_terms:
        if not 0 <= depth < d:
            raise SpecContractError(
                f"ref {site.ref.name}: addr term depth {depth} exceeds "
                f"loop chain depth {d}",
                "PL403",
            )
        coefs[depth] += coef
    nest = site.chain[0]
    const = site.ref.addr_base + sum(
        c * l.start for c, l in zip(coefs, site.chain)
    )
    k_coef = coefs[0] * nest.step + sum(
        c * l.start_coef for c, l in zip(coefs[1:], site.chain[1:])
    )
    inner = tuple(c * l.step for c, l in zip(coefs[1:], site.chain[1:]))
    levels = []
    for l in site.chain[1:]:
        if l.bound_coef is None:
            levels.append(("const", l.trip))
        elif l.bound_level == 0:
            levels.append(("k", *l.bound_coef, l.trip))
        else:
            levels.append(("idx", l.bound_level, *l.bound_coef, l.trip))
    return AddrForm(const, k_coef, inner, tuple(levels), nest.trip)


def _interval(coef: int, trips: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(lo, hi) of ``coef * idx`` over ``idx in [0, trips)`` — zero where
    the level is empty (callers mask aliveness separately)."""
    span = np.maximum(trips - 1, 0) * coef
    return np.minimum(span, 0), np.maximum(span, 0)


def inner_profile(form: AddrForm) -> tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """Exact per-``k`` domain profile: ``(alive, lo, hi)`` arrays [trip0].

    ``alive[k]`` — the ref executes at parallel index ``k`` (every
    enclosing level has a nonempty range there); ``lo/hi[k]`` — exact
    min/max of ``sum(coefs[l]*idx_l)`` over the valid inner domain at
    ``k``.  Quad levels (trip depending on an inner index ``m``) are
    folded by enumerating ``idx_m`` — exact, and cheap because the quad
    contract allows a single referenced level per dependent loop.
    """
    ks = np.arange(max(form.trip0, 0), dtype=np.int64)
    referenced = sorted({lv[1] for lv in form.levels if lv[0] == "idx"})

    def trips_of(lv, mvals=None) -> np.ndarray:
        kind = lv[0]
        if kind == "const":
            return np.full_like(ks if mvals is None else mvals, lv[1])
        if kind == "k":
            _, a, b, trip = lv
            t = a + b * ks
        else:  # "idx" — only called with mvals set
            _, _m, a, b, trip = lv
            t = a + b * mvals
        return np.clip(t, 0, trip)

    alive = np.ones_like(ks, bool)
    lo = np.zeros_like(ks)
    hi = np.zeros_like(ks)
    # independent levels: exact interval per k.  Levels that other loops'
    # bounds reference are folded with their dependents below instead.
    for l, (c, lv) in enumerate(zip(form.coefs, form.levels), start=1):
        if lv[0] == "idx" or l in referenced:
            continue
        t = trips_of(lv)
        alive &= t >= 1
        l_, h_ = _interval(c, t)
        lo, hi = lo + l_, hi + h_
    # dependent groups: enumerate the referenced level's index.  The k
    # axis is processed in blocks so the [K_block, M] fold stays tens of
    # MB at any problem size (same discipline as deps._PAIR_BLOCK).
    for m in referenced:
        m_lv = form.levels[m - 1]
        if m_lv[0] == "idx":
            # chained inner bounds are out of contract; the contract pass
            # reports it — be conservative here by treating the chain at
            # its static maximum (never hides an alive domain)
            m_lv = ("const", m_lv[-1])
        tm = trips_of(m_lv)                       # [K] trips of level m
        mmax = int(tm.max(initial=0))
        if mmax < 1:
            alive &= False
            continue
        mvals = np.arange(mmax, dtype=np.int64)   # [M]
        big = np.int64(np.iinfo(np.int64).max // 4)
        kblock = max(1, (1 << 22) // mmax)
        for b0 in range(0, len(ks), kblock):
            sl = slice(b0, min(b0 + kblock, len(ks)))
            kb = sl.stop - sl.start
            valid = mvals[None, :] < tm[sl, None]      # [Kb, M]
            cell_lo = form.coefs[m - 1] * mvals[None, :] \
                + np.zeros((kb, 1), np.int64)
            cell_hi = cell_lo.copy()
            for c, lv in zip(form.coefs, form.levels):
                if lv[0] != "idx" or lv[1] != m:
                    continue
                t = np.broadcast_to(trips_of(lv, mvals)[None, :],
                                    (kb, mmax))
                valid = valid & (t >= 1)
                l_, h_ = _interval(c, t)
                cell_lo, cell_hi = cell_lo + l_, cell_hi + h_
            any_cell = valid.any(axis=1)
            alive[sl] &= any_cell
            lo[sl] += np.where(
                any_cell, np.where(valid, cell_lo, big).min(axis=1), 0)
            hi[sl] += np.where(
                any_cell, np.where(valid, cell_hi, -big).max(axis=1), 0)
    return alive, lo, hi


def addr_range(form: AddrForm) -> tuple[int, int] | None:
    """Exact (min, max) element address over the whole iteration domain,
    or None when the reference never executes."""
    alive, lo, hi = inner_profile(form)
    if not alive.any():
        return None
    ks = np.arange(form.trip0, dtype=np.int64)
    base = form.const + form.k_coef * ks
    return (int((base + lo)[alive].min()), int((base + hi)[alive].max()))
