"""Dependence direction/distance vectors per conflicting reference pair.

The port's copy of ``pluss/analysis/depvec.py``.

The deps core (:mod:`pluss_torch.analysis.deps`) answers ONE question —
"can two references touch the same element across the parallel
dimension?" — exactly in ``k`` and Banerjee-style in the inner indices.
Loop TRANSFORMATIONS (interchange, tiling, fusion — :mod:`pluss_torch.
analysis.transform`) need the finer classical object: for every
conflicting pair, the set of *dependence direction vectors* over the
common loop levels, each with a concrete witness instance pair.

For a rectangular nest every address is affine in the per-level loop
INDICES (:func:`pluss_torch.analysis.walk.addr_form`)::

    addr_1(x⃗) = addr_2(y⃗)   with   x_j, y_j in [0, trip_j)

A dependence edge ``src -> dst`` exists when some solution has the dst
instance executing after the src instance; its direction vector is the
per-common-level sign of ``iv_dst - iv_src`` and its distance vector is
one concrete such delta (THE distance when the dependence is uniform).
The solver enumerates the ``3^c`` sign patterns and searches each for a
witness with an exact depth-first walk over the per-level contribution
groups, pruned by interval + gcd reachability of the remaining suffix —
so every reported vector carries a CONCRETE instance pair (the PL952
requirement downstream), and an exhausted pattern is a proof of
infeasibility, not a guess.  The walk is budgeted
(``PLUSS_DEPVEC_BUDGET`` nodes per nest); blowing the budget is a typed
refusal (the PL953 cause chain), never a silent approximation.

Triangular/quad nests couple the per-level ranges (the trip depends on
an outer index), which breaks the independent-group search — those nests
refuse with the same typed cause the static predictor uses for its ladder
(PL601/PL701 class: the nest is outside the rectangular vector
contract).

The vectors are surfaced on the ``cli analyze --json`` doc
(``doc["depvectors"]``) and appended as evidence to the PL301/302 race
findings (:func:`annotate_races`), and they are the sole input of the
transform legality prover.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import re

from pluss_torch.analysis.walk import RefSite, addr_form, ref_sites
from pluss_torch.spec import Loop, LoopNestSpec, Ref, SpecContractError
from pluss_torch.utils.envknob import env_int

#: DFS node budget per nest (all pairs, all sign patterns).  The repo's
#: registry shapes prune to a few thousand nodes per pair at n=128; the
#: default leaves two orders of magnitude of headroom.
DEFAULT_BUDGET = 1 << 18


def vector_budget() -> int:
    return env_int("PLUSS_DEPVEC_BUDGET", DEFAULT_BUDGET, minimum=1)


class VectorBudgetExceeded(Exception):
    """The witness walk ran out of nodes — typed refusal, never a guess."""


@dataclasses.dataclass(frozen=True)
class DepEdge:
    """One dependence edge ``src -> dst`` with direction + witness.

    ``sigma`` is the direction vector over the COMMON loop levels
    (sink minus source, entries in {-1, 0, +1}, lexicographically
    nonnegative by construction); ``distance`` is the witness delta
    (the exact distance whenever the dependence is uniform).
    ``src_iv``/``dst_iv`` are the concrete witness instances — full
    per-level index vectors over each site's own chain.
    """

    src: RefSite
    dst: RefSite
    sigma: tuple[int, ...]
    distance: tuple[int, ...]
    src_iv: tuple[int, ...]
    dst_iv: tuple[int, ...]
    kind: str                      # "flow" | "anti" | "output"

    @property
    def carried(self) -> int | None:
        """The outermost level carrying the dependence (first nonzero
        direction entry); None = loop-independent."""
        for lvl, s in enumerate(self.sigma):
            if s:
                return lvl
        return None

    def label(self) -> str:
        vec = ",".join("<" if s > 0 else ">" if s < 0 else "="
                       for s in self.sigma)
        return f"{self.src.ref.name}->{self.dst.ref.name} ({vec})"

    def doc(self) -> dict:
        return {
            "src": self.src.ref.name, "dst": self.dst.ref.name,
            "src_path": self.src.path, "dst_path": self.dst.path,
            "array": self.src.ref.array, "kind": self.kind,
            "vector": list(self.sigma), "distance": list(self.distance),
            "src_iv": list(self.src_iv), "dst_iv": list(self.dst_iv),
            "carried": self.carried,
        }


@dataclasses.dataclass
class NestVectors:
    """One nest's dependence-vector record: the edges, or the typed
    refusal cause when the nest is outside the vector contract."""

    nest: int
    edges: list[DepEdge]
    refused: str | None = None     # cause text; None when computed


def _body_path(path: str) -> tuple[int, ...]:
    return tuple(int(m) for m in re.findall(r"body\[(\d+)\]", path))


def _rect_refusal(nest: Loop, ni: int) -> str | None:
    """The PL601/PL701-class cause text when the nest is outside the
    rectangular vector contract, else None."""

    def walk(item) -> str | None:
        if isinstance(item, Ref):
            return None
        if item.bound_coef is not None or item.start_coef:
            return ("triangular loop (bound_coef/start_coef) couples the "
                    "per-level index ranges — outside the rectangular "
                    "vector contract (PL601/PL701-class cause)")
        for b in item.body:
            cause = walk(b)
            if cause is not None:
                return cause
        return None

    return walk(nest)


def common_depth(p1: RefSite, p2: RefSite) -> int:
    """Number of loop levels the two same-nest sites share (>= 1: the
    nest root is always common)."""
    b1 = _body_path(p1.path)[:-1]   # body indices leading to each loop
    b2 = _body_path(p2.path)[:-1]
    c = 1
    while c <= min(len(b1), len(b2)) and b1[:c] == b2[:c]:
        c += 1
    return min(c, p1.depth, p2.depth)


# --- the per-pattern witness search ----------------------------------------


@dataclasses.dataclass
class _Group:
    """One independent contribution group of the pair equation: a set of
    candidate assignments each adding ``value`` to the left-hand side.
    ``tag`` maps an assignment back to the instance vectors."""

    tag: tuple                     # ("common", j) | ("t1", j) | ("t2", j)
    lo: int
    hi: int
    gcd: int
    candidates: object             # callable -> iterator of (value, assign)
    count: int                     # candidate-set size (search order)


def _d_range(sigma: int, trip: int) -> tuple[int, int] | None:
    """Allowed ``y - x`` range under one direction sign, or None when
    empty (a nonzero sign needs the level to be able to move)."""
    if sigma == 0:
        return (0, 0)
    if trip < 2:
        return None
    return (1, trip - 1) if sigma > 0 else (-(trip - 1), -1)


def _common_group(j: int, trip: int, c1: int, c2: int,
                  dlo: int, dhi: int) -> _Group:
    """Contribution ``c2*y - c1*x`` of one common level with
    ``y - x in [dlo, dhi]`` and both indices in ``[0, trip)``."""
    T = trip - 1
    if c1 == c2 == 0:
        # no address contribution: one canonical assignment suffices
        def cands():
            yield 0, (max(0, -dlo), max(0, -dlo) + dlo)

        return _Group(("common", j), 0, 0, 0, cands, 1)
    if c1 == c2:
        cc = c1

        def cands():
            for d in range(dlo, dhi + 1):
                yield cc * d, (max(0, -d), max(0, -d) + d)

        vals = (cc * dlo, cc * dhi)
        return _Group(("common", j), min(vals), max(vals),
                      abs(cc), cands, dhi - dlo + 1)
    if c1 == 0:
        ylo, yhi = max(0, dlo), min(T, T + dhi)

        def cands():
            for y in range(ylo, yhi + 1):
                yield c2 * y, (min(T, y - dlo), y)

        vals = (c2 * ylo, c2 * yhi)
        return _Group(("common", j), min(vals), max(vals),
                      abs(c2), cands, yhi - ylo + 1)
    if c2 == 0:
        xlo, xhi = max(0, -dhi), min(T, T - dlo)

        def cands():
            for x in range(xlo, xhi + 1):
                yield -c1 * x, (x, max(0, x + dlo))

        vals = (-c1 * xlo, -c1 * xhi)
        return _Group(("common", j), min(vals), max(vals),
                      abs(c1), cands, xhi - xlo + 1)

    # both nonzero, different: enumerate (x, d) jointly (budget-guarded)
    def cands():
        for x in range(0, T + 1):
            for d in range(max(dlo, -x), min(dhi, T - x) + 1):
                yield c2 * (x + d) - c1 * x, (x, x + d)

    corners = [c2 * (x + d) - c1 * x
               for x in (0, T) for d in (dlo, dhi)
               if 0 <= x + d <= T] or [0]
    return _Group(("common", j), min(corners), max(corners),
                  math.gcd(abs(c1), abs(c2)), cands,
                  (T + 1) * (dhi - dlo + 1))


def _tail_group(tag: tuple, coef: int, trip: int, sign: int) -> _Group:
    """Contribution ``sign * coef * idx`` of a non-shared level."""
    T = trip - 1
    cc = sign * coef
    if cc == 0:
        # no address contribution: one canonical assignment suffices
        def cands():
            yield 0, 0

        return _Group(tag, 0, 0, 0, cands, 1)

    def cands():
        for v in range(0, T + 1):
            yield cc * v, v

    vals = (0, cc * T)
    return _Group(tag, min(vals), max(vals), abs(cc), cands, T + 1)


def _search(groups: list[_Group], target: int,
            budget: list[int]) -> dict | None:
    """Exact DFS for one assignment summing to ``target``; interval +
    gcd pruning over the remaining suffix.  Returns {tag: assign} or
    None (a PROOF of infeasibility); raises on budget exhaustion."""
    # small candidate sets first: the large-stride groups stay in the
    # suffix, where their shared gcd prunes whole subtrees at once
    groups = sorted(groups, key=lambda g: g.count)
    n = len(groups)
    suf_lo = [0] * (n + 1)
    suf_hi = [0] * (n + 1)
    suf_g = [0] * (n + 1)
    for i in range(n - 1, -1, -1):
        suf_lo[i] = suf_lo[i + 1] + groups[i].lo
        suf_hi[i] = suf_hi[i + 1] + groups[i].hi
        suf_g[i] = math.gcd(suf_g[i + 1], groups[i].gcd)

    out: dict = {}

    def walk(i: int, rem: int) -> bool:
        budget[0] -= 1
        if budget[0] < 0:
            raise VectorBudgetExceeded()
        if not suf_lo[i] <= rem <= suf_hi[i]:
            return False
        if (rem % suf_g[i] if suf_g[i] else rem) != 0:
            return False
        if i == n:
            return True
        for value, assign in groups[i].candidates():
            if walk(i + 1, rem - value):
                out[groups[i].tag] = assign
                return True
        return False

    return out if walk(0, target) else None


def _pattern_witness(f1, f2, c: int, sigma: tuple[int, ...],
                     budget: list[int]) -> tuple | None:
    """A concrete ``(iv1, iv2)`` solving ``addr_1(iv1) == addr_2(iv2)``
    with the given per-common-level direction signs, or None."""
    c1 = (f1.k_coef,) + f1.coefs
    c2 = (f2.k_coef,) + f2.coefs
    t1 = (f1.trip0,) + tuple(lv[1] for lv in f1.levels)
    t2 = (f2.trip0,) + tuple(lv[1] for lv in f2.levels)
    if any(t < 1 for t in t1) or any(t < 1 for t in t2):
        return None
    groups: list[_Group] = []
    for j in range(c):
        rng = _d_range(sigma[j], t1[j])
        if rng is None:
            return None
        groups.append(_common_group(j, t1[j], c1[j], c2[j], *rng))
    for j in range(c, len(t1)):
        groups.append(_tail_group(("t1", j), c1[j], t1[j], -1))
    for j in range(c, len(t2)):
        groups.append(_tail_group(("t2", j), c2[j], t2[j], +1))
    sol = _search(groups, f1.const - f2.const, budget)
    if sol is None:
        return None
    iv1 = [0] * len(t1)
    iv2 = [0] * len(t2)
    for tag, assign in sol.items():
        kind, j = tag
        if kind == "common":
            iv1[j], iv2[j] = assign
        elif kind == "t1":
            iv1[j] = assign
        else:
            iv2[j] = assign
    return tuple(iv1), tuple(iv2)


def _edge_kind(src: RefSite, dst: RefSite) -> str:
    if src.ref.is_write and dst.ref.is_write:
        return "output"
    return "flow" if src.ref.is_write else "anti"


def _lex(sigma: tuple[int, ...]) -> int:
    """-1 / 0 / +1: lexicographic sign of a direction pattern."""
    for s in sigma:
        if s:
            return 1 if s > 0 else -1
    return 0


def pair_edges(p1: RefSite, p2: RefSite,
               budget: list[int]) -> list[DepEdge]:
    """All dependence edges between two same-nest sites (``p1`` may be
    ``p2``: self-dependences), each with direction vector + witness.
    Edges are normalized so the source is the program-earlier access and
    the vector is lexicographically nonnegative."""
    f1, f2 = addr_form(p1), addr_form(p2)
    same = p1.path == p2.path
    c = p1.depth if same else common_depth(p1, p2)
    edges: list[DepEdge] = []
    for sigma in itertools.product((-1, 0, 1), repeat=c):
        lex = _lex(sigma)
        if same and lex <= 0:
            continue  # self: delta==0 is the same instance; -sigma mirrors
        wit = _pattern_witness(f1, f2, c, sigma, budget)
        if wit is None:
            continue
        iv1, iv2 = wit
        delta = tuple(iv2[j] - iv1[j] for j in range(c))
        if lex > 0 or (lex == 0
                       and _body_path(p1.path) < _body_path(p2.path)):
            src, dst, siv, div = p1, p2, iv1, iv2
            vec, dist = sigma, delta
        else:
            src, dst, siv, div = p2, p1, iv2, iv1
            vec = tuple(-s for s in sigma)
            dist = tuple(-d for d in delta)
        edges.append(DepEdge(src, dst, vec, dist, siv, div,
                             _edge_kind(src, dst)))
    return edges


def fusion_backward_witness(p1: RefSite, p2: RefSite,
                            budget: list[int]) -> tuple | None:
    """Fusion-preventing backward dependence test for a cross-nest pair
    (``p1`` in the earlier nest, ``p2`` in the later): a conflict with
    the later nest's instance at a strictly SMALLER outer-loop index —
    after fusing the (compatible) outer loops that instance would run
    before its source.  Returns the witness ``(iv1, iv2)`` or None
    (a proof there is none)."""
    f1, f2 = addr_form(p1), addr_form(p2)
    return _pattern_witness(f1, f2, 1, (-1,), budget)


def nest_vectors(spec: LoopNestSpec, ni: int,
                 budget: int | None = None) -> NestVectors:
    """All write-involving dependence edges of one nest, or the typed
    refusal when the nest is outside the vector contract."""
    nest = spec.nests[ni]
    cause = _rect_refusal(nest, ni)
    if cause is not None:
        return NestVectors(ni, [], cause)
    sites = [s for s in ref_sites(spec) if s.nest == ni]
    remaining = [budget if budget is not None else vector_budget()]
    edges: list[DepEdge] = []
    try:
        by_array: dict[str, list[RefSite]] = {}
        for s in sites:
            by_array.setdefault(s.ref.array, []).append(s)
        for arr in sorted(by_array):
            group = by_array[arr]
            for i, p in enumerate(group):
                for q in group[i:]:
                    if not (p.ref.is_write or q.ref.is_write):
                        continue
                    try:
                        edges += pair_edges(p, q, remaining)
                    except SpecContractError:
                        continue  # the contract pass owns this report
    except VectorBudgetExceeded:
        return NestVectors(ni, [], (
            "dependence witness search exceeded the "
            f"PLUSS_DEPVEC_BUDGET node budget ({vector_budget()}) — "
            "typed refusal (PL702-class cause), never a guess"))
    edges.sort(key=lambda e: (e.src.path, e.dst.path, e.sigma))
    return NestVectors(ni, edges)


def spec_vectors(spec: LoopNestSpec,
                 budget: int | None = None) -> list[NestVectors]:
    return [nest_vectors(spec, ni, budget)
            for ni in range(len(spec.nests))]


# --- doc / rendering / race-evidence surfaces ------------------------------


def doc_of(vectors: list[NestVectors]) -> dict:
    """The ``doc["depvectors"]`` block of ``cli analyze --json``."""
    nests = []
    for nv in vectors:
        if nv.refused is not None:
            nests.append({"nest": nv.nest, "refused": nv.refused})
        else:
            nests.append({"nest": nv.nest,
                          "edges": [e.doc() for e in nv.edges]})
    return {"nests": nests,
            "edges": sum(len(nv.edges) for nv in vectors)}


def render(doc: dict) -> list[str]:
    """The rendered table block of the analyze text report: one line per
    dependence edge (direction, distance, kind, carried level)."""
    lines = ["depvectors:"]
    for nd in doc["nests"]:
        if "refused" in nd:
            lines.append(f"  nest {nd['nest']}: refused — {nd['refused']}")
            continue
        for e in nd["edges"]:
            vec = "(" + ",".join(str(v) for v in e["vector"]) + ")"
            dist = "(" + ",".join(str(v) for v in e["distance"]) + ")"
            carried = ("loop-independent" if e["carried"] is None
                       else f"carried@{e['carried']}")
            lines.append(
                f"  nest {nd['nest']} {e['array']}: {e['src']}->"
                f"{e['dst']} {e['kind']} dir {vec} dist {dist} "
                f"({carried})")
        if not nd["edges"]:
            lines.append(f"  nest {nd['nest']}: no write-involving "
                         "dependences")
    return lines


def annotate_races(diags: list, vectors: list[NestVectors]) -> list:
    """Append the dependence-vector evidence to PL301/302 findings: the
    race verdict names the conflicting pairs; the vectors SAY WHY (the
    per-level directions that let two parallel iterations collide)."""
    import dataclasses as dc

    by_key: dict[tuple[int, str], list[str]] = {}
    for nv in vectors:
        for e in nv.edges:
            if e.carried == 0:   # only parallel-carried edges are races
                by_key.setdefault((nv.nest, e.src.ref.array), []).append(
                    e.label())
    out = []
    for d in diags:
        evid = by_key.get((d.nest, d.array)) if d.code in ("PL301",
                                                           "PL302") else None
        if evid:
            seen: list[str] = []
            for s in evid:
                if s not in seen:
                    seen.append(s)
            from pluss_torch.analysis.diagnostics import shown

            d = dc.replace(d, message=d.message
                           + f" [dep vectors: {shown(seen)}]")
        out.append(d)
    return out
