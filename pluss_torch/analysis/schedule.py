"""Placement refinement: race/reuse verdicts under the REAL chunk schedule.

The port's copy of ``pluss/analysis/schedule.py``.

The race pass (:mod:`pluss_torch.analysis.deps`) asks whether two DISTINCT
parallel iterations can touch the same element — the schedule-blind
question, right for ``cli lint`` (a spec should be safe under *any*
schedule).  But PLUSS's engine runs one concrete static schedule: chunk
``cid`` of the parallel loop is served by thread ``cid % T``
(:class:`pluss_torch.sched.ChunkSchedule`), so two conflicting iterations whose
chunks land on the SAME thread are executed sequentially by one simulated
thread — no race, and exactly the pairs whose reuse the per-thread
last-access tables can observe.

This pass re-runs the dependence tests with the owner map folded into the
pair relation (exact: the parallel axis is enumerated, and the owner of
parallel index ``k`` is the closed form ``(k // chunk_size) % T`` — the
index-space twin of ``ChunkSchedule.static_tid``, valid for any
start/step because chunk ownership is index-based):

- ``cross_thread``: a feasible conflicting pair lands on two DIFFERENT
  threads — the placement-refined race verdict.  PL301/PL302 findings
  whose every feasible pair is same-thread downgrade to PL304 (INFO).
- ``observed``: a feasible DIRECTED pair lands on ONE thread — the
  refined "can the per-thread LAT observe this reuse" bit, sharpening the
  PL303 classification (PL305).  Cross-nest reuse pairs (the LAT persists
  across nests) refine the same way: both endpoints must be owned by the
  same thread under each nest's own schedule.

Soundness polarity is inherited from deps: refutations are proofs
(interval+gcd over-approximates the inner feasible set, and the k/owner
part is exact), confirmations are conservative.  The refined sets are
always subsets of the schedule-blind ones (the owner relation only
restricts), and the dynamic cross-check in ``tests/test_schedule.py``
pins: dynamically observed cross-parallel reuses ⊆ refined ⊆ unrefined,
for every registry model.
"""

from __future__ import annotations

import dataclasses

from pluss_torch.analysis import deps
from pluss_torch.analysis.diagnostics import Diagnostic, Severity, shown
from pluss_torch.config import SamplerConfig
from pluss_torch.spec import LoopNestSpec


def owner_of(cfg: SamplerConfig):
    """Index-space owner map of the static schedule: parallel index ``k``
    (0-based, any nest) is served by thread ``(k // CS) % T``."""
    CS, T = cfg.chunk_size, cfg.thread_num
    return lambda k: (k // CS) % T


@dataclasses.dataclass(frozen=True)
class SchedClass:
    """Schedule-refined classification of one reference."""

    site: object
    #: some same-array conflict pair puts this ref's iteration on a
    #: DIFFERENT thread than its partner (same nest — nests never race)
    cross_thread: bool
    #: the per-thread LAT can observe a parallel-crossing reuse at this
    #: ref under the schedule (same-thread directed pair, or a same-thread
    #: partner in an earlier nest)
    observed: bool
    #: outermost level carrying an OBSERVABLE self-reuse under the
    #: schedule (level 0 demands a same-thread pair; inner levels are
    #: same-thread by construction), or None
    carried_level: int | None


@dataclasses.dataclass
class SchedAnalysis:
    cfg: SamplerConfig
    base: deps.Analysis
    classes: dict[str, SchedClass]
    #: (nest, array, code) -> (cross_thread_pairs, private_pairs): the
    #: placement-refined split of each PL301/PL302 finding's pair list
    race_split: dict[tuple[int, str, str], tuple[list[str], list[str]]]


def _pair_cross_thread(p, q, own) -> bool:
    """Same-nest conflict on two different threads (symmetric)."""
    if p.form.trip0 != q.form.trip0 or p.form.trip0 <= 1:
        return False
    return deps._feasible(
        p, q, lambda k1, k2: (k1 != k2) & (own(k1) != own(k2)))


def _pair_same_thread_observed(p, q, own) -> bool:
    """Directed same-nest pair on ONE thread: q's earlier iteration and
    p's later one both run on the same simulated thread, so p's LAT holds
    q's touch."""
    if p.form.trip0 != q.form.trip0 or p.form.trip0 <= 1:
        return False
    return deps._feasible(
        p, q, lambda k1, k2: (k1 > k2) & (own(k1) == own(k2)))


def _cross_nest_same_thread(p, q, own) -> bool:
    """Cross-nest reuse pair owned by one thread with differing parallel
    VALUES (the dynamic observation records the previous touch's parallel
    value — see tests' InstrumentedOracle)."""
    l1, l2 = p.site.chain[0], q.site.chain[0]
    return deps._feasible(
        p, q,
        lambda k1, k2: ((l1.start + l1.step * k1)
                        != (l2.start + l2.step * k2))
        & (own(k1) == own(k2)))


def refine(spec: LoopNestSpec, cfg: SamplerConfig,
           analysis: deps.Analysis | None = None,
           skip_nests: frozenset[int] = frozenset()) -> SchedAnalysis:
    """Placement-refine a spec's dependence analysis under ``cfg``'s
    schedule.  Reuses the schedule-blind :class:`deps.Analysis` (profiles
    + memoized pair tests) — refined tests only run on pairs the blind
    test already confirmed (the owner relation is a sub-relation)."""
    ana = analysis if analysis is not None \
        else deps.analyze(spec, skip_nests)
    own = owner_of(cfg)
    memo: dict[tuple, bool] = {}

    def cross(p, q) -> bool:
        key = ("x", *sorted((ana._index[id(p)], ana._index[id(q)])))
        if key not in memo:
            memo[key] = ana.conflict(p, q) and _pair_cross_thread(p, q, own)
        return memo[key]

    classes: dict[str, SchedClass] = {}
    race_split: dict[tuple[int, str, str], tuple[list[str], list[str]]] = {}
    for (ni, array), group in sorted(ana.groups.items()):
        for i, p in enumerate(group):
            for q in group[i:]:
                if not (p.site.ref.is_write or q.site.ref.is_write):
                    continue
                if not ana.conflict(p, q):
                    continue
                code = "PL301" if (p.site.ref.is_write
                                   and q.site.ref.is_write) else "PL302"
                xt, priv = race_split.setdefault((ni, array, code),
                                                 ([], []))
                label = f"{p.site.ref.name}~{q.site.ref.name}"
                (xt if cross(p, q) else priv).append(label)

    for p in ana.profiles:
        group = ana.groups[(p.site.nest, p.site.ref.array)]
        cross_thread = any(cross(p, q) for q in group
                           if ana.conflict(p, q))
        observed = any(_pair_same_thread_observed(p, q, own)
                       for q in group if ana.conflict(p, q))
        if not observed:
            for q in ana.array_groups[p.site.ref.array]:
                if q.site.nest >= p.site.nest:
                    continue  # observation needs an EARLIER partner
                if ana.xconflict(p, q) and \
                        _cross_nest_same_thread(p, q, own):
                    observed = True
                    break
        levels = deps._self_carried_levels(p)
        if 0 in levels and not _pair_same_thread_observed(p, p, own):
            levels = [l for l in levels if l != 0]
        classes[p.site.path] = SchedClass(
            site=p.site,
            cross_thread=cross_thread,
            observed=observed,
            carried_level=min(levels) if levels else None,
        )
    return SchedAnalysis(cfg, ana, classes, race_split)


def check(spec: LoopNestSpec, cfg: SamplerConfig,
          analysis: deps.Analysis | None = None,
          skip_nests: frozenset[int] = frozenset()) -> list[Diagnostic]:
    """Placement-refined race diagnostics + sharpened reuse classification.

    Replaces the schedule-blind PL301/PL302 stream for ``cli analyze``:
    a finding whose every feasible pair is same-thread downgrades to PL304
    (INFO — the schedule serializes it); findings with at least one
    genuinely cross-thread pair keep their code and severity, with the
    schedule named.  PL305 (INFO) carries the refined per-reference
    classification next to lint's schedule-blind PL303.
    """
    sa = refine(spec, cfg, analysis, skip_nests)
    T, CS = cfg.thread_num, cfg.chunk_size
    sched_s = f"T={T}, chunk={CS}"
    diags: list[Diagnostic] = []
    for (ni, array, code), (xt, priv) in sorted(sa.race_split.items()):
        kind = "write-write" if code == "PL301" else "read-write"
        if xt:
            diags.append(Diagnostic(
                code=code, severity=Severity.WARNING,
                message=f"{kind} conflict on '{array}' lands on two "
                        f"threads under the schedule ({sched_s}): "
                        f"{shown(xt)} — the parallel pragma asserts this "
                        "is intended",
                nest=ni, array=array,
            ))
        elif priv:
            diags.append(Diagnostic(
                code="PL304", severity=Severity.INFO,
                message=f"{kind} conflict on '{array}' is thread-private "
                        f"under the schedule ({sched_s}): every feasible "
                        f"pair lands on one thread ({shown(priv)}) — "
                        f"{code} downgraded",
                nest=ni, array=array,
            ))
    for path, sc in sorted(sa.classes.items()):
        if sc.site.ref.share_span is None:
            continue
        lvl = sc.carried_level
        diags.append(Diagnostic(
            code="PL305", severity=Severity.INFO,
            message=(f"under the schedule ({sched_s}): observable reuse "
                     f"carried at level {'none' if lvl is None else lvl}"
                     + (" (parallel)" if lvl == 0 else "")
                     + f"; LAT-observable cross-parallel reuse: "
                       f"{sc.observed}; conflicts cross threads: "
                       f"{sc.cross_thread}"),
            path=path, nest=sc.site.nest, ref=sc.site.ref.name,
            array=sc.site.ref.array,
        ))
    return diags
