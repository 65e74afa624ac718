"""Proof-carrying static schedule auto-optimizer (``cli tune``, PL9xx).

The port's copy of ``pluss/analysis/tune.py``.  One difference: the
port's engine keeps every share unique and has no share cap, so the
JAX package's ``share_cap`` search axis is gone: every candidate's label
and document print the constant :data:`pluss_torch.config.SHARE_CAP`
where JAX prints its default cap, so the lines and JSON stay the JAX
package's byte for byte.

PLUSS exists to evaluate parallelization choices *without running them*
(PAPER.md §0); this pass is where the repo finally ACTS on its own
analysis.  Given a workload and a candidate space over
``(threads, chunk, window)``, the optimizer scores every
schedule entirely on the host — the derivability ladder
(:func:`pluss_torch.analysis.ri.predict`) composed through CRI + AET and the
hierarchy model's LLC read-off
(:func:`pluss_torch.model.hierarchy.level_readoffs`) — and returns a TYPED,
proof-carrying verdict instead of a bare argmin:

- **PL901** proven-best schedule: every competitor was either fully
  derived and scored worse by more than the tie epsilon, or discarded by
  the dominance proof below.  The winning/runner-up margin attaches.
- **PL902** tie-within-epsilon: two or more schedules score within
  ``TIE_EPS`` of the optimum (e.g. chunk size at ``threads=1``, or the
  window axis, which shapes the dispatch but provably never the static
  miss ratio).  The canonical pick (fewest threads, smallest
  chunk) is named, with the full tie set attached.
- **PL903** typed refusal: some candidate that pruning could not discard
  fell off the derivability ladder (PL701/PL702) — no proven-best claim
  exists, and the cause chain attaches.  Never a silent approximation.
- **PL904** cross-check alarm (``--check`` only): a live engine run
  under the winning schedule disagreed with the predicted MRC beyond
  :data:`pluss_torch.analysis.ri.MRC_EPS` — a soundness bug in exactly one of
  the two stacks.

**Dominance pruning** (the reason the search is exhaustive-with-pruning,
not exhaustive): a candidate is discarded WITHOUT full derivation only
when both of its cheap static quantities are dominated — its exact
per-thread footprint (the compulsory floor ``cold/N`` from
:func:`pluss_torch.analysis.footprint.mrc_bracket`, exact for any schedule)
already exceeds the incumbent's fully-derived score by more than the tie
epsilon, and its plateau bracket can only tighten that claim (a target
below ``c_lo`` means the true curve sits strictly ABOVE the floor).
Soundness: every replacement model this repo prices — the exact LRU AET
read-off, the associativity Poisson model, and the random-replacement
fixed point — carries the cold mass additively, so any schedule's miss
ratio at ANY cache size is >= its compulsory floor.  A floor-dominated
candidate therefore can neither take PL901 nor enter the PL902 tie set.
Candidates are derived in floor-ascending order, which both maximizes
pruning and guarantees a pruned candidate could never have become the
incumbent.

Every full derivation rides the same budget gate as ``cli predict``
(``PLUSS_PREDICT_BUDGET``); the search makes ZERO device dispatches
(witnessed in bench via :data:`pluss_torch.engine.DEVICE_DISPATCHES`).
"""

from __future__ import annotations

import dataclasses

from pluss_torch import obs
from pluss_torch.analysis import footprint as footprint_mod
from pluss_torch.analysis import ri as ri_mod
from pluss_torch.analysis.diagnostics import Diagnostic, Severity
from pluss_torch.config import DEFAULT, SHARE_CAP, SamplerConfig
from pluss_torch.model import hierarchy as hier_mod
from pluss_torch.spec import LoopNestSpec

#: two schedules within this of each other are a PL902 tie, not a win —
#: the same epsilon the engine cross-check uses, so "proven better" here
#: and "matches the engine" in --check mean the same distance
TIE_EPS = ri_mod.MRC_EPS

#: default search axes: the sweep's conventional thread/chunk grid, one
#: canonical dispatch shape (full scan).  The window axis shapes the
#: DISPATCH, never the static miss ratio — widening it only grows the
#: PL902 tie set (asserted in tests).
DEFAULT_THREADS = (1, 2, 4, 8)
DEFAULT_CHUNKS = (1, 2, 4, 8)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One schedule point of the search space."""

    threads: int
    chunk: int
    window: int | None = None

    def cfg(self, base: SamplerConfig, cache_kb: int) -> SamplerConfig:
        """The SamplerConfig this candidate scores under: its schedule
        axes on ``base``, with the curve capacity pinned to the tuning
        target so the LLC read-off is never range-capped."""
        return dataclasses.replace(base, thread_num=self.threads,
                                   chunk_size=self.chunk,
                                   cache_kb=cache_kb)

    def label(self) -> str:
        w = "-" if self.window is None else str(self.window)
        return (f"threads={self.threads} chunk={self.chunk} "
                f"window={w} share_cap={SHARE_CAP}")


def space(threads=DEFAULT_THREADS, chunks=DEFAULT_CHUNKS,
          windows=(None,)) -> list[Candidate]:
    """The cross product of the three schedule axes, canonical order."""
    return [Candidate(int(t), int(c), w)
            for t in threads for c in chunks for w in windows]


@dataclasses.dataclass
class ScoredCandidate:
    """One candidate's search record: the cheap static quantities are
    always present; ``report``/``score`` only after full derivation."""

    candidate: Candidate
    floor: float                  # exact compulsory lower bound (cold/N)
    c_lo: int                     # plateau bracket, from mrc_bracket
    c_hi: int
    pruned: bool = False
    report: object = None         # ri.PredictReport when derived
    score: float | None = None    # LLC read-off when derivable
    refused: bool = False

    def doc(self) -> dict:
        c = self.candidate
        d = {"threads": c.threads, "chunk": c.chunk, "window": c.window,
             "share_cap": SHARE_CAP, "floor": self.floor,
             "bracket": [self.c_lo, self.c_hi], "pruned": self.pruned}
        if self.score is not None:
            d["score"] = self.score
        if self.refused:
            d["refused"] = True
        return d


@dataclasses.dataclass
class TuneReport:
    """The search's full proof record: every candidate's disposition,
    the typed verdict, and the diagnostics that carry it."""

    model: str
    target_kb: int
    target_entries: int
    hier: hier_mod.HierarchyConfig
    candidates: list[ScoredCandidate]
    code: str                           # PL901 | PL902 | PL903
    winner: ScoredCandidate | None
    ties: list[ScoredCandidate]         # winner included when PL902
    margin: float | None                # vs best non-tied runner-up
    diagnostics: list[Diagnostic]

    @property
    def n_pruned(self) -> int:
        return sum(1 for s in self.candidates if s.pruned)

    @property
    def n_derived(self) -> int:
        return sum(1 for s in self.candidates if s.score is not None)

    def doc(self) -> dict:
        d = {
            "model": self.model,
            "target_kb": self.target_kb,
            "target_entries": self.target_entries,
            "hierarchy": {"levels_kb": list(self.hier.levels_kb),
                          "assoc": self.hier.assoc,
                          "policy": self.hier.policy},
            "verdict": self.code,
            "candidates": [s.doc() for s in self.candidates],
            "n_pruned": self.n_pruned,
            "n_derived": self.n_derived,
        }
        if self.winner is not None:
            d["winner"] = self.winner.doc()
            d["tie"] = [s.candidate.label() for s in self.ties]
            if self.margin is not None:
                d["margin"] = self.margin
        d["diagnostics"] = [g.to_dict() for g in self.diagnostics]
        return d


def _score_of(rep, cfg: SamplerConfig,
              hier: hier_mod.HierarchyConfig) -> float | None:
    """The tuning objective: the declared LLC's miss ratio under the
    configured assoc/policy model — the last
    :func:`~pluss_torch.model.hierarchy.level_readoffs` row, which is the
    reference-exact LRU read-off in the default geometry."""
    if rep.rihist is None:
        return None
    return float(hier_mod.level_readoffs(rep.rihist, cfg,
                                         hier)[-1]["miss_ratio"])


def tune(spec: LoopNestSpec, base_cfg: SamplerConfig = DEFAULT,
         candidates: list[Candidate] | None = None,
         hier: hier_mod.HierarchyConfig | None = None,
         budget: int | None = None,
         tie_eps: float = TIE_EPS) -> TuneReport:
    """Search the candidate space, return the proof-carrying verdict.

    Pure host math end to end: zero device dispatches.  ``budget`` rides
    the same ``PLUSS_PREDICT_BUDGET`` gate as ``cli predict`` (None =
    the env knob / default); pruned candidates never spend any of it.
    """
    cands = candidates if candidates is not None else space()
    if not cands:
        raise ValueError("tune: empty candidate space")
    hier = hier or hier_mod.HierarchyConfig.from_env()
    target_kb = int(hier.levels_kb[-1])
    target_entries = hier_mod.entries_of_kb(target_kb)
    if budget is None:
        budget = ri_mod.predict_budget()

    with obs.span("tune.search", model=spec.name, candidates=len(cands)):
        scored: list[ScoredCandidate] = []
        for cand in cands:
            cfg = cand.cfg(base_cfg, target_kb)
            br = footprint_mod.mrc_bracket(spec, cfg)
            scored.append(ScoredCandidate(cand, float(br.floor),
                                          int(br.c_lo), int(br.c_hi)))
        # floor-ascending derivation order: maximal pruning, and a pruned
        # candidate provably could never have become the incumbent (the
        # incumbent's score >= its own floor >= every later floor seen)
        order = sorted(range(len(scored)),
                       key=lambda i: (scored[i].floor, i))
        # the static score is invariant along the window axis (it
        # shapes the dispatch, not the reuse distribution), so one
        # derivation per (threads, chunk) covers the whole fiber
        memo: dict[tuple[int, int], tuple[object, float | None]] = {}
        best: ScoredCandidate | None = None
        refusal_chain: list[Diagnostic] = []
        for i in order:
            s = scored[i]
            if best is not None and best.score is not None \
                    and s.floor > best.score + tie_eps:
                # dominance proof: compulsory floor (exact footprint)
                # already beaten; the bracket only tightens the claim
                # (target below c_lo => true score strictly above floor)
                s.pruned = True
                obs.counter_add("tune.pruned")
                continue
            cand = s.candidate
            key = (cand.threads, cand.chunk)
            cfg = cand.cfg(base_cfg, target_kb)
            fresh = key not in memo
            if fresh:
                rep = ri_mod.predict(spec, cfg, budget=budget)
                sc = _score_of(rep, cfg, hier)
                memo[key] = (rep, sc)
                obs.counter_add("tune.derived")
            else:
                rep, sc = memo[key]
                obs.counter_add("tune.memo_hits")
            if sc is None:
                # off the derivability ladder: the PL701/702 chain rides
                # the report; the whole tune becomes a PL903 refusal
                s.refused = True
                if fresh:
                    refusal_chain += [
                        d for d in rep.prediction.diagnostics
                        if d.code in ("PL701", "PL702")]
                continue
            s.report, s.score = rep, sc
            if best is None or sc < best.score:
                best = s

    diags: list[Diagnostic] = []
    if any(s.refused for s in scored):
        n_ref = sum(1 for s in scored if s.refused)
        diags.append(Diagnostic(
            "PL903", Severity.WARNING,
            f"tune refused: {n_ref} candidate schedule(s) fell off the "
            "derivability ladder — no proven-best claim (cause chain "
            "attached); raise PLUSS_PREDICT_BUDGET or narrow the space"))
        diags += refusal_chain
        return TuneReport(spec.name, target_kb, target_entries, hier,
                          scored, "PL903", None, [], None, diags)

    derived = [s for s in scored if s.score is not None]
    best_score = min(s.score for s in derived)
    ties = [s for s in derived if s.score <= best_score + tie_eps]
    # canonical pick: fewest threads, then smallest chunk/window —
    # deterministic, so tune's answer is reproducible run to run
    winner = min(ties, key=lambda s: (
        s.candidate.threads, s.candidate.chunk, s.candidate.window or 0))
    # proven margin LOWER BOUND: a derived runner-up contributes its
    # exact score; a pruned candidate contributes its compulsory floor
    # (<= its true score, so the bound stays sound)
    tie_ids = {id(s) for s in ties}
    rest = [s.score if s.score is not None else s.floor
            for s in scored if id(s) not in tie_ids]
    margin = (min(rest) - winner.score) if rest else None
    if len(ties) > 1:
        code = "PL902"
        diags.append(Diagnostic(
            "PL902", Severity.INFO,
            f"{len(ties)} schedules tie within {tie_eps:g} at predicted "
            f"miss {winner.score:.6g} ({target_kb} KB LLC); canonical "
            f"pick {winner.candidate.label()}"))
    else:
        code = "PL901"
        m = f", margin >= {margin:.6g} over every competitor" \
            if margin is not None else ""
        diags.append(Diagnostic(
            "PL901", Severity.INFO,
            f"proven-best schedule {winner.candidate.label()}: predicted "
            f"miss {winner.score:.6g} at {target_kb} KB LLC{m} "
            f"({len(scored)} candidates: {len(derived)} derived, "
            f"{sum(1 for s in scored if s.pruned)} pruned by dominance)"))
    # the winner's own derivation notes (PL703 method, PL704 alarm if
    # the prover ever trips) ride the tune report too
    diags += list(winner.report.prediction.diagnostics)
    return TuneReport(spec.name, target_kb, target_entries, hier, scored,
                      code, winner, ties if len(ties) > 1 else [winner],
                      margin, diags)


def check_winner(spec: LoopNestSpec, report: TuneReport,
                 base_cfg: SamplerConfig = DEFAULT, *, device=None
                 ) -> tuple[bool, dict, list[Diagnostic]]:
    """The ``--check`` cross-validation: run the engine ONCE under the
    winning schedule and require the predicted histograms bit-identical
    and the MRC within :data:`~pluss_torch.analysis.ri.MRC_EPS`
    (:func:`~pluss_torch.analysis.ri.check_against_engine`).  Disagreement is
    the PL904 alarm — a soundness bug in the predictor, the engine, or
    the tuner's composition of them.  The ONLY device work in tune: the
    run goes to ``device`` (default the CUDA card, as for
    :func:`pluss_torch.engine.run`; with no card it raises, never moving
    to the CPU on its own)."""
    from pluss_torch import engine

    if report.winner is None:
        raise ValueError("check_winner: no winner (refused tune report)")
    w = report.winner
    cfg = w.candidate.cfg(base_cfg, report.target_kb)
    res = engine.run(spec, cfg, device=device,
                     window_accesses=w.candidate.window)
    ok, detail = ri_mod.check_against_engine(w.report, res, cfg)
    diags: list[Diagnostic] = []
    if not ok:
        diags.append(Diagnostic(
            "PL904", Severity.ERROR,
            f"tuned-winner cross-check failed for "
            f"{w.candidate.label()}: live engine run disagrees with the "
            f"predicted MRC beyond {ri_mod.MRC_EPS:g} ({detail})"))
    return ok, detail, diags
