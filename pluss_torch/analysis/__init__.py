"""Static analysis over the Loop/Ref/LoopNestSpec IR.

The port's copy of ``pluss/analysis/__init__.py``.

Four passes feed one structured-diagnostics stream
(:mod:`pluss_torch.analysis.diagnostics` — stable PLxxx codes):

1. contract  (PL4xx) — the flatten-time structural restrictions, with
   tree paths (:mod:`pluss_torch.analysis.contract`);
2. bounds    (PL1xx) — exact address-range proofs against the declared
   array sizes (:mod:`pluss_torch.analysis.bounds`);
3. race/deps (PL3xx) — GCD + Banerjee-style dependence tests proving or
   refuting cross-thread conflicts on the parallel dimension, plus
   per-reference carried-level classification
   (:mod:`pluss_torch.analysis.deps`);
4. share     (PL2xx) — ``share_span`` recomputation from the carrying
   loop and consistency with the race classification
   (:mod:`pluss_torch.analysis.sharespan`).

Everything here is host-side Python/numpy over the declarative spec —
no device and no stream enumeration — so ``cli lint`` runs before
(and without) any kernel build.

Entry points: :func:`lint_spec` for one spec, ``cli lint`` (see
:mod:`pluss_torch.cli`) for the CLI surface, and ``--verify`` on the engine
modes for the opt-in pre-pass.
"""

from __future__ import annotations

from pluss_torch.analysis import (bounds, contract, deps, falseshare, footprint,
                            schedule, sharespan)
from pluss_torch.analysis.diagnostics import (CODES, Diagnostic, Severity,
                                        error_count, format_json,
                                        format_text, sort_key, with_model)
from pluss_torch.config import DEFAULT, SamplerConfig
from pluss_torch.spec import LoopNestSpec


def lint_spec(spec: LoopNestSpec) -> list[Diagnostic]:
    """Run all four schedule-blind passes over one spec; diagnostics
    sorted errors-first.

    Contract errors gate the semantic passes per nest: a nest the flatten
    rejects has no well-defined iteration domain, so bounds/race/share
    skip it instead of reasoning from garbage.
    """
    diags = contract.check(spec)
    bad = frozenset(d.nest for d in diags
                    if d.severity is Severity.ERROR and d.nest is not None)
    diags += bounds.check(spec, skip_nests=bad)
    ana = deps.analyze(spec, skip_nests=bad)  # profiled once, shared below
    diags += deps.check(spec, skip_nests=bad, analysis=ana)
    diags += sharespan.check(spec, ana.classes)
    return sorted(diags, key=sort_key)


def analyze_spec(spec: LoopNestSpec,
                 cfg: SamplerConfig = DEFAULT
                 ) -> tuple[list[Diagnostic], "footprint.Footprint"]:
    """The schedule-AWARE analysis (``cli analyze``): the lint passes
    with the race stream placement-refined under ``cfg``'s chunk schedule
    (PL304/PL305 — :mod:`pluss_torch.analysis.schedule`), plus line-granular
    false-sharing detection (PL5xx — :mod:`pluss_torch.analysis.falseshare`)
    and the footprint/MRC-bound report (:mod:`pluss_torch.analysis.footprint`).

    Returns ``(diagnostics, footprint)``.  The schedule-blind PL301/PL302
    findings are REPLACED by their placement-refined versions (same codes
    when a pair provably crosses threads, PL304 INFO when the schedule
    serializes every pair); everything else from :func:`lint_spec` is
    kept as-is.
    """
    diags = contract.check(spec)
    bad = frozenset(d.nest for d in diags
                    if d.severity is Severity.ERROR and d.nest is not None)
    diags += bounds.check(spec, skip_nests=bad)
    ana = deps.analyze(spec, skip_nests=bad)
    blind = deps.check(spec, skip_nests=bad, analysis=ana)
    diags += [d for d in blind if d.code not in ("PL301", "PL302")]
    diags += schedule.check(spec, cfg, analysis=ana, skip_nests=bad)
    diags += sharespan.check(spec, ana.classes)
    diags += falseshare.check(spec, cfg, analysis=ana, skip_nests=bad)
    return sorted(diags, key=sort_key), footprint.footprints(
        spec, cfg, skip_nests=bad)


__all__ = [
    "CODES", "Diagnostic", "Severity", "lint_spec", "analyze_spec",
    "error_count", "format_text", "format_json", "with_model",
    "bounds", "contract", "deps", "falseshare", "footprint", "schedule",
    "sharespan",
]
