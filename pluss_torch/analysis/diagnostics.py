"""Structured diagnostics for the LoopNestSpec static analyzer.

The port's copy of ``pluss/analysis/diagnostics.py``.

Every finding of :mod:`pluss_torch.analysis` is a :class:`Diagnostic` with a
STABLE code — the code, not the message text, is the machine-readable
contract (tests and tooling key on it; wording may improve freely).

Code families mirror the analyzer's four passes:

- ``PL1xx`` bounds   (:mod:`pluss_torch.analysis.bounds`): address-range proofs
  against the declared array sizes.
- ``PL2xx`` share    (:mod:`pluss_torch.analysis.sharespan`): ``share_span``
  consistency against the recomputed carrying-loop formula and the race
  detector's cross-thread classification.
- ``PL3xx`` race     (:mod:`pluss_torch.analysis.deps`): affine dependence tests
  (GCD + Banerjee-style bounds) on the parallel dimension.
- ``PL4xx`` contract (:mod:`pluss_torch.analysis.contract`): the structural
  restrictions ``spec.flatten_nest`` / ``flatten_nest_quad`` enforce,
  surfaced as records with tree paths instead of bare ``ValueError``.
- ``PL30x`` (304/305) schedule (:mod:`pluss_torch.analysis.schedule`):
  placement-refined race/reuse verdicts under a concrete chunk schedule
  (emitted by ``cli analyze``, never by the schedule-blind ``lint``).
- ``PL5xx`` falseshare (:mod:`pluss_torch.analysis.falseshare`): line-granular
  cross-thread false-sharing detection (also ``analyze``-only — it needs
  the machine model's element and line widths).
- ``PL6xx`` frontend (:mod:`pluss_torch.frontend`): authoring-time rejections
  from the loop-nest DSL and the pragma-C parser (non-affine constructs,
  out-of-grammar steps, missing pragmas, malformed source) — emitted
  BEFORE a spec exists, so they carry source locations instead of tree
  paths.  PL609 wraps an analyzer rejection of a frontend-derived spec.
- ``PL7xx`` prediction (:mod:`pluss_torch.analysis.ri`): the sampling-free
  symbolic reuse-interval predictor — typed "not statically derivable"
  refusals (PL701), enumeration-budget refusals (PL702), derivation-method
  notes (PL703), and the prover soundness alarm (PL704: exact plateau
  outside the heuristic MrcBracket — a bug in exactly one of the two).
- ``PL8xx`` interference (:mod:`pluss_torch.analysis.interference`): the
  cross-nest co-tenancy composition — severe predicted interference at
  the declared cache size (PL801), proven-bounded benign co-tenancy
  (PL802), and the typed refusal when a workload pair lies outside the
  composition model's contract (PL803 — never a silent approximation).
- ``PL9xx`` tuning (:mod:`pluss_torch.analysis.tune`): the proof-carrying
  schedule auto-optimizer — proven-best schedule with margin (PL901),
  tie-within-epsilon set (PL902), typed refusal when a candidate falls
  off the derivability ladder (PL903 — the PL701/702 cause chain
  attaches), and the ``--check`` cross-validation alarm when a live
  engine run disagrees with the predicted winner (PL904).
- ``PL95x`` transform (:mod:`pluss_torch.analysis.transform`): the
  loop-transformation legality prover — proven-legal transform with the
  witness dependence vectors (PL951), proven-illegal with the concrete
  violating pair (PL952), typed refusal when the nest is outside the
  dependence-vector contract (PL953 — the PL601/PL701 cause chain
  attaches, never a silent guess), and the transform ``--check``
  cross-validation alarm when a live engine run of the transformed spec
  disagrees with its static MRC prediction (PL954).

Severity semantics: ERROR means the spec is wrong (out-of-bounds access,
undeclared array, contract violation) — ``cli lint`` exits nonzero.
WARNING flags suspicious-but-runnable facts (hand-copied span mismatch,
cross-thread conflicts the ``#pragma pluss parallel`` contract merely
asserts away).  INFO records classifications (carried levels) for tooling.
"""

from __future__ import annotations

import dataclasses
import enum
import json


class Severity(enum.IntEnum):
    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self) -> str:  # "error", not "Severity.ERROR", in reports
        return self.name.lower()


#: code -> (pass family, one-line meaning).  The single source of truth for
#: the README's diagnostic-code table (tests assert the two agree).
CODES: dict[str, tuple[str, str]] = {
    "PL101": ("bounds", "reference address range escapes its array"),
    "PL102": ("bounds", "reference targets an undeclared array"),
    "PL103": ("bounds", "declared array is never referenced"),
    "PL104": ("bounds", "duplicate array declaration"),
    "PL105": ("bounds", "array declared with a non-positive size"),
    "PL201": ("share", "share_span is not a meaningful threshold"),
    "PL202": ("share", "share_span differs from the recomputed "
                       "carrying-loop formula"),
    "PL203": ("share", "reference can observe cross-thread reuse but "
                       "carries no share_span"),
    "PL204": ("share", "share_span on a reference with no cross-thread "
                       "reuse"),
    "PL301": ("race", "cross-thread write-write conflict on the parallel "
                      "dimension"),
    "PL302": ("race", "cross-thread read-write conflict on the parallel "
                      "dimension"),
    "PL303": ("race", "reuse carried-level classification"),
    "PL304": ("race", "conflict is provably thread-private under the "
                      "analyzed chunk schedule (placement-refined)"),
    "PL305": ("race", "schedule-refined reuse classification"),
    "PL501": ("falseshare", "cross-thread write-write false sharing on a "
                            "cache line (same line, different elements)"),
    "PL502": ("falseshare", "cross-thread read-write false sharing on a "
                            "cache line (same line, different elements)"),
    "PL503": ("falseshare", "write references proven free of false "
                            "sharing under the analyzed schedule"),
    "PL401": ("contract", "the parallel (outermost) loop must be "
                          "rectangular"),
    "PL402": ("contract", "inner bound leaves the declared [0, trip] "
                          "range"),
    "PL403": ("contract", "addr term depth exceeds the loop chain depth"),
    "PL404": ("contract", "bound_level must name an enclosing loop"),
    "PL405": ("contract", "outside the quadratic position contract"),
    "PL406": ("contract", "duplicate reference name inside one nest"),
    "PL407": ("contract", "spec rejected by flatten"),
    "PL601": ("frontend", "non-affine expression (subscript, bound, or "
                          "operator outside the affine grammar)"),
    "PL602": ("frontend", "loop step outside the frontend grammar"),
    "PL603": ("frontend", "parallel marker missing on a top-level loop "
                          "nest (or placed on an inner loop)"),
    "PL604": ("frontend", "loop variable shadows an enclosing loop "
                          "variable"),
    "PL605": ("frontend", "malformed source (tokenizer/parser rejection)"),
    "PL606": ("frontend", "reference to an undeclared array or wrong "
                          "subscript arity"),
    "PL607": ("frontend", "loop bound/start outside the lowerable affine "
                          "contract"),
    "PL608": ("frontend", "authoring-API misuse (ref outside a loop, "
                          "duplicate array, out-of-scope index)"),
    "PL609": ("frontend", "frontend-derived spec rejected by the static "
                          "analyzer"),
    "PL701": ("prediction", "reuse distribution not statically derivable "
                            "(spec outside the position contract or the "
                            "address model is invalid)"),
    "PL702": ("prediction", "exact derivation exceeds the enumeration "
                            "budget and no closed form applies "
                            "(PLUSS_PREDICT_BUDGET)"),
    "PL703": ("prediction", "derivation method note: closed-form periodic "
                            "or dense polynomial counting"),
    "PL704": ("prediction", "exact MRC plateau lies outside the static "
                            "footprint bracket — prover soundness "
                            "violation"),
    "PL801": ("interference", "severe co-tenancy interference: predicted "
                              "miss-ratio inflation above threshold at "
                              "the declared cache size"),
    "PL802": ("interference", "benign co-tenancy: miss-ratio inflation "
                              "proven below threshold at the declared "
                              "cache size"),
    "PL803": ("interference", "co-tenancy pair outside the composition "
                              "model's contract (typed refusal, never a "
                              "silent approximation)"),
    "PL901": ("tuning", "proven-best schedule: every competitor scored "
                        "worse beyond the tie epsilon or was dominance-"
                        "pruned (margin attached)"),
    "PL902": ("tuning", "schedule tie within epsilon: the canonical pick "
                        "plus the full tie set"),
    "PL903": ("tuning", "tune refused: a candidate schedule fell off the "
                        "derivability ladder (PL701/702 cause chain "
                        "attached, never a silent approximation)"),
    "PL904": ("tuning", "tuned-winner cross-check alarm: live engine run "
                        "disagrees with the predicted MRC beyond the "
                        "epsilon"),
    "PL951": ("transform", "transform proven legal: every dependence "
                           "vector stays lexicographically nonnegative "
                           "(witness vectors attached)"),
    "PL952": ("transform", "transform proven illegal: a dependence "
                           "vector would be reversed (concrete violating "
                           "pair attached)"),
    "PL953": ("transform", "transform refused: nest outside the "
                           "dependence-vector contract (PL601/PL701 "
                           "cause chain attached, never a silent guess)"),
    "PL954": ("transform", "transformed-spec cross-check alarm: live "
                           "engine run disagrees with the static MRC "
                           "prediction beyond the epsilon"),
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One analyzer finding, addressable into the Loop/Ref tree.

    ``path`` spells the tree position in attribute syntax
    (``nests[0].body[1].body[2]``); ``ref``/``array``/``nest`` carry the
    same identity as plain fields for JSON consumers.
    """

    code: str
    severity: Severity
    message: str
    path: str = ""
    nest: int | None = None
    ref: str | None = None
    array: str | None = None
    model: str | None = None

    def format(self) -> str:
        where = self.path or (f"nests[{self.nest}]" if self.nest is not None
                              else "")
        bits = [b for b in (
            f"{self.model}:" if self.model else None,
            where or None,
            f"[{self.code} {self.severity}]",
            self.message,
        ) if b]
        return " ".join(bits)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["severity"] = str(self.severity)
        return {k: v for k, v in d.items() if v is not None and v != ""}


def shown(names: list[str], limit: int = 4) -> str:
    """Truncated pair/name list for diagnostic messages: the first
    ``limit`` entries plus a '+N more' tail (one home for the idiom the
    race, schedule, and false-sharing passes all use)."""
    return ", ".join(names[:limit]) + (
        f" (+{len(names) - limit} more)" if len(names) > limit else "")


def error_count(diags: list[Diagnostic]) -> int:
    return sum(1 for d in diags if d.severity is Severity.ERROR)


def with_model(diags: list[Diagnostic], model: str) -> list[Diagnostic]:
    """Stamp a model name onto diagnostics (batch-lint labeling)."""
    return [dataclasses.replace(d, model=model) for d in diags]


def format_text(diags: list[Diagnostic], min_severity: Severity =
                Severity.WARNING) -> str:
    """Human report: one line per diagnostic at or above ``min_severity``
    (INFO-level classifications stay JSON-only by default)."""
    return "\n".join(d.format() for d in diags
                     if d.severity >= min_severity)


def format_json(diags: list[Diagnostic]) -> str:
    return json.dumps(
        {
            "diagnostics": [d.to_dict() for d in diags],
            "errors": error_count(diags),
            "warnings": sum(1 for d in diags
                            if d.severity is Severity.WARNING),
        },
        indent=1,
    )


def sort_key(d: Diagnostic):
    """Stable report order: errors first, then code, then tree position."""
    return (-int(d.severity), d.code, d.nest if d.nest is not None else -1,
            d.path)
