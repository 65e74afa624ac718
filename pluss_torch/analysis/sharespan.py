"""Share-span validation: recompute the carrying-loop formula, flag copies.

The port's copy of ``pluss/analysis/sharespan.py``.

A ``Ref.share_span`` is the generated threshold the reference's state
machine compares reuses against (``2*reuse > span`` ⇒ cross-thread
"share"; see ``pluss_torch.spec`` module docstring).  The generated form is
``share_span_formula(trip, start, step)`` of the CARRYING loop — in the
reference's GEMM sampler, the loop just below the parallel dimension on
the ref's chain (``gemm_sampler.rs:196-199``: the c1 loop's
``(trip+1)*trip+1`` = 16513).  Model authors copy that formula by hand;
this pass recomputes it from the chain and flags drift:

- PL201 (ERROR): the span is no threshold at all (``<= 1`` classifies
  every reuse as cross-thread, including distance-1 self reuse).
- PL202 (WARNING): the span differs from the recomputed carrying-loop
  value — the hand-copied-constant hazard.  Warning, not error: several
  seeded families deliberately use the problem-size formula where the
  carrying loop's trip is ``n-1`` (durbin, cholesky's j<i chain …), which
  shifts the threshold by a few percent without flipping any realistic
  classification.  The lint makes the drift visible; flipping thresholds
  is a model decision.
- PL203/PL204 (INFO): span annotations inconsistent with the race
  detector's cross-thread classification (missing where a cross-thread
  reuse is observable, inert where none is).
"""

from __future__ import annotations

from pluss_torch.analysis.diagnostics import Diagnostic, Severity
from pluss_torch.spec import LoopNestSpec, share_span_formula


def recomputed_span(site) -> int:
    """The carrying-loop formula for a ref site: the loop just below the
    parallel dimension on the ref's chain (the generated convention), or
    the parallel loop itself for depth-1 refs."""
    loop = site.chain[1] if len(site.chain) > 1 else site.chain[0]
    return share_span_formula(loop.trip, loop.start, loop.step)


def check(spec: LoopNestSpec, classes: dict) -> list[Diagnostic]:
    """``classes``: :func:`pluss_torch.analysis.deps.classify` output (keyed by
    tree path, so name collisions can never shadow a finding) — the share
    validation rides the race detector's classification."""
    diags: list[Diagnostic] = []
    for path, rc in sorted(classes.items()):
        site = rc.site
        name = site.ref.name
        span = site.ref.share_span
        common = dict(path=path, nest=site.nest, ref=name,
                      array=site.ref.array)
        if span is None:
            if rc.cross_observed:
                diags.append(Diagnostic(
                    code="PL203", severity=Severity.INFO,
                    message=f"ref {name} can observe a reuse carried by "
                            "the parallel loop but has no share_span — "
                            "such reuses will always classify as private",
                    **common,
                ))
            continue
        if span <= 1:
            diags.append(Diagnostic(
                code="PL201", severity=Severity.ERROR,
                message=f"share_span={span} is not a meaningful threshold "
                        "(every reuse, including distance-1 self reuse, "
                        "would classify as cross-thread)",
                **common,
            ))
            continue
        want = recomputed_span(site)
        # a degenerate recomputation (<= 1: varying-start loops make the
        # static formula meaningless) must not be "suggested" — PL201
        # would reject the suggested value
        if span != want and want > 1:
            diags.append(Diagnostic(
                code="PL202", severity=Severity.WARNING,
                message=f"share_span={span} differs from the recomputed "
                        f"carrying-loop formula {want} "
                        "(hand-copied constant?)",
                **common,
            ))
        if not rc.cross_observed:
            diags.append(Diagnostic(
                code="PL204", severity=Severity.INFO,
                message=f"ref {name} carries share_span={span} but the "
                        "race detector refutes any parallel-carried "
                        "reuse at it — the span can never trigger",
                **common,
            ))
    return diags
