"""Contract lint: the flatten-time ValueErrors as addressed diagnostics.

The port's copy of ``pluss/analysis/contract.py``.

``spec.flatten_nest`` / ``flatten_nest_quad`` enforce the declarative
contract with scattered raises; each now carries a stable code
(:class:`pluss_torch.spec.SpecContractError`).  This pass walks the tree FIRST,
re-performing the cheap structural checks with precise paths, then runs
the real flatten as the authority — anything the walk missed (deep quad
algebra, degree-3 shapes) surfaces through the exception's code, with the
nest as the address.  Duplicate findings (same code, same nest) are
folded so a violation reports once, at the best path available.
"""

from __future__ import annotations

from pluss_torch.analysis.diagnostics import Diagnostic, Severity
from pluss_torch.analysis.walk import loop_sites, ref_sites
from pluss_torch.spec import LoopNestSpec, SpecContractError, flatten_nest


def check(spec: LoopNestSpec) -> list[Diagnostic]:
    diags: list[Diagnostic] = []

    def add(code: str, message: str, path: str, ni: int, **kw) -> None:
        diags.append(Diagnostic(code=code, severity=Severity.ERROR,
                                message=message, path=path, nest=ni, **kw))

    for ni, nest in enumerate(spec.nests):
        if nest.bound_coef is not None or nest.start_coef:
            add("PL401",
                "the parallel (outermost) loop must be rectangular; "
                "bound_coef/start_coef are for inner loops",
                f"nests[{ni}]", ni)

    for loop, chain, ni, path in loop_sites(spec):
        level = len(chain)
        if level == 0 or loop.bound_coef is None:
            continue
        if not 0 <= loop.bound_level < level:
            add("PL404",
                f"bound_level {loop.bound_level} must name an enclosing "
                f"loop (this loop sits at depth {level})", path, ni)
            continue
        a, b = loop.bound_coef
        ref_trip = spec.nests[ni].trip if loop.bound_level == 0 \
            else chain[loop.bound_level].trip
        ends = (a, a + b * (ref_trip - 1))
        if min(ends) < 0 or max(ends) > loop.trip:
            add("PL402",
                f"bound {loop.bound_coef} leaves [0, trip={loop.trip}] "
                f"over referenced indices [0, {ref_trip - 1}]", path, ni)
        if loop.bound_level > 0:
            ref = chain[loop.bound_level]
            if ref.start or ref.step != 1 or ref.start_coef:
                add("PL405",
                    "the bound-referenced level must have start=0, "
                    "step=1, start_coef=0 (index == value)", path, ni)

    seen_names: dict[tuple[int, str], str] = {}
    for site in ref_sites(spec):
        d = len(site.chain)
        for depth, _coef in site.ref.addr_terms:
            if not 0 <= depth < d:
                add("PL403",
                    f"ref {site.ref.name}: addr term depth {depth} "
                    f"exceeds loop chain depth {d}", site.path, site.nest,
                    ref=site.ref.name, array=site.ref.array)
                break
        key = (site.nest, site.ref.name)
        if key in seen_names:
            diags.append(Diagnostic(
                code="PL406", severity=Severity.WARNING,
                message=f"ref name '{site.ref.name}' appears twice in "
                        f"nest {site.nest} (also at {seen_names[key]}) — "
                        "diagnostics and per-ref tooling key on the name",
                path=site.path, nest=site.nest, ref=site.ref.name,
            ))
        seen_names.setdefault(key, site.path)

    # the flatten itself is the authority: whatever the walk above missed
    # (quad position algebra, degree-3 shapes) lands here with its code
    found = {(d.code, d.nest) for d in diags}
    for ni, nest in enumerate(spec.nests):
        try:
            flatten_nest(nest)
        except SpecContractError as e:
            if (e.code, ni) not in found:
                add(e.code, str(e), f"nests[{ni}]", ni)
        except ValueError as e:
            if ("PL407", ni) not in found:
                add("PL407", f"flatten rejected the nest: {e}",
                    f"nests[{ni}]", ni)
    return diags
