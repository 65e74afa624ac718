"""Bounds proofs: exact address ranges vs declared array sizes.

The port's copy of ``pluss/analysis/bounds.py``.

Every reference's element address is affine in the iteration indices
(:class:`pluss_torch.analysis.walk.AddrForm`), so its exact min/max over the
iteration domain is computable without enumeration of the access stream:
interval arithmetic over a box is exact for affine forms, the parallel
axis is enumerated (triangular nests make per-``k`` inner domains vary),
and quad levels fold their one referenced index (the
``flatten_nest_quad`` closed-form contract guarantees there is only one).
The proof obligation is::

    0 <= min(addr)  and  max(addr) < declared array size

declared sizes being ``LoopNestSpec.arrays``.  A violation is PL101 —
always an ERROR: the engine would happily enumerate the out-of-range
addresses into neighboring arrays' cache-line ranges and corrupt the
reuse accounting silently.
"""

from __future__ import annotations

from pluss_torch.analysis.diagnostics import Diagnostic, Severity
from pluss_torch.analysis.walk import addr_form, addr_range, ref_sites
from pluss_torch.spec import LoopNestSpec, SpecContractError


def check(spec: LoopNestSpec,
          skip_nests: frozenset[int] = frozenset()) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    sizes: dict[str, int] = {}
    for ai, (name, n) in enumerate(spec.arrays):
        if name in sizes:
            diags.append(Diagnostic(
                code="PL104", severity=Severity.ERROR,
                message=f"array '{name}' declared twice (arrays[{ai}]); "
                        "line-id bases would silently use the first",
                path=f"arrays[{ai}]", array=name,
            ))
            continue
        sizes[name] = n
        if n <= 0:
            diags.append(Diagnostic(
                code="PL105", severity=Severity.ERROR,
                message=f"array '{name}' declared with size {n}",
                path=f"arrays[{ai}]", array=name,
            ))
    used: set[str] = set()
    for site in ref_sites(spec):
        used.add(site.ref.array)
        if site.nest in skip_nests:
            continue
        if site.ref.array not in sizes:
            diags.append(Diagnostic(
                code="PL102", severity=Severity.ERROR,
                message=f"ref {site.ref.name} targets undeclared array "
                        f"'{site.ref.array}'",
                path=site.path, nest=site.nest, ref=site.ref.name,
                array=site.ref.array,
            ))
            continue
        if sizes[site.ref.array] <= 0:
            continue  # PL105 already reported; a range proof is moot
        try:
            rng = addr_range(addr_form(site))
        except SpecContractError:
            continue  # the contract pass owns malformed addr terms
        if rng is None:
            continue  # the reference never executes (empty domain)
        lo, hi = rng
        size = sizes[site.ref.array]
        if lo < 0 or hi >= size:
            diags.append(Diagnostic(
                code="PL101", severity=Severity.ERROR,
                message=f"ref {site.ref.name}: address range [{lo}, {hi}] "
                        f"escapes array '{site.ref.array}' of size {size}",
                path=site.path, nest=site.nest, ref=site.ref.name,
                array=site.ref.array,
            ))
    for name in sizes:
        if name not in used:
            diags.append(Diagnostic(
                code="PL103", severity=Severity.WARNING,
                message=f"array '{name}' is declared but never referenced "
                        "(a dead declaration — it only widens the global "
                        "line-id space)",
                array=name,
            ))
    return diags
