"""Lower a frontend :class:`~pluss_torch.frontend.ir.Program` to a
verified :class:`~pluss_torch.spec.LoopNestSpec` — the one normalizer
behind both the Python DSL and the pragma-C parser (the port's copy of
``pluss/frontend/lower.py``).

What lowering does:

- **bounds**: value-space ``range(lo, hi, step)`` loops become the
  spec's ``(trip, start, step, bound_coef, start_coef, bound_level)``
  form.  A bound affine in the PARALLEL value is rebased from values to
  parallel-INDEX space (``v0 = p_start + p_step*k``), so descending
  parallel loops (ludcmp's back substitution) lower exactly; a bound
  referencing an INNER loop requires that loop to have a unit basis
  (start 0, step 1 — the quad contract's own restriction) and lowers to
  ``bound_level=m``.  Anything else — a bound over two variables, a
  varying bound under a non-unit step — is PL607, raised HERE with a
  source location, not at plan time.
- **subscripts**: row-major-folded affine index forms become
  ``addr_terms``/``addr_base``, term order and explicit zero
  coefficients preserved (so :func:`pluss_torch.frontend.emit.emit_dsl`
  round-trips hand-written specs exactly).
- **ref names**: explicit names win; unnamed refs get the registry's
  generated-sampler convention (``C0, C1, …`` per array, in emission
  order per nest), skipping any explicitly taken name.
- **share spans** (``auto_span``): refs the lint's race detector classifies
  as able to OBSERVE a parallel-carried reuse (`cross_observed` — the
  PL203 criterion) get the recomputed carrying-loop formula
  (:func:`pluss_torch.analysis.sharespan.recomputed_span`) attached,
  which is exactly how the reference's generator chose its thresholds — the
  frontend-derived gemm reproduces the registry's 16513 on ``B0`` and
  nothing else.  Explicit spans always win; ``auto_span=False`` turns
  derivation off (the emit/round-trip path).

:func:`verify_spec` is the ADMISSION GATE every frontend artifact passes
before anyone runs it: the lint (plus, given a config, the
schedule-aware analysis); ERROR diagnostics raise
:class:`~pluss_torch.frontend.ir.FrontendRejected` with the findings
attached.
"""

from __future__ import annotations

import dataclasses

from pluss_torch.frontend.ir import FLoop, FRef, Program, err
from pluss_torch.spec import Loop, LoopNestSpec, Ref


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _const_trip(var: str, lo: int, hi: int, step: int,
                where: str) -> int:
    """``len(range(lo, hi, step))``, rejecting empty loops."""
    span = hi - lo if step > 0 else lo - hi
    trip = _ceil_div(span, abs(step)) if span > 0 else 0
    if trip < 1:
        raise err("PL607", f"loop {var!r} never executes "
                           f"(range({lo}, {hi}, {step})){where}")
    return trip


@dataclasses.dataclass
class _Level:
    var: str
    start: int
    step: int
    start_coef: int
    trip: int
    unit_basis: bool    # start == 0, step == 1, start_coef == 0


def _lower_loop(fl: FLoop, chain: list[_Level]) -> dict:
    """Spec-field dict for one loop given the lowered enclosing chain."""
    where = f" (loop {fl.var!r})"
    raw = getattr(fl, "raw", None)
    if raw is not None:
        return dict(raw)
    step = fl.step
    if not chain:
        # the parallel level: bounds must be constants (the spec's
        # parallel loop is rectangular; the analyzer re-checks as PL401)
        if fl.lo.vars() or fl.hi.vars():
            raise err("PL607", "the parallel (outermost) loop must have "
                               f"constant bounds{where}")
        lo, hi = fl.lo.const, fl.hi.const
        return dict(trip=_const_trip(fl.var, lo, hi, step, ""),
                    start=lo, step=step, bound_coef=None, start_coef=0,
                    bound_level=0)
    p = chain[0]
    # -- lower bound: affine in the parallel VALUE only ---------------------
    lo_vars = fl.lo.vars()
    if any(v != p.var for v in lo_vars):
        raise err("PL607", "a loop's lower bound may reference only the "
                           f"parallel loop variable {p.var!r}; got "
                           f"{fl.lo}{where}")
    lc = fl.lo.coef(p.var)
    start = fl.lo.const + lc * p.start
    start_coef = lc * p.step
    # -- trip: hi - lo, constant or affine in ONE enclosing value -----------
    t = fl.hi - fl.lo
    if t.is_const():
        if fl.trip_max is not None:
            raise err("PL608", "trip_max is the declared maximum of a "
                               "VARYING-bound loop; this loop's trip is "
                               f"constant{where}")
        return dict(trip=_const_trip(fl.var, 0, t.const, step, where),
                    start=start, step=step, bound_coef=None,
                    start_coef=start_coef, bound_level=0)
    if abs(step) != 1:
        raise err("PL602", f"a varying-bound loop must have unit step, "
                           f"got step {step}{where}")
    if step < 0:
        raise err("PL602", "a varying-bound loop must ascend (the trip "
                           f"count form is `hi - lo`){where}")
    tvars = t.vars()
    if len(tvars) != 1:
        raise err("PL607", "a loop's trip count may vary with at most "
                           f"ONE enclosing loop; got {t}{where}")
    v = tvars[0]
    m = next(i for i, l in enumerate(chain) if l.var == v)
    a_v, b_v = t.const, t.coef(v)
    if m == 0:
        a = a_v + b_v * p.start        # rebase value -> parallel index
        b = b_v * p.step
    else:
        if not chain[m].unit_basis:
            raise err("PL607",
                      f"the bound-referenced loop {v!r} must have start "
                      "0 and step 1 (index == value) — the quad "
                      f"contract's own restriction{where}")
        a, b = a_v, b_v
    ref_trip = chain[m].trip
    static_max = max(a, a + b * (ref_trip - 1))
    trip = fl.trip_max if fl.trip_max is not None else max(static_max, 1)
    return dict(trip=trip, start=start, step=step, bound_coef=(a, b),
                start_coef=start_coef, bound_level=m)


def _lower_nest(fl: FLoop, program: Program) -> Loop:
    names_taken = set()
    counters: dict[str, int] = {}

    def collect_names(item) -> None:
        if isinstance(item, FRef) and item.name:
            names_taken.add(item.name)
        elif isinstance(item, FLoop):
            for b in item.body:
                collect_names(b)

    collect_names(fl)

    def auto_name(array: str) -> str:
        while True:
            n = counters.get(array, 0)
            counters[array] = n + 1
            cand = f"{array}{n}"
            if cand not in names_taken:
                return cand

    def lower_ref(fr: FRef, chain: list[_Level]) -> Ref:
        var_level = {l.var: i for i, l in enumerate(chain)}
        terms = tuple((var_level[v], c) for v, c in fr.index.terms.items())
        _, arr_dtb = program.arrays[fr.array]
        return Ref(
            name=fr.name or auto_name(fr.array),
            array=fr.array,
            addr_terms=terms,
            addr_base=fr.index.const,
            share_span=fr.share_span,
            is_write=fr.is_write,
            dtype_bytes=fr.dtype_bytes if fr.dtype_bytes is not None
            else arr_dtb,
        )

    def walk(item, chain: list[_Level]):
        if isinstance(item, FRef):
            return lower_ref(item, chain)
        f = _lower_loop(item, chain)
        lvl = _Level(var=item.var, start=f["start"], step=f["step"],
                     start_coef=f["start_coef"], trip=f["trip"],
                     unit_basis=(f["start"] == 0 and f["step"] == 1
                                 and f["start_coef"] == 0))
        body = tuple(walk(b, chain + [lvl]) for b in item.body)
        if not body:
            raise err("PL608", f"loop {item.var!r} has an empty body")
        return Loop(trip=f["trip"], body=body, start=f["start"],
                    step=f["step"], bound_coef=f["bound_coef"],
                    start_coef=f["start_coef"],
                    bound_level=f["bound_level"])

    return walk(fl, [])


def lower(program: Program) -> LoopNestSpec:
    """Normalize one recorded program into a LoopNestSpec (no analyzer
    gate — see :func:`verify_spec`)."""
    if not program.nests:
        raise err("PL608", f"program {program.name!r} has no loop nest")
    arrays = tuple(
        (name, _prod(shape))
        for name, (shape, _) in program.arrays.items()
    )
    if not arrays:
        raise err("PL606", f"program {program.name!r} declares no arrays")
    spec = LoopNestSpec(
        name=program.name,
        arrays=arrays,
        nests=tuple(_lower_nest(n, program) for n in program.nests),
    )
    if program.auto_span:
        spec = derive_spans(spec)
    return spec


def _prod(shape: tuple[int, ...]) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def derive_spans(spec: LoopNestSpec) -> LoopNestSpec:
    """Attach the generated-sampler share thresholds: every ref the race
    detector marks ``cross_observed`` (and that carries no explicit span)
    gets the recomputed carrying-loop formula — the criterion is exactly
    PL203's, so a derived spec never lints PL203.  Contract-broken nests
    are left untouched (the analyzer gate will reject them with their own
    findings)."""
    from pluss_torch.analysis import Severity, contract, deps, sharespan

    bad = frozenset(
        d.nest for d in contract.check(spec)
        if d.severity is Severity.ERROR and d.nest is not None)
    try:
        ana = deps.analyze(spec, skip_nests=bad)
    except Exception:   # a shape the profiler cannot hold: no spans —
        return spec     # the analyzer gate reports the real failure
    spans: dict[str, int] = {}
    for path, rc in ana.classes.items():
        if rc.cross_observed and rc.site.ref.share_span is None:
            want = sharespan.recomputed_span(rc.site)
            if want > 1:
                spans[path] = want
    if not spans:
        return spec

    def walk(item, path: str):
        if isinstance(item, Ref):
            if path in spans:
                return dataclasses.replace(item, share_span=spans[path])
            return item
        return dataclasses.replace(item, body=tuple(
            walk(b, f"{path}.body[{i}]")
            for i, b in enumerate(item.body)))

    return dataclasses.replace(spec, nests=tuple(
        walk(n, f"nests[{i}]") for i, n in enumerate(spec.nests)))


def verify_spec(spec: LoopNestSpec, cfg=None):
    """The frontend ADMISSION GATE: the lint (always) plus the
    schedule-aware analysis (when ``cfg`` is given).  Returns ALL
    diagnostics;
    ERROR findings raise :class:`FrontendRejected` with the findings
    attached."""
    from pluss_torch import analysis
    from pluss_torch.frontend.ir import FrontendRejected

    if cfg is None:
        diags = analysis.lint_spec(spec)
    else:
        diags, _ = analysis.analyze_spec(spec, cfg)
    diags = analysis.with_model(diags, spec.name)
    errs = [d for d in diags if d.severity is analysis.Severity.ERROR]
    if errs:
        raise FrontendRejected(
            f"spec {spec.name!r} rejected by the static analyzer "
            f"({len(errs)} ERROR diagnostic(s): "
            f"{', '.join(sorted({d.code for d in errs}))})",
            diagnostics=tuple(errs))
    return diags
