"""``emit_dsl`` (the port's copy of ``pluss/frontend/emit.py``): print any
LoopNestSpec back as frontend-DSL source.

The inverse of the authoring path, and the grammar-coverage pin: every
registry family re-emitted, re-executed through the DSL, and re-lowered
must compare codec-equal to the hand-written spec.  That forces the
emitter to reconstruct VALUE-space bounds from the spec's index-space
fields — ``start + start_coef*k`` becomes an expression over the
parallel loop's value, ``bound_coef``/``bound_level`` become a symbolic
upper bound — and forces the lowering to preserve ``addr_terms`` order,
explicit zero coefficients, and declared trip maxima (``trip_max=``)
bit-for-bit.

The text is byte for byte the JAX package's, header included: it begins
``from pluss import frontend``, and :func:`pluss_torch.frontend.from_py`
resolves that import to this package's frontend, so a DSL file written
by either package imports in both.

Loops the value-space sugar cannot express (a ``start_coef`` not
divisible by the parallel step — no registry family needs this) fall
back to ``frontend.loop_raw(...)``, which mirrors ``spec.Loop``
field-for-field, so emission is total over the spec language.
"""

from __future__ import annotations

from pluss_torch.spec import Loop, LoopNestSpec, Ref

#: emitted loop-variable names, ppcg-style
def _var(level: int) -> str:
    return f"c{level}"


def _expr(terms: list[tuple[str, int]], const: int) -> str:
    """Affine expression text: ``2*c0 + c1 - 3`` (explicit ``0*v`` terms
    kept — the lowering preserves them into addr_terms)."""
    bits: list[str] = []
    for v, c in terms:
        if not bits:
            bits.append(v if c == 1 else f"{c}*{v}")
        elif c >= 0:
            bits.append(f"+ {v}" if c == 1 else f"+ {c}*{v}")
        else:
            bits.append(f"- {v}" if c == -1 else f"- {-c}*{v}")
    if const or not bits:
        if not bits:
            bits.append(str(const))
        elif const >= 0:
            bits.append(f"+ {const}")
        else:
            bits.append(f"- {-const}")
    return " ".join(bits)


def _k_terms(chain: list[Loop]) -> tuple[list[tuple[str, int]], int] | None:
    """The parallel INDEX ``k`` as value-space terms: ``k = (v0 -
    p_start)/p_step`` — expressible iff ``|p_step| == 1``."""
    p = chain[0]
    if p.step == 1:
        return [(_var(0), 1)], -p.start
    if p.step == -1:
        return [(_var(0), -1)], p.start
    return None


def _scale(kt, factor: int):
    terms, const = kt
    return [(v, c * factor) for v, c in terms], const * factor


def _loop_line(loop: Loop, level: int, chain: list[Loop]) -> str:
    """One ``with frontend.loop(...) as cN:`` header (sugar), or the
    ``loop_raw`` fallback."""
    var = _var(level)
    if level == 0:
        lo, hi = loop.start, loop.start + loop.step * loop.trip
        args = [repr(var), str(lo), str(hi)]
        if loop.step != 1:
            args.append(f"step={loop.step}")
        args.append("parallel=True")
        return f"frontend.loop({', '.join(args)})"

    raw = (f"frontend.loop_raw({var!r}, {loop.trip}, start={loop.start}, "
           f"step={loop.step}, bound_coef={loop.bound_coef}, "
           f"start_coef={loop.start_coef}, "
           f"bound_level={loop.bound_level})")
    kt = _k_terms(chain)
    # lo = start + start_coef*k, in value space
    lo_terms: list[tuple[str, int]] = []
    lo_const = loop.start
    if loop.start_coef:
        if kt is None or loop.start_coef % chain[0].step != 0:
            return raw
        t, c = _scale(kt, loop.start_coef)
        lo_terms += t
        lo_const += c
    if loop.bound_coef is None:
        hi_terms = list(lo_terms)
        hi_const = lo_const + loop.step * loop.trip
    else:
        if loop.step != 1:
            return raw
        a, b = loop.bound_coef
        if loop.bound_level == 0:
            if kt is None:
                return raw
            t, c = _scale(kt, b)
            bt, bc = t, a + c
        else:
            ref = chain[loop.bound_level]
            if ref.start or ref.step != 1 or ref.start_coef:
                return raw
            bt, bc = [(_var(loop.bound_level), b)], a
        hi_terms = list(lo_terms)
        hi_const = lo_const + bc
        for v, c in bt:
            hi_terms.append((v, c))
    args = [repr(var), _expr(lo_terms, lo_const),
            _expr(_merge(hi_terms), hi_const)]
    if loop.step != 1:
        args.append(f"step={loop.step}")
    if loop.bound_coef is not None:
        ref_trip = chain[loop.bound_level].trip
        a, b = loop.bound_coef
        computed = max(max(a, a + b * (ref_trip - 1)), 1)
        if loop.trip != computed:
            args.append(f"trip_max={loop.trip}")
    return f"frontend.loop({', '.join(args)})"


def _merge(terms: list[tuple[str, int]]) -> list[tuple[str, int]]:
    out: dict[str, int] = {}
    for v, c in terms:
        out[v] = out.get(v, 0) + c
    return list(out.items())


def emit_dsl(spec: LoopNestSpec) -> str:
    """DSL source text reconstructing ``spec`` exactly (codec-equal) when
    executed through ``cli import`` / :func:`pluss_torch.frontend.from_py`."""
    lines = [
        # the JAX package's header, byte for byte (see the module docstring)
        f"# emitted by pluss.frontend.emit_dsl from spec {spec.name!r}",
        "from pluss import frontend",
        "",
        f"with frontend.kernel({spec.name!r}, auto_span=False):",
    ]
    handles: dict[str, str] = {}
    for i, (arr, n) in enumerate(spec.arrays):
        h = f"A{i}_{arr}"
        handles[arr] = h
        lines.append(f"    {h} = frontend.array({arr!r}, {n})")

    def emit_ref(ref: Ref, indent: str) -> None:
        sub = _expr([(_var(d), c) for d, c in ref.addr_terms],
                    ref.addr_base)
        fn = "write" if ref.is_write else "read"
        args = [handles[ref.array], sub, f"name={ref.name!r}"]
        if ref.share_span is not None:
            args.append(f"share_span={ref.share_span}")
        if ref.dtype_bytes is not None:
            args.append(f"dtype_bytes={ref.dtype_bytes}")
        lines.append(f"{indent}frontend.{fn}({', '.join(args)})")

    def emit_loop(loop: Loop, level: int, chain: list[Loop],
                  indent: str) -> None:
        head = _loop_line(loop, level, chain)
        lines.append(f"{indent}with {head} as {_var(level)}:")
        inner = indent + "    "
        for item in loop.body:
            if isinstance(item, Ref):
                emit_ref(item, inner)
            else:
                emit_loop(item, level + 1, chain + [loop], inner)

    for nest in spec.nests:
        emit_loop(nest, 0, [], "    ")
    lines.append("")
    return "\n".join(lines)
