"""Loop-nest & reference specs (the port's copy of ``pluss/spec.py``).

A workload is a small declarative tree of :class:`Loop` and :class:`Ref`
nodes.  Every stream position and element address of every occurrence of
every static reference is a closed form in the iteration vector: affine for
rectangular nests, affine in the parallel index with per-level slopes for
bounded (triangular) and varying-start loops, and degree 2 under the
quadratic-position ("quad") contract (a loop bounded on an inner level, or
bounded loops nested inside each other).  That is what lets the engine
enumerate whole reference streams with broadcast arithmetic.

Semantics preserved from the reference:

- Program order of references inside a loop body = their order in
  ``Loop.body``.
- One logical clock per simulated thread, incremented once per access.
- A reuse observed at a ref with ``share_span`` is "share" (crosses threads)
  iff ``2*reuse > span`` (``gemm_sampler.rs:199``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Union

import numpy as np

from pluss_torch.config import DEFAULT, SamplerConfig


class SpecContractError(ValueError):
    """A Loop/Ref tree outside the engine's declarative contract.

    ``code`` is the stable diagnostic code (PL4xx) of the violation; callers
    that catch ``ValueError`` see no difference (this is a subclass).
    """

    code = "PL407"  # generic "spec rejected by flatten" fallback

    def __init__(self, message: str, code: str | None = None):
        super().__init__(message)
        if code is not None:
            self.code = code


@dataclasses.dataclass(frozen=True)
class Ref:
    """One static memory reference inside a loop body.

    ``addr_terms`` maps loop depth (0 = the nest's parallel loop) to the
    row-major address coefficient; the element address of an occurrence is
    ``addr_base + sum(coef * iv[depth])`` over iteration *values*.
    """

    name: str
    array: str
    addr_terms: tuple[tuple[int, int], ...]
    addr_base: int = 0
    share_span: int | None = None
    is_write: bool = False
    dtype_bytes: int | None = None


@dataclasses.dataclass(frozen=True)
class Loop:
    """``for iv in (start, start+step, ...) x trip: body``.

    - ``bound_coef``: optional ``(a, b)`` making this an inner bounded
      (triangular) loop whose effective trip is ``a + b*idx[bound_level]``
      (``bound_level`` 0 = the parallel index); ``trip`` is the static
      maximum.
    - ``start_coef``: the loop's first VALUE is ``start + start_coef*k``
      (``k`` the parallel index); it moves addresses, never positions.
    - ``bound_level > 0``: a doubly-triangular loop (cholesky's ``k < j``
      inside ``j < i``); positions become quadratic and flatten through
      :func:`flatten_nest_quad`.
    """

    trip: int
    body: tuple[Union["Loop", Ref], ...]
    start: int = 0
    step: int = 1
    bound_coef: tuple[int, int] | None = None
    start_coef: int = 0
    bound_level: int = 0


@dataclasses.dataclass(frozen=True)
class LoopNestSpec:
    """A workload: parallel loop nests over named arrays, run back to back.

    ``arrays``: (name, total elements) per array, in declaration order (the
    order of the reference's cold-miss flush and of the global line ids).
    """

    name: str
    arrays: tuple[tuple[str, int], ...]
    nests: tuple[Loop, ...]

    def array_index(self, name: str) -> int:
        for i, (a, _) in enumerate(self.arrays):
            if a == name:
                return i
        raise KeyError(name)

    def line_counts(self, cfg: SamplerConfig = DEFAULT) -> list[int]:
        """Cache lines per array: ceil(elements * DS / CLS)."""
        return [-(-n * cfg.ds // cfg.cls) for _, n in self.arrays]

    def line_bases(self, cfg: SamplerConfig = DEFAULT) -> list[int]:
        """Exclusive prefix sum of line_counts: global line-id base per array."""
        bases, acc = [], 0
        for n in self.line_counts(cfg):
            bases.append(acc)
            acc += n
        return bases

    def total_lines(self, cfg: SamplerConfig = DEFAULT) -> int:
        return sum(self.line_counts(cfg))


def loop_size(item: Union[Loop, Ref]) -> int:
    """Accesses performed by one execution of ``item`` (static maximum for
    bounded loops — their ``trip`` is the declared maximum)."""
    if isinstance(item, Ref):
        return 1
    return item.trip * sum(loop_size(b) for b in item.body)


def nest_depth(item: Union[Loop, Ref]) -> int:
    """Deepest loop-chain length under ``item`` (a bare Ref is depth 0).
    The band size the transform prover permutes/tiles over."""
    if isinstance(item, Ref):
        return 0
    return 1 + max((nest_depth(b) for b in item.body), default=0)


def loop_size_affine(item: Union[Loop, Ref]) -> tuple[int, int]:
    """Accesses of one execution of ``item`` as ``c0 + c1*k`` (``k`` = the
    parallel index).  Rejects a bounded loop containing another bounded
    loop and a loop bounded on an inner level: both are quadratic in
    ``k`` (the quad accounting handles them)."""
    if isinstance(item, Ref):
        return (1, 0)
    b0 = b1 = 0
    for b in item.body:
        c0, c1 = loop_size_affine(b)
        b0 += c0
        b1 += c1
    if item.bound_coef is not None:
        if item.bound_level:
            raise ValueError(
                "loop bounded on an inner level (bound_level > 0): sizes "
                "are quadratic — use the quad accounting "
                "(nest_iteration_sizes / flatten_nest_quad)")
        if b1:
            raise ValueError(
                "triangular (bounded) loops must not nest inside each other")
        a, b = item.bound_coef
        return (a * b0, b * b0)
    return (item.trip * b0, item.trip * b1)


@dataclasses.dataclass(frozen=True)
class FlatRef:
    """A reference flattened against its enclosing loop chain.

    For the occurrence with per-level indices ``idx[0..d]`` (index space)
    at parallel index ``k`` the stream position inside one execution of the
    nest is::

        pos = offset + offset_k*k + offset_g2*tri(k)
              + sum(idx[l] * (pos_strides[l] + pos_strides_k[l]*k)
                    + pos_quads[l]*tri(idx[l]))

    with ``tri(x) = x*(x-1)/2``, and the element address is::

        addr = addr_base + sum(addr_coefs[l] * (starts[l] + starts_k[l]*k
                                                + steps[l]*idx[l]))

    ``bounds[l]`` is loop ``l``'s ``(a, b)`` parallel-level bound or None
    (valid iff ``idx[l] < a + b*k``); ``inner_bounds`` holds the quad
    contract's ``(level, a, b, ref_level)`` masks
    ``idx[level] < a + b*idx[ref_level]``.
    """

    ref: Ref
    trips: tuple[int, ...]
    starts: tuple[int, ...]
    steps: tuple[int, ...]
    pos_strides: tuple[int, ...]
    offset: int
    addr_coefs: tuple[int, ...]
    pos_strides_k: tuple[int, ...] = ()
    offset_k: int = 0
    bounds: tuple[tuple[int, int] | None, ...] = ()
    starts_k: tuple[int, ...] = ()
    pos_quads: tuple[int, ...] = ()
    offset_g2: int = 0
    inner_bounds: tuple[tuple[int, int, int, int], ...] = ()


def _nest_any(nest: Loop, pred) -> bool:
    """True when ``pred(loop)`` holds for any loop in the nest tree."""
    def walk(item) -> bool:
        if isinstance(item, Ref):
            return False
        return pred(item) or any(walk(b) for b in item.body)

    return walk(nest)


def nest_has_bounds(nest: Loop) -> bool:
    """True when any loop in the nest is bounded (``bound_coef``).  This —
    not the net body slope — selects the clock-table position path:
    sibling bounded loops with canceling slopes leave the body size
    constant while later refs still have nonzero ``offset_k``."""
    return _nest_any(nest, lambda l: l.bound_coef is not None)


def nest_has_inner_bounds(nest: Loop) -> bool:
    """True when any loop's bound references an inner level
    (``bound_level > 0``)."""
    return _nest_any(
        nest, lambda l: l.bound_coef is not None and l.bound_level > 0)


def nest_has_varying_start(nest: Loop) -> bool:
    """True when any loop in the nest has a nonzero ``start_coef``: such
    nests break the template path's shift invariance even with constant
    trips, because iteration values shift with the parallel index."""
    return _nest_any(nest, lambda l: bool(l.start_coef))


def nest_is_quad(nest: Loop) -> bool:
    """True when the nest needs the quadratic-position flatten: a bound
    referencing an inner level, or bounded loops nested inside each other
    (their trip product is quadratic in the parallel index)."""
    def bounded_inside_bounded(item) -> bool:
        if isinstance(item, Ref):
            return False
        if item.bound_coef is not None and any(
                nest_has_bounds(b) for b in item.body if isinstance(b, Loop)):
            return True
        return any(bounded_inside_bounded(b) for b in item.body)

    return nest_has_inner_bounds(nest) or bounded_inside_bounded(nest)


def _rectangular_root(nest: Loop) -> None:
    if nest.bound_coef is not None or nest.start_coef:
        raise SpecContractError(
            "the parallel (outermost) loop must be rectangular; bound_coef/"
            "start_coef are for inner loops", "PL401")


def _addr_coefs(item: Ref, depth: int) -> tuple[int, ...]:
    coefs = [0] * depth
    for d, coef in item.addr_terms:
        if not 0 <= d < depth:
            raise SpecContractError(
                f"ref {item.name}: addr term depth {d} exceeds loop chain "
                f"depth {depth}", "PL403")
        coefs[d] += coef
    return tuple(coefs)


def flatten_nest(nest: Loop) -> list[FlatRef]:
    """Flatten one parallel nest into per-reference occurrence specs
    (dispatches to :func:`flatten_nest_quad` for quadratic nests)."""
    if nest_is_quad(nest):
        return flatten_nest_quad(nest)
    _rectangular_root(nest)
    out: list[FlatRef] = []

    def check_bound(loop: Loop) -> None:
        a, b = loop.bound_coef
        ends = (a, a + b * (nest.trip - 1))
        if min(ends) < 0 or max(ends) > loop.trip:
            raise SpecContractError(
                f"bound {loop.bound_coef} leaves [0, trip={loop.trip}] over "
                f"parallel indices [0, {nest.trip})", "PL402")

    def walk(loop: Loop, chain: list[Loop], off0: int, off1: int) -> None:
        chain = chain + [loop]
        b_off0 = b_off1 = 0
        for item in loop.body:
            if isinstance(item, Ref):
                s_aff = []
                for l in chain:
                    s0 = s1 = 0
                    for b in l.body:
                        c0, c1 = loop_size_affine(b)
                        s0 += c0
                        s1 += c1
                    s_aff.append((s0, s1))
                out.append(FlatRef(
                    ref=item,
                    trips=tuple(l.trip for l in chain),
                    starts=tuple(l.start for l in chain),
                    steps=tuple(l.step for l in chain),
                    pos_strides=tuple(s[0] for s in s_aff),
                    offset=off0 + b_off0,
                    addr_coefs=_addr_coefs(item, len(chain)),
                    pos_strides_k=tuple(s[1] for s in s_aff),
                    offset_k=off1 + b_off1,
                    bounds=tuple(l.bound_coef for l in chain),
                    starts_k=tuple(l.start_coef for l in chain),
                ))
                b_off0 += 1
            else:
                if item.bound_coef is not None:
                    check_bound(item)
                walk(item, chain, off0 + b_off0, off1 + b_off1)
                s0, s1 = loop_size_affine(item)
                b_off0 += s0
                b_off1 += s1

    walk(nest, [], 0, 0)
    return out


def nest_iteration_size_affine(nest: Loop) -> tuple[int, int]:
    """Accesses per parallel iteration as ``n0 + n1*k``."""
    n0 = n1 = 0
    for b in nest.body:
        c0, c1 = loop_size_affine(b)
        n0 += c0
        n1 += c1
    return n0, n1


def nest_iteration_size(nest: Loop) -> int:
    """MAX accesses per iteration of the nest's parallel loop (for bounded
    nests the size at its worst parallel index — used for window sizing)."""
    if nest_is_quad(nest):
        return int(_nest_sizes_full(nest).max())
    n0, n1 = nest_iteration_size_affine(nest)
    if n1 == 0:
        return n0
    return max(n0, n0 + n1 * (nest.trip - 1))


def nest_iteration_sizes(nest: Loop, gs) -> np.ndarray:
    """EXACT accesses per parallel iteration at parallel indices ``gs``,
    for any supported nest (affine or quad)."""
    return _nest_sizes_full(nest)[np.asarray(gs, np.int64)]


def slot_sizes(nest: Loop, owned: np.ndarray, trip: int, chunk_size: int):
    """``(slot, valid)``: exact accesses at every (thread, round,
    chunk-slot) of an ``owned`` chunk matrix (invalid slots 0) — the
    per-slot size rule of the engine's clock tables."""
    g = owned[:, :, None].astype(np.int64) * chunk_size \
        + np.arange(chunk_size)
    valid = (owned[:, :, None] >= 0) & (g < trip)
    if nest_is_quad(nest):
        sizes = nest_iteration_sizes(nest, np.clip(g, 0, trip - 1))
        slot = np.where(valid, sizes, 0)
    else:
        n0, n1 = nest_iteration_size_affine(nest)
        slot = np.where(valid, n0 + n1 * g, 0)
    return slot, valid


def _any_child_bounded_on(loop: Loop, level: int) -> bool:
    """True when any loop in ``loop``'s body tree is bounded on ``level``."""
    return any(
        _nest_any(b, lambda l: l.bound_coef is not None
                  and l.bound_level == level)
        for b in loop.body if isinstance(b, Loop))


@functools.lru_cache(maxsize=128)
def _nest_sizes_full(nest: Loop) -> np.ndarray:
    """[trip] exact accesses per parallel iteration, memoized per nest."""
    gs = np.arange(nest.trip, dtype=np.int64)

    def size(item, env: dict, level: int):
        # env maps enclosing level -> index value (array over gs or int);
        # ``level`` is the depth ``item`` itself sits at
        if isinstance(item, Ref):
            return 1
        if item.bound_coef is None:
            trips = item.trip
        else:
            a, b = item.bound_coef
            trips = a + b * np.asarray(env[item.bound_level])
        if not _any_child_bounded_on(item, level):
            body = sum(size(b, {**env, level: 0}, level + 1)
                       for b in item.body)
            return trips * body
        # some descendant's trip references THIS loop's index: sum per t
        total = np.zeros_like(gs)
        for t in range(int(np.max(trips))):
            body = sum(size(b, {**env, level: t}, level + 1)
                       for b in item.body)
            total = total + np.where(t < trips, body, 0)
        return total

    body = sum(size(b, {0: gs}, 1) for b in nest.body)
    return np.broadcast_to(np.asarray(body, np.int64), gs.shape).copy()


# -- the quadratic-position contract -------------------------------------------


def _tri_of_const(c: int) -> int:
    return c * (c - 1) // 2


class _QuadContractError(SpecContractError):
    code = "PL405"

    def __init__(self, what: str):
        super().__init__(
            f"outside the quadratic position contract: {what} (positions "
            "must stay degree <= 2 with integer closed forms)")


def _fadd(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) + v
    return {k: v for k, v in out.items() if v}


def _fscale(f: dict, c: int) -> dict:
    return {k: cv for k, v in f.items() if (cv := v * c)}


def _fsum_over(f: dict, tdesc) -> dict:
    """``sum_{t in [0, T)} f(t, ...)`` over the position-form monomial basis
    ``{1, g, tri(g)='g2', idx_l=('i',l), tri(idx_l)=('t',l), idx_l*g=('ig',l)}``.

    ``tdesc``: ``('const', c)`` | ``('g', a, b)`` (T = a + b*g) |
    ``('idx', m, a, b)`` (T = a + b*idx_m).  The summand references the
    summation variable through the ``'self'`` keys.  Anything that would
    leave the basis raises :class:`_QuadContractError`: exactness is never
    approximated.
    """
    kind = tdesc[0]
    self_l = tdesc[1] if kind == "idx" else None
    A = dict(f)
    B = A.pop(("i", "self"), 0)
    C = A.pop(("t", "self"), 0)
    D = A.pop(("ig", "self"), 0)
    if C:
        raise _QuadContractError("summing a tri(t) term (degree 3)")

    def tri_of_T() -> dict:
        # tri(a + b*v) = b^2*tri(v) + (b*(b-1)//2 + a*b)*v + tri(a)
        if kind == "const":
            return {"1": _tri_of_const(tdesc[1])}
        a, b = tdesc[-2], tdesc[-1]
        lin = b * (b - 1) // 2 + a * b
        vkey_l, vkey_t = (("g", "g2") if kind == "g"
                          else (("i", self_l), ("t", self_l)))
        return {vkey_t: b * b, vkey_l: lin, "1": _tri_of_const(a)}

    def times_T(form: dict) -> dict:
        # form * (a + b*v); form holds no self keys (split off above)
        if kind == "const":
            return _fscale(form, tdesc[1])
        a, b = tdesc[-2], tdesc[-1]
        res = _fscale(form, a)
        if b == 0:
            return res
        for k, v in form.items():
            c = v * b
            if k == "1":
                lift = {("g" if kind == "g" else ("i", self_l)): c}
            elif kind == "g" and k == "g":
                lift = {"g2": 2 * c, "g": c}        # g*g = 2*tri(g) + g
            elif kind == "g" and isinstance(k, tuple) and k[0] == "i":
                lift = {("ig", k[1]): c}
            elif kind == "idx" and k == "g":
                lift = {("ig", self_l): c}
            elif kind == "idx" and k == ("i", self_l):
                lift = {("t", self_l): 2 * c, ("i", self_l): c}
            else:
                raise _QuadContractError(f"product {k} * bound variable")
            res = _fadd(res, lift)
        return res

    out = _fadd(times_T(A), _fscale(tri_of_T(), B))
    if D:
        # sum_{t<T} D*t*g = D*g*tri(T): integral only for a constant T
        if kind != "const":
            raise _QuadContractError("t*g term under a varying bound")
        out = _fadd(out, {"g": D * _tri_of_const(tdesc[1])})
    return out


def _self_keys(f: dict, level: int) -> dict:
    """Rekey ``level``'s monomials to the ``'self'`` markers _fsum_over
    splits on."""
    ren = {("i", level): ("i", "self"), ("t", level): ("t", "self"),
           ("ig", level): ("ig", "self")}
    return {ren.get(k, k): v for k, v in f.items()}


def flatten_nest_quad(nest: Loop) -> list[FlatRef]:
    """Quad-contract flatten: the :class:`FlatRef` fields of
    :func:`flatten_nest` plus the degree-2 ones (``pos_quads``,
    ``offset_g2``, ``inner_bounds``).  Positions are assembled symbolically
    over the form basis of :func:`_fsum_over`, so a loop bounded on an
    inner level gets exact closed-form positions.

    Validated restrictions (each raises): a rectangular parallel loop; a
    bound names one enclosing level, which must have ``start=0, step=1,
    start_coef=0``; a loop bounded on an inner level contains no bounded
    loops.  Varying starts stay supported anywhere else.
    """
    out: list[FlatRef] = []
    _rectangular_root(nest)

    def tdesc_of(loop: Loop, level: int, chain: list[Loop]):
        if loop.bound_coef is None:
            return ("const", loop.trip)
        a, b = loop.bound_coef
        if loop.bound_level == 0:
            return ("g", a, b)
        m = loop.bound_level
        if not 0 < m < level:
            raise SpecContractError(
                f"bound_level {m} must name an enclosing loop (this loop "
                f"sits at depth {level})", "PL404")
        ref = chain[m]
        if ref.start or ref.step != 1 or ref.start_coef:
            raise _QuadContractError(
                "the bound-referenced level must have start=0, step=1, "
                "start_coef=0 (index == value)")
        if any(nest_has_bounds(b) for b in loop.body if isinstance(b, Loop)):
            raise _QuadContractError(
                "a loop bounded on an inner level must not contain bounded "
                "loops")
        return ("idx", m, a, b)

    def size_form(item, level: int, chain: list[Loop]) -> dict:
        if isinstance(item, Ref):
            return {"1": 1}
        body = {}
        for b in item.body:
            body = _fadd(body, size_form(b, level + 1, chain + [item]))
        return _fsum_over(_self_keys(body, level),
                          tdesc_of(item, level, chain))

    def check_bound(loop: Loop, level: int, chain: list[Loop]) -> None:
        a, b = loop.bound_coef
        if not 0 <= loop.bound_level < level:
            raise SpecContractError(
                f"bound_level {loop.bound_level} must name an enclosing "
                f"loop (this loop sits at depth {level})", "PL404")
        # static trips are declared maxima, so trip-1 bounds every chain
        hi = chain[loop.bound_level].trip - 1 if loop.bound_level \
            else nest.trip - 1
        ends = (a, a + b * hi)
        if min(ends) < 0 or max(ends) > loop.trip:
            raise SpecContractError(
                f"bound {loop.bound_coef} leaves [0, trip={loop.trip}] over "
                f"referenced indices [0, {hi}]", "PL402")

    def emit(item: Ref, chain: list[Loop], form: dict) -> None:
        d = len(chain)
        coefs = _addr_coefs(item, d)
        bounds, inner = [], []
        for l, lp in enumerate(chain):
            if lp.bound_coef is None or lp.bound_level == 0:
                bounds.append(lp.bound_coef)
            else:
                bounds.append(None)
                inner.append((l, *lp.bound_coef, lp.bound_level))
        placed = {"1", "g", "g2"} | {(k, l) for k in ("i", "t", "ig")
                                     for l in range(1, d)}
        leftovers = set(form) - placed
        if leftovers:
            raise _QuadContractError(f"unplaced position terms {leftovers}")
        out.append(FlatRef(
            ref=item,
            trips=tuple(l.trip for l in chain),
            starts=tuple(l.start for l in chain),
            steps=tuple(l.step for l in chain),
            pos_strides=tuple(form.get(("i", l), 0) for l in range(d)),
            offset=form.get("1", 0),
            addr_coefs=coefs,
            pos_strides_k=tuple(form.get(("ig", l), 0) for l in range(d)),
            offset_k=form.get("g", 0),
            bounds=tuple(bounds),
            starts_k=tuple(l.start_coef for l in chain),
            pos_quads=tuple(form.get(("t", l), 0) for l in range(d)),
            offset_g2=form.get("g2", 0),
            inner_bounds=tuple(inner),
        ))

    def walk(loop: Loop, chain: list[Loop], off: dict) -> None:
        chain = chain + [loop]
        level = len(chain) - 1
        if level > 0:
            if loop.bound_coef is not None:
                check_bound(loop, level, chain)
            # prefix of earlier iterations of THIS level: sum the body's
            # one-iteration size over t in [0, idx_level)
            body = {}
            for b in loop.body:
                body = _fadd(body, size_form(b, level + 1, chain))
            off = _fadd(off, _fsum_over(_self_keys(body, level),
                                        ("idx", level, 0, 1)))
        b_off: dict = {}
        for item in loop.body:
            if isinstance(item, Ref):
                emit(item, chain, _fadd(off, b_off))
                b_off = _fadd(b_off, {"1": 1})
            else:
                walk(item, chain, _fadd(off, b_off))
                b_off = _fadd(b_off, size_form(item, level + 1, chain))

    walk(nest, [], {})
    return out


def share_span_formula(trip: int, start: int = 0, step: int = 1) -> int:
    """The generated share threshold ``((trip-start)/step + 1) *
    ((trip-start)/step) + 1`` (``…omp.cpp:202``): 16513 for GEMM-128."""
    t = (trip - start) // step
    return (t + 1) * t + 1
