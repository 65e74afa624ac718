"""Frontend IR (the port's copy of ``pluss/frontend/ir.py``): affine
expressions, the recorded loop/ref tree, and the typed PL6xx failure
channel shared by the Python DSL and the pragma-C parser.

Both authoring surfaces (:mod:`pluss_torch.frontend.dsl`,
:mod:`pluss_torch.frontend.cparse`) record into the SAME small tree —
:class:`Program` of :class:`FLoop`/:class:`FRef` — which
:mod:`pluss_torch.frontend.lower` normalizes into a
:class:`~pluss_torch.spec.LoopNestSpec`.  Bounds and subscripts are
:class:`LinExpr` affine forms over loop-variable NAMES; anything that
would leave the affine basis (a product of two variables, a division, a
call) raises :class:`FrontendError` with a stable ``PL6xx`` code at the
moment it is written, never a bare ``SyntaxError``/``TypeError`` later.

PL6xx codes are registered in
:data:`pluss_torch.analysis.diagnostics.CODES` (family ``frontend``), so
the analyzer and the frontend share one diagnostic namespace.
"""

from __future__ import annotations

import dataclasses

from pluss_torch.analysis.diagnostics import Diagnostic, Severity


class FrontendError(ValueError):
    """A construct outside the frontend grammar/contract.

    ``code`` is the stable PL6xx identity; ``diagnostics`` carries the
    finding(s) as :class:`~pluss_torch.analysis.diagnostics.Diagnostic`
    records, so a server can attach them to an ``InvalidRequest`` and
    ``cli import`` can render them exactly like analyzer output.
    A ``ValueError`` subclass (like ``SpecContractError``) so unaware
    callers still see a conventional failure — but never a BARE one.
    """

    code = "PL605"

    def __init__(self, message: str, code: str | None = None,
                 diagnostics: tuple = ()):
        super().__init__(message)
        if code is not None:
            self.code = code
        if not diagnostics:
            diagnostics = (Diagnostic(code=self.code,
                                      severity=Severity.ERROR,
                                      message=message),)
        self.diagnostics = tuple(diagnostics)


class FrontendRejected(FrontendError):
    """A frontend-DERIVED spec the static analyzers refused: the
    source was grammatical, but the spec it lowers to is wrong (out of
    bounds, contract violation, …).  ``diagnostics`` carries the
    analyzer findings — their own PL1xx-PL5xx codes, not a PL6xx."""

    code = "PL609"

    def __init__(self, message: str, diagnostics: tuple = ()):
        super().__init__(message, code="PL609", diagnostics=diagnostics)


def err(code: str, message: str, **loc) -> FrontendError:
    """One-finding :class:`FrontendError` (``loc``: path/nest/ref/array
    stamps for the diagnostic record)."""
    return FrontendError(message, code=code, diagnostics=(
        Diagnostic(code=code, severity=Severity.ERROR, message=message,
                   **loc),))


class LinExpr:
    """An affine form ``const + Σ coef·var`` over loop-variable names.

    Immutable by convention.  ``terms`` is insertion-ordered (Python
    dict) and KEEPS zero coefficients a construct explicitly introduced
    (``0*i``) — the lowering preserves term order and explicit zeros so
    ``emit_dsl`` round-trips hand-written ``addr_terms`` exactly;
    :meth:`nonzero` is the analysis view.

    Supported algebra: ``+``, ``-``, unary ``-``, and ``*`` by an int
    (either side).  A product of two variable-carrying forms — or any
    ``/``, ``//``, ``%``, ``**`` — is out of the affine grammar and
    raises PL601 at the point of use.
    """

    __slots__ = ("terms", "const")

    def __init__(self, terms: dict[str, int] | None = None,
                 const: int = 0):
        self.terms = dict(terms or {})
        self.const = const

    # -- construction -------------------------------------------------------

    @staticmethod
    def var(name: str) -> "LinExpr":
        return LinExpr({name: 1}, 0)

    @staticmethod
    def of(v) -> "LinExpr":
        if isinstance(v, LinExpr):
            return v
        if isinstance(v, bool) or not isinstance(v, int):
            raise err("PL601",
                      f"expected an integer or affine loop-index "
                      f"expression, got {type(v).__name__} ({v!r})")
        return LinExpr({}, v)

    # -- views --------------------------------------------------------------

    def nonzero(self) -> dict[str, int]:
        return {v: c for v, c in self.terms.items() if c}

    def vars(self) -> list[str]:
        return [v for v, c in self.terms.items() if c]

    def is_const(self) -> bool:
        return not self.vars()

    def const_value(self, code: str, what: str) -> int:
        if not self.is_const():
            raise err(code, f"{what} must be a constant, got {self}")
        return self.const

    def coef(self, var: str) -> int:
        return self.terms.get(var, 0)

    # -- algebra ------------------------------------------------------------

    def _add(self, other, sign: int) -> "LinExpr":
        o = LinExpr.of(other)
        terms = dict(self.terms)
        for v, c in o.terms.items():
            terms[v] = terms.get(v, 0) + sign * c
        return LinExpr(terms, self.const + sign * o.const)

    def __add__(self, other):
        return self._add(other, 1)

    def __radd__(self, other):
        return LinExpr.of(other)._add(self, 1)

    def __sub__(self, other):
        return self._add(other, -1)

    def __rsub__(self, other):
        return LinExpr.of(other)._add(self, -1)

    def __neg__(self):
        return LinExpr({}, 0)._add(self, -1)

    def __mul__(self, other):
        o = LinExpr.of(other)
        if self.vars() and o.vars():
            raise err("PL601",
                      f"non-affine product {self} * {o}: loop indices "
                      "may only be scaled by constants")
        a, b = (self, o) if o.is_const() else (o, self)
        k = b.const
        return LinExpr({v: c * k for v, c in a.terms.items()},
                       a.const * k)

    def __rmul__(self, other):
        return self.__mul__(other)

    def _reject(self, op: str):
        raise err("PL601", f"operator {op!r} on a loop-index expression "
                           f"({self}) is outside the affine grammar")

    def __truediv__(self, other):
        self._reject("/")

    def __rtruediv__(self, other):
        self._reject("/")

    def __floordiv__(self, other):
        self._reject("//")

    def __rfloordiv__(self, other):
        self._reject("//")

    def __mod__(self, other):
        self._reject("%")

    def __rmod__(self, other):
        self._reject("%")

    def __pow__(self, other):
        self._reject("**")

    def __repr__(self) -> str:
        bits = [f"{c}*{v}" for v, c in self.terms.items()]
        if self.const or not bits:
            bits.append(str(self.const))
        return " + ".join(bits)

    def __eq__(self, other):
        if not isinstance(other, LinExpr):
            return NotImplemented
        return self.nonzero() == other.nonzero() \
            and self.const == other.const

    def __hash__(self):
        return hash((frozenset(self.nonzero().items()), self.const))


def fold_row_major(subs: list["LinExpr"], dims: tuple[int, ...]) -> "LinExpr":
    """Row-major linearization ``((s0*d1 + s1)*d2 + s2)...`` — the ONE
    home of the subscript->address convention both authoring surfaces
    must share with ``spec`` addr_terms semantics."""
    lin = subs[0]
    for d, s in zip(dims[1:], subs[1:]):
        lin = lin * d + s
    return lin


@dataclasses.dataclass
class FRef:
    """One recorded array reference: a LINEAR (already row-major-folded)
    affine address over in-scope loop vars."""

    array: str
    index: LinExpr
    is_write: bool
    name: str | None = None
    share_span: int | None = None
    dtype_bytes: int | None = None
    where: str = ""                 # source location for diagnostics


@dataclasses.dataclass
class FLoop:
    """One recorded loop: ``for var in range(lo, hi, step)`` over VALUES
    (Python range semantics — ``hi`` exclusive for positive steps,
    descending for negative ones)."""

    var: str
    lo: LinExpr
    hi: LinExpr
    step: int = 1
    parallel: bool = False
    #: declared static-maximum trip override (``Loop.trip`` is a declared
    #: max for bounded loops; hand-written specs sometimes declare it
    #: looser than the computed maximum, and round-tripping must keep it)
    trip_max: int | None = None
    body: list = dataclasses.field(default_factory=list)
    where: str = ""


@dataclasses.dataclass
class Program:
    """One authored workload, surface-independent."""

    name: str
    #: declaration order is the spec's array order (the cold-flush order)
    arrays: dict[str, tuple[tuple[int, ...], int | None]] \
        = dataclasses.field(default_factory=dict)
    nests: list[FLoop] = dataclasses.field(default_factory=list)
    #: derive missing share_spans from the race classification (the
    #: generated-sampler convention); explicit spans always win
    auto_span: bool = True
