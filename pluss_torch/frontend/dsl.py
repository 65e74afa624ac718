"""The Python loop-nest DSL: record a workload by writing it as loops
(the port's copy of ``pluss/frontend/dsl.py``).

The registry hand-encodes every nest as raw ``Loop``/``Ref`` trees with
pre-folded row-major coefficients; the DSL lets a nest be written the
way the source kernel reads, and derives the spec:

.. code-block:: python

    from pluss_torch import frontend

    with frontend.kernel("gemm128"):
        N = 128
        C = frontend.array("C", (N, N))
        A = frontend.array("A", (N, N))
        B = frontend.array("B", (N, N))
        with frontend.loop("i", 0, N, parallel=True) as i:
            with frontend.loop("j", 0, N) as j:
                frontend.read(C, i, j)      # C[i][j] *= beta
                frontend.write(C, i, j)
                with frontend.loop("k", 0, N) as k:
                    frontend.read(A, i, k)  # C += alpha*A[i][k]*B[k][j]
                    frontend.read(B, k, j)
                    frontend.read(C, i, j)
                    frontend.write(C, i, j)

``loop(...)`` yields an affine index VALUE; bounds may reference
enclosing loop values (``frontend.loop("j", 0, i + 1)`` is the
triangular ``j <= i``), and subscripts are any affine combination.
Everything else — a product of two indices, a division, a float — raises
a typed ``PL6xx`` :class:`~pluss_torch.frontend.ir.FrontendError` at the
line that wrote it.  Recording is structural: each ``with`` body runs ONCE.

``kernel(...)`` is both the context manager above and a decorator::

    @frontend.kernel("gemm128")
    def gemm128():
        ...
    spec = gemm128()          # records + lowers per call

Lowering, share-span derivation (``auto_span=``), and the analyzer gate
live in :mod:`pluss_torch.frontend.lower`; the DSL only records.
"""

from __future__ import annotations

import functools
import threading

from pluss_torch.frontend.ir import (FLoop, FRef, LinExpr, Program, err,
                                     fold_row_major)

_tls = threading.local()

#: dtype name -> element bytes; None means "the machine-model default"
#: (``SamplerConfig.ds``), exactly like ``Ref.dtype_bytes=None``
DTYPES = {None: None, "f64": None, "double": None,
          "f32": 4, "float": 4, "i32": 4, "int": 4,
          "f16": 2, "i64": None, "long": None}


def _stack() -> list:
    if not hasattr(_tls, "kernels"):
        _tls.kernels = []
    return _tls.kernels


def _current() -> "_Recorder":
    st = _stack()
    if not st:
        raise err("PL608",
                  "no active frontend.kernel(...) context — array/loop/"
                  "read/write record into the innermost `with "
                  "frontend.kernel(...)` block")
    return st[-1]


class _Recorder:
    """The mutable recording state behind one kernel context."""

    def __init__(self, name: str, auto_span: bool):
        self.program = Program(name=name, auto_span=auto_span)
        self.loop_stack: list[FLoop] = []
        self.handles: dict[int, str] = {}   # id(ArrayHandle) -> name

    # -- arrays -------------------------------------------------------------

    def array(self, name: str, shape, dtype=None) -> "ArrayHandle":
        if not isinstance(name, str) or not name.isidentifier():
            raise err("PL608", f"array name must be an identifier, got "
                               f"{name!r}")
        if name in self.program.arrays:
            raise err("PL608", f"array {name!r} declared twice",
                      array=name)
        if isinstance(shape, int):
            shape = (shape,)
        try:
            shape = tuple(shape)
        except TypeError:
            raise err("PL608", f"array {name!r}: shape must be an int or "
                               f"a tuple of ints, got {shape!r}",
                      array=name) from None
        if not shape or not all(isinstance(d, int)
                                and not isinstance(d, bool) and d > 0
                                for d in shape):
            raise err("PL608", f"array {name!r}: shape dims must be "
                               f"positive ints, got {shape!r}", array=name)
        if isinstance(dtype, int) and not isinstance(dtype, bool):
            dtb = dtype if dtype > 0 else None
        elif dtype in DTYPES:
            dtb = DTYPES[dtype]
        else:
            raise err("PL608", f"array {name!r}: unknown dtype {dtype!r} "
                               f"(one of {sorted(k for k in DTYPES if k)} "
                               "or element bytes as an int)", array=name)
        self.program.arrays[name] = (shape, dtb)
        h = ArrayHandle(name, shape)
        self.handles[id(h)] = name
        return h

    # -- loops --------------------------------------------------------------

    def scope_vars(self) -> list[str]:
        return [l.var for l in self.loop_stack]

    def _check_scope(self, e: LinExpr, what: str) -> None:
        scope = set(self.scope_vars())
        # ALL recorded terms, zero coefficients included: `0 * leaked`
        # must fail typed here, not as a KeyError in the lowering
        for v in e.terms:
            if v not in scope:
                raise err("PL608",
                          f"{what} references loop variable {v!r} "
                          "outside its loop (index expressions are only "
                          "valid inside the `with` block that bound them)")

    def open_loop(self, loop: FLoop) -> None:
        if loop.var in self.scope_vars():
            raise err("PL604", f"loop variable {loop.var!r} shadows an "
                               f"enclosing loop variable")
        if loop.parallel and self.loop_stack:
            raise err("PL603", "parallel=True belongs on a TOP-LEVEL "
                               "loop (each parallel loop is one nest); "
                               f"loop {loop.var!r} is nested")
        if not loop.parallel and not self.loop_stack:
            raise err("PL603", f"top-level loop {loop.var!r} without "
                               "parallel=True — every top-level loop "
                               "nest is one `#pragma pluss parallel` "
                               "dimension")
        self._check_scope(loop.lo, f"loop {loop.var!r} lower bound")
        self._check_scope(loop.hi, f"loop {loop.var!r} upper bound")
        if self.loop_stack:
            self.loop_stack[-1].body.append(loop)
        else:
            self.program.nests.append(loop)
        self.loop_stack.append(loop)

    def close_loop(self, loop: FLoop) -> None:
        if not self.loop_stack or self.loop_stack[-1] is not loop:
            raise err("PL608", f"loop {loop.var!r} closed out of order")
        self.loop_stack.pop()

    # -- refs ---------------------------------------------------------------

    def ref(self, arr, subs, is_write: bool, name, share_span,
            dtype_bytes) -> None:
        if not isinstance(arr, ArrayHandle) \
                or id(arr) not in self.handles:
            raise err("PL606", "read/write needs an array handle from "
                               "THIS kernel's frontend.array(...), got "
                               f"{arr!r}")
        if not self.loop_stack:
            raise err("PL608", f"reference to {arr.name!r} outside any "
                               "loop — references record inside `with "
                               "frontend.loop(...)` blocks", array=arr.name)
        dims = arr.shape
        subs = [LinExpr.of(s) for s in subs]
        if len(subs) != len(dims) and len(subs) != 1:
            raise err("PL606",
                      f"{arr.name!r} is {len(dims)}-dimensional but got "
                      f"{len(subs)} subscript(s) (pass one subscript per "
                      "dim, or a single already-linear index)",
                      array=arr.name)
        for s in subs:
            self._check_scope(s, f"subscript of {arr.name!r}")
        lin = fold_row_major(subs, dims) if len(subs) == len(dims) \
            else subs[0]
        if share_span is not None and (
                isinstance(share_span, bool)
                or not isinstance(share_span, int)):
            raise err("PL608", f"share_span must be an int or None, got "
                               f"{share_span!r}", array=arr.name)
        if dtype_bytes is not None and (
                isinstance(dtype_bytes, bool)
                or not isinstance(dtype_bytes, int) or dtype_bytes < 1):
            raise err("PL608", f"dtype_bytes must be a positive int or "
                               f"None, got {dtype_bytes!r}", array=arr.name)
        if name is not None and not isinstance(name, str):
            raise err("PL608", f"ref name must be a string, got {name!r}",
                      array=arr.name)
        self.loop_stack[-1].body.append(FRef(
            array=arr.name, index=lin, is_write=is_write, name=name,
            share_span=share_span, dtype_bytes=dtype_bytes))


class ArrayHandle:
    """Opaque DSL handle for one declared array."""

    __slots__ = ("name", "shape")

    def __init__(self, name: str, shape: tuple[int, ...]):
        self.name = name
        self.shape = shape

    def __repr__(self) -> str:
        return f"ArrayHandle({self.name!r}, {self.shape})"


class Kernel:
    """One authored kernel: context manager AND decorator (see module
    docstring).  After the ``with`` block exits, :meth:`program` holds
    the recording and :meth:`spec`/:meth:`verified_spec` lower it."""

    def __init__(self, name: str | None, auto_span: bool = True):
        self.name = name
        self.auto_span = auto_span
        self._rec: _Recorder | None = None
        self._program: Program | None = None
        self._spec = None

    # -- context manager ----------------------------------------------------

    def __enter__(self) -> "Kernel":
        if self._rec is not None:
            raise err("PL608", "kernel context entered twice")
        self._rec = _Recorder(self.name or "kernel", self.auto_span)
        _stack().append(self._rec)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        rec = self._rec
        self._rec = None
        st = _stack()
        if st and st[-1] is rec:
            st.pop()
        if exc_type is not None:
            return False
        if rec.loop_stack:
            raise err("PL608", "kernel context exited with an open loop")
        if not rec.program.nests:
            raise err("PL608", f"kernel {rec.program.name!r} recorded no "
                               "loop nest")
        self._program = rec.program
        collector = getattr(_tls, "collector", None)
        if collector is not None:
            collector.append(self)
        return False

    # -- decorator ----------------------------------------------------------

    def __call__(self, fn):
        if not callable(fn):
            raise err("PL608", "kernel(...) is a context manager or a "
                               "decorator on a callable")
        outer = self

        @functools.wraps(fn)
        def build(*args, **kwargs):
            k = Kernel(outer.name or fn.__name__, outer.auto_span)
            with k:
                fn(*args, **kwargs)
            return k.spec()

        build.__pluss_kernel__ = True
        return build

    # -- results ------------------------------------------------------------

    def program(self) -> Program:
        if self._program is None:
            raise err("PL608", "kernel has not finished recording")
        return self._program

    def spec(self):
        """Lower the recording to a LoopNestSpec (no analyzer gate).
        Memoized: the program is immutable once recording ends, and the
        decorator form + the import collector would otherwise pay the
        lowering (and its share-span race analysis) twice per kernel."""
        if self._spec is None:
            from pluss_torch.frontend.lower import lower

            self._spec = lower(self.program())
        return self._spec

    def verified_spec(self, cfg=None):
        """Lower + the lint (and, with ``cfg``, the schedule-aware)
        analyzer gate; ERROR findings raise ``FrontendRejected``."""
        from pluss_torch.frontend.lower import lower, verify_spec

        spec = lower(self.program())
        verify_spec(spec, cfg)
        return spec


# ---------------------------------------------------------------------------
# the module-level surface (operates on the innermost kernel context)


def kernel(name: str | None = None, auto_span: bool = True) -> Kernel:
    """Open one kernel recording (see module docstring)."""
    return Kernel(name, auto_span)


def array(name: str, shape, dtype=None) -> ArrayHandle:
    """Declare an array: ``shape`` is an int (1-D, total elements) or a
    dims tuple (row-major); ``dtype`` an element-width name (``f32``,
    ``f64``…), bytes as an int, or None for the machine default."""
    return _current().array(name, shape, dtype)


class loop:
    """``with frontend.loop(var, lo, hi, step=1, parallel=False) as v:``
    — iterate ``var`` over ``range(lo, hi, step)`` (value semantics).
    Bounds may be affine in enclosing loop values; ``trip_max`` overrides
    the declared static-maximum trip of a varying-bound loop."""

    def __init__(self, var: str, lo, hi, step: int = 1,
                 parallel: bool = False, trip_max: int | None = None):
        if not isinstance(var, str) or not var.isidentifier():
            raise err("PL608", f"loop variable must be an identifier, "
                               f"got {var!r}")
        if isinstance(step, bool) or not isinstance(step, int) or not step:
            raise err("PL602", f"loop {var!r}: step must be a nonzero "
                               f"int, got {step!r}")
        if trip_max is not None and (isinstance(trip_max, bool)
                                     or not isinstance(trip_max, int)
                                     or trip_max < 1):
            raise err("PL608", f"loop {var!r}: trip_max must be a "
                               f"positive int, got {trip_max!r}")
        self._loop = FLoop(var=var, lo=LinExpr.of(lo), hi=LinExpr.of(hi),
                           step=step, parallel=bool(parallel),
                           trip_max=trip_max)

    def __enter__(self) -> LinExpr:
        if getattr(self._loop, "opened", False):
            # re-entering one loop object would ALIAS its FLoop into two
            # tree positions (both nests sharing one body) — corrupted
            # recording, so reject typed like every other misuse
            raise err("PL608", f"loop object {self._loop.var!r} entered "
                               "twice — construct a fresh frontend.loop"
                               "(...) per `with` block")
        self._loop.opened = True   # type: ignore[attr-defined]
        _current().open_loop(self._loop)
        return LinExpr.var(self._loop.var)

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            _current().close_loop(self._loop)
        return False


def loop_raw(var: str, trip: int, start: int = 0, step: int = 1,
             bound_coef: tuple[int, int] | None = None,
             start_coef: int = 0, bound_level: int = 0,
             parallel: bool = False) -> loop:
    """Escape hatch mirroring :class:`pluss_torch.spec.Loop` field-for-field,
    for shapes the value-space sugar cannot express (``start_coef`` not
    divisible by the parallel step, …).  Records a loop whose lowering
    is the identity on these fields."""
    l = loop.__new__(loop)
    if isinstance(trip, bool) or not isinstance(trip, int) or trip < 1:
        raise err("PL608", f"loop {var!r}: trip must be a positive int")
    fl = FLoop(var=var, lo=LinExpr.of(start), hi=LinExpr.of(start),
               step=step, parallel=bool(parallel))
    fl.raw = dict(trip=trip, start=start, step=step,  # type: ignore[attr-defined]
                  bound_coef=tuple(bound_coef) if bound_coef else None,
                  start_coef=start_coef, bound_level=bound_level)
    l._loop = fl
    return l


def read(arr: ArrayHandle, *subs, name: str | None = None,
         share_span: int | None = None,
         dtype_bytes: int | None = None) -> None:
    """Record a load of ``arr[subs...]`` (one subscript per declared dim,
    or a single already-linear index)."""
    _current().ref(arr, subs, False, name, share_span, dtype_bytes)


def write(arr: ArrayHandle, *subs, name: str | None = None,
          share_span: int | None = None,
          dtype_bytes: int | None = None) -> None:
    """Record a store to ``arr[subs...]``."""
    _current().ref(arr, subs, True, name, share_span, dtype_bytes)


class collect_kernels:
    """Context manager collecting every kernel that finishes recording
    inside it — how ``cli import file.py`` gathers a module's kernels
    without the module having to export anything."""

    def __enter__(self) -> list[Kernel]:
        self._prev = getattr(_tls, "collector", None)
        self.kernels: list[Kernel] = []
        _tls.collector = self.kernels
        return self.kernels

    def __exit__(self, *exc) -> bool:
        _tls.collector = self._prev
        return False
