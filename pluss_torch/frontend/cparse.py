"""Recursive-descent parser for the pragma-annotated C subset the
reference targets — the ``gemm.ppcg_omp.c`` shape (the port's copy of
``pluss/frontend/cparse.py``: the same grammar, and the same PL6xx code
at the same line for every rejection).

The reference's samplers are ppcg-generated from C like::

    #define N 128
    double C[N][N]; double A[N][N]; double B[N][N];
    double alpha, beta;                       /* scalars: registers */

    #pragma pluss parallel
    for (c0 = 0; c0 <= N - 1; c0 += 1)
      for (c1 = 0; c1 <= N - 1; c1 += 1) {
        C[c0][c1] *= beta;
        for (c2 = 0; c2 <= N - 1; c2 += 1)
          C[c0][c1] += alpha * A[c0][c2] * B[c2][c1];
      }

This module parses exactly that subset — no external deps, a
hand-written tokenizer + recursive descent — into a frontend
:class:`~pluss_torch.frontend.ir.Program` that lowers through the same
normalizer as the Python DSL.  Accepted grammar:

- ``#define NAME INT`` constants, ``#include`` lines (ignored),
  ``// …`` and ``/* … */`` comments;
- array declarations ``double|float|int|long NAME[dim]...;`` (dims
  constant; ``float``/``int`` set the 4-byte element override, the
  8-byte types keep the machine default) and scalar declarations
  (registers — their accesses are not walked, the generated-sampler
  convention);
- ``#pragma pluss parallel`` immediately before each TOP-LEVEL ``for``
  nest (one pragma per nest; a top-level nest without one is PL603);
- ``for (v = LO; v < HI; v++)`` — also ``<=``, ``v += 1``,
  ``v = v + 1``; bounds affine in enclosing loop variables.  Non-unit
  or descending steps are OUT of this grammar (PL602) — transcribe a
  backward scan by reversing the subscript, as the checked-in deriche
  source does;
- assignment statements whose subscripts are affine in the loop
  variables.  Reference extraction follows the generated-sampler
  convention: RHS array refs in textual order as loads, then (for
  compound assignments) the LHS load, then the LHS store.  Scalar
  assignments contribute only their RHS loads.  Calls (``sqrt(...)``)
  are opaque values whose arguments still contribute refs.

Everything else raises a typed ``PL6xx``
:class:`~pluss_torch.frontend.ir.FrontendError` naming the source line —
never a bare ``SyntaxError``.
"""

from __future__ import annotations

import re

from pluss_torch.frontend.ir import (FLoop, FRef, LinExpr, Program, err,
                                     fold_row_major)

#: C element type -> dtype_bytes override (None = the machine default,
#: like ``Ref.dtype_bytes=None`` — the reference's -DDS=8 world)
CTYPES = {"double": None, "long": None, "float": 4, "int": 4}

_TOKEN = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>//[^\n]*|/\*.*?\*/)
  | (?P<num>\d+\.\d+(?:[eE][+-]?\d+)?[fF]?|\.\d+|\d+[uUlL]*)
  | (?P<ident>[A-Za-z_]\w*)
  | (?P<str>"[^"\n]*"|'[^'\n]*')
  | (?P<op><=|>=|==|!=|\+=|-=|\*=|/=|%=|\+\+|--|&&|\|\||<<|>>
      |[-+*/%<>=!&|^~?:;,.(){}\[\]\#])
""", re.VERBOSE | re.DOTALL)


class _Tok:
    __slots__ = ("kind", "text", "line")

    def __init__(self, kind: str, text: str, line: int):
        self.kind = kind
        self.text = text
        self.line = line

    def __repr__(self):
        return f"{self.text!r}@{self.line}"


def _int_lit(text: str) -> int:
    """Integer literal value, C suffixes (8L, 3u, 1UL) stripped."""
    return int(text.rstrip("uUlL"))


def tokenize(src: str) -> list[_Tok]:
    toks: list[_Tok] = []
    pos, line = 0, 1
    while pos < len(src):
        m = _TOKEN.match(src, pos)
        if m is None:
            raise err("PL605", f"line {line}: unrecognized character "
                               f"{src[pos]!r}", path=f"line {line}")
        text = m.group(0)
        kind = m.lastgroup
        if kind == "num" and not re.fullmatch(r"\d+[uUlL]*", text):
            kind = "float"
        if kind not in ("ws", "comment"):
            toks.append(_Tok(kind, text, line))
        line += text.count("\n")
        pos = m.end()
    toks.append(_Tok("eof", "<eof>", line))
    return toks


class CParser:
    """One source file -> one :class:`Program` (all pragma nests)."""

    def __init__(self, src: str, name: str):
        self.toks = tokenize(src)
        self.i = 0
        self.program = Program(name=name, auto_span=True)
        self.defines: dict[str, int] = {}
        self.scalars: set[str] = set()

    # -- token plumbing -----------------------------------------------------

    def peek(self, ahead: int = 0) -> _Tok:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> _Tok:
        t = self.peek()
        self.i = min(self.i + 1, len(self.toks) - 1)
        return t

    def at(self, text: str) -> bool:
        return self.peek().text == text

    def accept(self, text: str) -> bool:
        if self.at(text):
            self.next()
            return True
        return False

    def expect(self, text: str, what: str = "") -> _Tok:
        t = self.peek()
        if t.text != text:
            self.fail("PL605", f"expected {text!r}"
                               + (f" {what}" if what else "")
                               + f", got {t.text!r}")
        return self.next()

    def fail(self, code: str, msg: str):
        line = self.peek().line
        raise err(code, f"line {line}: {msg}", path=f"line {line}")

    # -- top level ----------------------------------------------------------

    def parse(self) -> Program:
        while not self.at("<eof>"):
            if self.at("#"):
                self._directive()
            elif self.peek().text in CTYPES:
                self._declaration()
            elif self.at("for"):
                self.fail("PL603", "top-level `for` without `#pragma "
                                   "pluss parallel` — every top-level "
                                   "nest needs the pragma")
            elif self.at(";"):
                self.next()
            else:
                self.fail("PL605", f"unexpected {self.peek().text!r} at "
                                   "file scope (expected a declaration, "
                                   "#pragma pluss parallel, or #define)")
        if not self.program.nests:
            self.fail("PL603", "no `#pragma pluss parallel` loop nest "
                               "in the source")
        return self.program

    def _directive(self) -> None:
        hash_line = self.peek().line
        self.expect("#")
        kw = self.next()
        if kw.text == "define":
            name = self._ident("after #define")
            neg = self.accept("-")
            v = self.peek()
            if v.kind != "num":
                self.fail("PL605", "#define value must be an integer "
                                   f"constant, got {v.text!r}")
            self.next()
            self.defines[name] = -_int_lit(v.text) if neg \
                else _int_lit(v.text)
        elif kw.text == "include":
            while self.peek().line == hash_line \
                    and not self.at("<eof>"):
                self.next()
        elif kw.text == "pragma":
            if not (self.accept("pluss") and self.accept("parallel")):
                self.fail("PL605", "only `#pragma pluss parallel` is "
                                   "recognized")
            if not self.at("for"):
                self.fail("PL603", "`#pragma pluss parallel` must "
                                   "immediately precede a `for` loop")
            self.program.nests.append(self._for([], parallel=True))
        else:
            self.fail("PL605", f"unknown directive #{kw.text}")

    def _ident(self, what: str) -> str:
        t = self.peek()
        if t.kind != "ident":
            self.fail("PL605", f"expected an identifier {what}, got "
                               f"{t.text!r}")
        return self.next().text

    def _declaration(self) -> None:
        ctype = self.next().text
        while True:
            line = self.peek().line
            name = self._ident(f"in {ctype} declaration")
            if name in self.defines:
                # defines win in expression resolution (_expr_refs and
                # _affine_factor check them first): a collision would
                # silently constant-fold this name's refs away
                self.fail("PL604", f"declaration of {name!r} collides "
                                   "with a #define of the same name")
            dims: list[int] = []
            while self.accept("["):
                dims.append(self._const_expr("array dimension"))
                self.expect("]")
            if self.accept("="):   # initializer: skip to , or ; (depth 0)
                depth = 0
                while not self.at("<eof>"):
                    t = self.peek().text
                    if depth == 0 and t in (",", ";"):
                        break
                    depth += t in "([{"
                    depth -= t in ")]}"
                    self.next()
            if dims:
                if name in self.program.arrays:
                    self.fail("PL608", f"array {name!r} declared twice")
                self.program.arrays[name] = (tuple(dims), CTYPES[ctype])
            else:
                self.scalars.add(name)
            if self.accept(","):
                continue
            self.expect(";", f"after {ctype} {name} (line {line})")
            return

    def _const_expr(self, what: str) -> int:
        e = self._affine([], what)
        if not e.is_const():
            self.fail("PL601", f"{what} must be constant, got {e}")
        return e.const

    # -- loops --------------------------------------------------------------

    def _for(self, loop_vars: list[str], parallel: bool = False) -> FLoop:
        line = self.peek().line
        self.expect("for")
        self.expect("(")
        var = self._ident("as the loop variable")
        if var in loop_vars:
            self.fail("PL604", f"loop variable {var!r} shadows an "
                               "enclosing loop variable")
        if var in self.program.arrays or var in self.scalars \
                or var in self.defines:
            # defines included: _affine_factor resolves a define FIRST,
            # so a shadowing loop var would silently become a constant
            # in every bound and subscript — wrong addresses, no error
            self.fail("PL604", f"loop variable {var!r} shadows a "
                               "declared array/scalar/#define")
        self.expect("=", "in the loop initializer")
        lo = self._affine(loop_vars, f"lower bound of {var!r}")
        self.expect(";")
        cond_var = self._ident("in the loop condition")
        if cond_var != var:
            self.fail("PL605", f"loop condition tests {cond_var!r}, "
                               f"expected {var!r}")
        rel = self.peek().text
        if rel in (">", ">=", "!=", "=="):
            self.fail("PL602", f"loop relation {rel!r} is outside the "
                               "grammar (only ascending `<`/`<=` loops; "
                               "transcribe a backward scan by reversing "
                               "the subscript)")
        if rel not in ("<", "<="):
            self.fail("PL605", f"expected < or <= in the loop "
                               f"condition, got {rel!r}")
        self.next()
        hi = self._affine(loop_vars + [var], f"upper bound of {var!r}")
        if hi.coef(var):
            self.fail("PL601", f"upper bound of {var!r} references "
                               f"{var!r} itself")
        if rel == "<=":
            hi = hi + 1
        self.expect(";")
        self._unit_step(var)
        self.expect(")")
        fl = FLoop(var=var, lo=lo, hi=hi, step=1, parallel=parallel,
                   where=f"line {line}")
        self._stmt_into(fl, loop_vars + [var])
        if not fl.body:
            self.fail("PL605", f"loop {var!r} (line {line}) has an "
                               "empty body")
        return fl

    def _unit_step(self, var: str) -> None:
        """Accept exactly the unit ascending increments: ``v++``,
        ``++v``, ``v += 1``, ``v = v + 1``; everything else is PL602."""
        t = self.peek().text
        if t == "++":
            self.next()
            if self._ident("after ++") != var:
                self.fail("PL605", f"increment must step {var!r}")
            return
        name = self._ident("in the loop increment")
        if name != var:
            self.fail("PL605", f"increment steps {name!r}, expected "
                               f"{var!r}")
        op = self.next().text
        if op == "++":
            return
        if op == "--":
            self.fail("PL602", f"descending step {var}-- is outside the "
                               "grammar (non-unit/negative steps are "
                               "not accepted)")
        if op == "+=":
            v = self.peek()
            if v.kind == "num" and v.text == "1":
                self.next()
                return
            self.fail("PL602", f"non-unit step `{var} += {v.text}` is "
                               "outside the grammar")
        if op == "-=":
            self.fail("PL602", f"negative step `{var} -= …` is outside "
                               "the grammar")
        if op == "=":
            if self.accept(var) and self.accept("+"):
                v = self.peek()
                if v.kind == "num" and v.text == "1":
                    self.next()
                    return
                self.fail("PL602", f"non-unit step `{var} = {var} + "
                                   f"{v.text}` is outside the grammar")
            self.fail("PL602", f"loop increment must be `{var} = {var} "
                               "+ 1` (unit ascending)")
        self.fail("PL605", f"unrecognized loop increment near {op!r}")

    def _stmt_into(self, parent: FLoop, loop_vars: list[str]) -> None:
        """One statement (or block) appended into ``parent.body``."""
        if self.accept("{"):
            while not self.accept("}"):
                if self.at("<eof>"):
                    self.fail("PL605", "unterminated { block")
                self._stmt_into(parent, loop_vars)
            return
        if self.at("for"):
            parent.body.append(self._for(loop_vars))
            return
        if self.at("#"):
            self.fail("PL603", "a `#pragma` inside a loop nest is "
                               "misplaced — the parallel pragma belongs "
                               "on the top-level loop only")
        if self.accept(";"):
            return
        if self.peek().text in CTYPES:
            self.fail("PL605", "declarations inside a loop body are not "
                               "in the grammar (declare arrays and "
                               "scalars at file scope)")
        if self.peek().text in ("if", "while", "do", "switch", "return"):
            self.fail("PL605", f"`{self.peek().text}` statements are "
                               "outside the affine subset")
        self._assignment(parent, loop_vars)

    # -- statements / expressions -------------------------------------------

    def _assignment(self, parent: FLoop, loop_vars: list[str]) -> None:
        line = self.peek().line
        name = self._ident("at the start of a statement")
        subs: list[LinExpr] | None = None
        if self.at("["):
            subs = self._subscripts(name, loop_vars)
        elif name in self.program.arrays:
            # a bare array lvalue is NOT a register: silently dropping
            # the store would skew every write-dependent analysis
            self.fail("PL606", f"assignment to array {name!r} without "
                               "subscripts (arrays must be indexed; "
                               "scalars are the registers)")
        op = self.peek().text
        if op not in ("=", "+=", "-=", "*=", "/=", "%="):
            self.fail("PL605", f"expected an assignment after {name}, "
                               f"got {op!r}")
        self.next()
        refs: list[FRef] = []
        self._expr_refs(refs, loop_vars)
        self.expect(";", f"after the statement at line {line}")
        where = f"line {line}"
        for r in refs:
            r.where = where
            parent.body.append(r)
        if subs is not None:           # array lvalue
            lin = self._fold(name, subs)
            if op != "=":              # compound: load, then store
                parent.body.append(FRef(array=name, index=lin,
                                        is_write=False, where=where))
            parent.body.append(FRef(array=name, index=lin,
                                    is_write=True, where=where))
        # scalar lvalue: a register — only its RHS loads are walked

    def _subscripts(self, name: str, loop_vars: list[str]) -> list[LinExpr]:
        if name not in self.program.arrays:
            self.fail("PL606", f"subscripted {name!r} is not a declared "
                               "array")
        dims, _ = self.program.arrays[name]
        subs: list[LinExpr] = []
        while self.accept("["):
            subs.append(self._affine(loop_vars,
                                     f"subscript of {name!r}"))
            self.expect("]")
        if len(subs) != len(dims):
            self.fail("PL606", f"{name!r} is {len(dims)}-dimensional "
                               f"but subscripted with {len(subs)} "
                               "index(es)")
        return subs

    def _fold(self, name: str, subs: list[LinExpr]) -> LinExpr:
        dims, _ = self.program.arrays[name]
        return fold_row_major(subs, dims)

    def _expr_refs(self, refs: list[FRef], loop_vars: list[str]) -> None:
        """Scan one RHS expression, collecting array refs in textual
        order.  Values are opaque (registers/floats/calls are fine);
        only SUBSCRIPTS must be affine."""
        depth = 0
        while True:
            t = self.peek()
            if t.text == "<eof>":
                self.fail("PL605", "unterminated expression")
            if depth == 0 and t.text in (";", ",", ")"):
                return
            if t.text in ("(", "["):
                depth += 1
                self.next()
                continue
            if t.text in (")", "]"):
                depth -= 1
                if depth < 0:
                    self.fail("PL605", f"unbalanced {t.text!r}")
                self.next()
                continue
            if t.kind == "ident" and self.peek(1).text == "[" \
                    and t.text not in self.defines:
                name = self.next().text
                # _subscripts rejects undeclared arrays as PL606
                subs = self._subscripts(name, loop_vars)
                refs.append(FRef(array=name, index=self._fold(name, subs),
                                 is_write=False))
                continue
            if t.text in ("=",):
                self.fail("PL605", "chained assignment is outside the "
                                   "grammar")
            self.next()

    # -- strict affine expressions (bounds, subscripts, dims) ---------------

    def _affine(self, loop_vars: list[str], what: str) -> LinExpr:
        """expr := term (('+'|'-') term)*; term := factor ('*' factor)*;
        factor := INT | DEFINE | loopvar | '(' expr ')' | '-' factor.
        Any division, modulo, float, call, or array ref here is PL601."""
        e = self._affine_term(loop_vars, what)
        while self.peek().text in ("+", "-"):
            op = self.next().text
            rhs = self._affine_term(loop_vars, what)
            e = e + rhs if op == "+" else e - rhs
        if self.peek().text in ("/", "%", "<<", ">>"):
            self.fail("PL601", f"operator {self.peek().text!r} in {what} "
                               "is outside the affine grammar")
        return e

    def _affine_term(self, loop_vars: list[str], what: str) -> LinExpr:
        e = self._affine_factor(loop_vars, what)
        while True:
            t = self.peek().text
            if t == "*":
                self.next()
                rhs = self._affine_factor(loop_vars, what)
                if e.vars() and rhs.vars():
                    self.fail("PL601", f"non-affine product in {what}: "
                                       f"({e}) * ({rhs})")
                e = e * rhs
            elif t in ("/", "%"):
                self.fail("PL601", f"operator {t!r} in {what} is "
                                   "outside the affine grammar")
            else:
                return e

    def _affine_factor(self, loop_vars: list[str], what: str) -> LinExpr:
        t = self.peek()
        if t.text == "-":
            self.next()
            return -self._affine_factor(loop_vars, what)
        if t.text == "(":
            self.next()
            e = self._affine(loop_vars, what)
            self.expect(")")
            return e
        if t.kind == "num":
            self.next()
            return LinExpr.of(_int_lit(t.text))
        if t.kind == "float":
            self.fail("PL601", f"float literal {t.text} in {what} — "
                               "subscripts and bounds are integer affine")
        if t.kind == "ident":
            name = self.next().text
            if name in self.defines:
                return LinExpr.of(self.defines[name])
            if name in loop_vars:
                if self.at("("):
                    self.fail("PL601", f"call {name}(...) in {what}")
                return LinExpr.var(name)
            if name in self.program.arrays or self.at("["):
                self.fail("PL601", f"array reference {name}[…] in "
                                   f"{what} — indirect (non-affine) "
                                   "addressing is outside the grammar")
            if self.at("("):
                self.fail("PL601", f"call {name}(...) in {what} is "
                                   "outside the affine grammar")
            self.fail("PL601", f"{what} references {name!r}, which is "
                               "neither a loop variable, a #define, nor "
                               "an integer constant")
        self.fail("PL605", f"unexpected {t.text!r} in {what}")


def parse_c(src: str, name: str = "source") -> Program:
    """Parse pragma-C text into a frontend Program."""
    return CParser(src, name).parse()
