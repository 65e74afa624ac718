"""PolyBench matrix-vector kernels: atax, mvt, bicg, gesummv.

Rectangular 2-deep nests in the generated-sampler style: operand loads
precede the accumulator's load+store pair, and refs whose address does not
involve the parallel iterator carry the share test with the span formula
``(trip+1)*trip+1`` of the inner loop.
"""

from __future__ import annotations

from pluss_torch.spec import Loop, LoopNestSpec, Ref, share_span_formula


def _accum(out: str, terms, tag: str = "") -> tuple[Ref, Ref]:
    """The accumulator's load+store pair (GEMM's C2/C3 pattern)."""
    return (Ref(f"{out}{tag}2", out, addr_terms=terms),
            Ref(f"{out}{tag}3", out, addr_terms=terms, is_write=True))


def atax(n: int = 128) -> LoopNestSpec:
    """atax: ``tmp = A x`` then ``y += A^T tmp``."""
    span = share_span_formula(n)
    n1 = Loop(trip=n, body=(
        Ref("T0", "tmp", addr_terms=((0, 1),)),
        Ref("T1", "tmp", addr_terms=((0, 1),), is_write=True),
        Loop(trip=n, body=(
            Ref("A0", "A", addr_terms=((0, n), (1, 1))),
            Ref("X0", "x", addr_terms=((1, 1),), share_span=span),
            *_accum("tmp", ((0, 1),)),
        )),
    ))
    n2 = Loop(trip=n, body=(
        Loop(trip=n, body=(
            Ref("A1", "A", addr_terms=((0, n), (1, 1))),
            Ref("T2", "tmp", addr_terms=((0, 1),)),
            Ref("Y2", "y", addr_terms=((1, 1),), share_span=span),
            Ref("Y3", "y", addr_terms=((1, 1),), share_span=span,
                is_write=True),
        )),
    ))
    return LoopNestSpec(
        name=f"atax{n}",
        arrays=(("tmp", n), ("y", n), ("A", n * n), ("x", n)),
        nests=(n1, n2),
    )


def mvt(n: int = 128) -> LoopNestSpec:
    """mvt: ``x1 += A y1`` and ``x2 += A^T y2`` — row- and column-major walks
    of the same matrix under the same parallel dim."""
    span = share_span_formula(n)
    row = Loop(trip=n, body=(
        Loop(trip=n, body=(
            Ref("A0", "A", addr_terms=((0, n), (1, 1))),
            Ref("Y10", "y1", addr_terms=((1, 1),), share_span=span),
            *_accum("x1", ((0, 1),)),
        )),
    ))
    col = Loop(trip=n, body=(
        Loop(trip=n, body=(
            Ref("A1", "A", addr_terms=((0, 1), (1, n))),
            Ref("Y20", "y2", addr_terms=((1, 1),), share_span=span),
            *_accum("x2", ((0, 1),)),
        )),
    ))
    return LoopNestSpec(
        name=f"mvt{n}",
        arrays=(("x1", n), ("x2", n), ("A", n * n), ("y1", n), ("y2", n)),
        nests=(row, col),
    )


def bicg(n: int = 128) -> LoopNestSpec:
    """bicg: ``s += r[i]*A[i][:]`` and ``q[i] += A[i][:]*p`` fused per row."""
    span = share_span_formula(n)
    nest = Loop(trip=n, body=(
        Ref("Q0", "q", addr_terms=((0, 1),)),
        Ref("Q1", "q", addr_terms=((0, 1),), is_write=True),
        Loop(trip=n, body=(
            Ref("A0", "A", addr_terms=((0, n), (1, 1))),
            Ref("R0", "r", addr_terms=((0, 1),)),
            Ref("S2", "s", addr_terms=((1, 1),), share_span=span),
            Ref("S3", "s", addr_terms=((1, 1),), share_span=span,
                is_write=True),
            Ref("P0", "p", addr_terms=((1, 1),), share_span=span),
            *_accum("q", ((0, 1),)),
        )),
    ))
    return LoopNestSpec(
        name=f"bicg{n}",
        arrays=(("s", n), ("q", n), ("A", n * n), ("r", n), ("p", n)),
        nests=(nest,),
    )


def gesummv(n: int = 128) -> LoopNestSpec:
    """gesummv: ``y = alpha*A*x + beta*B*x`` — two matrices streamed against
    one shared vector in a single inner loop."""
    span = share_span_formula(n)
    nest = Loop(trip=n, body=(
        Ref("T0", "tmp", addr_terms=((0, 1),), is_write=True),
        Ref("Y0", "y", addr_terms=((0, 1),), is_write=True),
        Loop(trip=n, body=(
            Ref("A0", "A", addr_terms=((0, n), (1, 1))),
            Ref("X0", "x", addr_terms=((1, 1),), share_span=span),
            *_accum("tmp", ((0, 1),), "t"),
            Ref("B0", "B", addr_terms=((0, n), (1, 1))),
            Ref("X1", "x", addr_terms=((1, 1),), share_span=span),
            *_accum("y", ((0, 1),)),
        )),
        Ref("T4", "tmp", addr_terms=((0, 1),)),
        Ref("Y4", "y", addr_terms=((0, 1),)),
        Ref("Y5", "y", addr_terms=((0, 1),), is_write=True),
    ))
    return LoopNestSpec(
        name=f"gesummv{n}",
        arrays=(("tmp", n), ("y", n), ("A", n * n), ("B", n * n), ("x", n)),
        nests=(nest,),
    )
