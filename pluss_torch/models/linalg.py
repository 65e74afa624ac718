"""PolyBench linear-algebra kernels beyond the matmul family: atax, mvt,
bicg, gesummv, doitgen, jacobi2d, gemver.

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


def doitgen(n: int = 32) -> LoopNestSpec:
    """doitgen: ``sum[p] = Σ_s A[r][q][s]*C4[s][p]`` then write-back — a 3-D
    data array under a 2-deep parallel nest with a private temporary."""
    span = share_span_formula(n)
    nest = Loop(trip=n, body=(          # r (parallel)
        Loop(trip=n, body=(             # q
            Loop(trip=n, body=(         # p
                Ref("S0", "sum", addr_terms=((2, 1),)),
                Ref("S1", "sum", addr_terms=((2, 1),),
                    is_write=True),
                Loop(trip=n, body=(     # s
                    Ref("A0", "A", addr_terms=((0, n * n), (1, n), (3, 1))),
                    Ref("C0", "C4", addr_terms=((3, n), (2, 1)), share_span=span),
                    *_accum("sum", ((2, 1),)),
                )),
            )),
            Loop(trip=n, body=(         # p write-back
                Ref("S4", "sum", addr_terms=((2, 1),)),
                Ref("A4", "A", addr_terms=((0, n * n), (1, n), (2, 1)),
                    is_write=True),
            )),
        )),
    ))
    return LoopNestSpec(
        name=f"doitgen{n}",
        arrays=(("sum", n), ("A", n * n * n), ("C4", n * n)),
        nests=(nest,),
    )


def jacobi2d(n: int = 64, tsteps: int = 2) -> LoopNestSpec:
    """jacobi2d: ``tsteps`` alternating 5-point sweeps A->B then B->A —
    the time-stepped multi-nest shape (per-thread LAT state and clocks
    persist across nests, as across the reference's sequential nests)."""
    m = n - 2
    span = share_span_formula(m)

    def sweep(src: str, dst: str, t: int) -> Loop:
        off = lambda di, dj: (di + 1) * n + (dj + 1)
        terms = ((0, n), (1, 1))
        body = [Ref(f"{src}c{t}", src, addr_terms=terms, addr_base=off(0, 0))]
        for nm, (di, dj) in (("mI", (-1, 0)), ("pI", (1, 0)),
                             ("mJ", (0, -1)), ("pJ", (0, 1))):
            body.append(Ref(f"{src}{nm}{t}", src, addr_terms=terms,
                            addr_base=off(di, dj),
                            share_span=span if di != 0 else None))
        # the store hits the SAME n-stride array the next sweep reads: write
        # dst[i+1][j+1] at its real interior address, not a compacted layout
        body.append(Ref(f"{dst}o{t}", dst,
                        addr_terms=((0, n), (1, 1)), addr_base=off(0, 0),
                        is_write=True))
        return Loop(trip=m, body=(Loop(trip=m, body=tuple(body)),))

    nests = []
    for t in range(tsteps):
        nests.append(sweep("A", "B", t))
        nests.append(sweep("B", "A", t))
    return LoopNestSpec(
        name=f"jacobi2d{n}x{tsteps}",
        arrays=(("A", n * n), ("B", n * n)),
        nests=tuple(nests),
    )


def gemver(n: int = 128) -> LoopNestSpec:
    """gemver: rank-2 update ``A += u1 v1^T + u2 v2^T``, then ``x += beta
    A^T y``, ``x += z``, ``w += alpha A x`` — four nests over one matrix."""
    span = share_span_formula(n)
    rank2 = Loop(trip=n, body=(
        Loop(trip=n, body=(
            Ref("A0", "A", addr_terms=((0, n), (1, 1))),
            Ref("U10", "u1", addr_terms=((0, 1),)),
            Ref("V10", "v1", addr_terms=((1, 1),), share_span=span),
            Ref("U20", "u2", addr_terms=((0, 1),)),
            Ref("V20", "v2", addr_terms=((1, 1),), share_span=span),
            Ref("A1", "A", addr_terms=((0, n), (1, 1)),
                is_write=True),
        )),
    ))
    xaty = Loop(trip=n, body=(
        Loop(trip=n, body=(
            Ref("A2", "A", addr_terms=((1, n), (0, 1))),
            Ref("Y0", "y", addr_terms=((1, 1),), share_span=span),
            Ref("X2", "x", addr_terms=((0, 1),)),
            Ref("X3", "x", addr_terms=((0, 1),), is_write=True),
        )),
    ))
    xz = Loop(trip=n, body=(
        Ref("X4", "x", addr_terms=((0, 1),)),
        Ref("Z0", "z", addr_terms=((0, 1),)),
        Ref("X5", "x", addr_terms=((0, 1),), is_write=True),
    ))
    wax = Loop(trip=n, body=(
        Loop(trip=n, body=(
            Ref("A3", "A", addr_terms=((0, n), (1, 1))),
            Ref("X6", "x", addr_terms=((1, 1),), share_span=span),
            *_accum("w", ((0, 1),)),
        )),
    ))
    return LoopNestSpec(
        name=f"gemver{n}",
        arrays=(("A", n * n), ("u1", n), ("v1", n), ("u2", n), ("v2", n),
                ("x", n), ("y", n), ("z", n), ("w", n)),
        nests=(rank2, xaty, xz, wax),
    )
