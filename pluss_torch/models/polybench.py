"""PolyBench matrix-product family: 2mm, 3mm and the rectangular syrk.

The outermost loop of every nest is the parallel dim, loads precede the
store of the same statement, and the accumulation statement re-loads and
re-stores its output element each k iteration (GEMM's C2/C3 pair).  Share
spans sit on exactly the refs whose row index does not involve the parallel
iterator.
"""

from __future__ import annotations

from pluss_torch.spec import Loop, LoopNestSpec, Ref, share_span_formula


def _matmul_nest(n: int, out: str, a: str, b: str, init_pair: bool) -> Loop:
    """One ``out = (init) ; out += a*b`` nest.

    ``init_pair``: True emits load+store (GEMM's ``*= beta`` C0/C1), False a
    single store (the ``= 0`` of 2mm/3mm's first nests).
    """
    span = share_span_formula(n)
    o = lambda nm, w=False: Ref(nm, out, addr_terms=((0, n), (1, 1)),
                                is_write=w)
    head = (o(f"{out}0"), o(f"{out}1", w=True)) if init_pair \
        else (o(f"{out}0", w=True),)
    inner = Loop(
        trip=n,
        body=(
            Ref(f"{a}0", a, addr_terms=((0, n), (2, 1))),
            Ref(f"{b}0", b, addr_terms=((2, n), (1, 1)), share_span=span),
            o(f"{out}2"),
            o(f"{out}3", w=True),
        ),
    )
    return Loop(trip=n, body=(Loop(trip=n, body=head + (inner,)),))


def mm2(n: int = 128) -> LoopNestSpec:
    """2mm: ``tmp = alpha*A*B`` then ``D = beta*D + tmp*C``."""
    return LoopNestSpec(
        name=f"2mm{n}",
        arrays=(("tmp", n * n), ("A", n * n), ("B", n * n), ("C", n * n),
                ("D", n * n)),
        nests=(
            _matmul_nest(n, "tmp", "A", "B", init_pair=False),
            _matmul_nest(n, "D", "tmp", "C", init_pair=True),
        ),
    )


def mm3(n: int = 128) -> LoopNestSpec:
    """3mm: ``E = A*B``, ``F = C*D``, ``G = E*F``."""
    return LoopNestSpec(
        name=f"3mm{n}",
        arrays=(
            ("E", n * n), ("A", n * n), ("B", n * n),
            ("F", n * n), ("C", n * n), ("D", n * n),
            ("G", n * n),
        ),
        nests=(
            _matmul_nest(n, "E", "A", "B", init_pair=False),
            _matmul_nest(n, "F", "C", "D", init_pair=False),
            _matmul_nest(n, "G", "E", "F", init_pair=False),
        ),
    )


def syrk(n: int = 128) -> LoopNestSpec:
    """syrk (rectangular): ``C = beta*C + alpha*A*A^T``.

    ``A1 = A[j][k]`` is the cross-thread reference.  ``A`` mixes two
    parallel-dim coefficients (``A[i][k]`` and ``A[j][k]``), so the port
    runs it on the device sort path in every window.
    """
    span = share_span_formula(n)
    c = lambda nm, w=False: Ref(nm, "C", addr_terms=((0, n), (1, 1)),
                                is_write=w)
    inner = Loop(
        trip=n,
        body=(
            Ref("A0", "A", addr_terms=((0, n), (2, 1))),
            Ref("A1", "A", addr_terms=((1, n), (2, 1)), share_span=span),
            c("C2"),
            c("C3", w=True),
        ),
    )
    nest = Loop(trip=n, body=(Loop(trip=n,
                                   body=(c("C0"), c("C1", w=True), inner)),))
    return LoopNestSpec(
        name=f"syrk{n}",
        arrays=(("C", n * n), ("A", n * n)),
        nests=(nest,),
    )
