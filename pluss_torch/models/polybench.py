"""PolyBench matrix-product family (2mm, 3mm, syrk, syr2k) and the 4.2
triangular family (syrk_tri, trmm, symm, covariance, correlation).

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
    runs it through the interleave overlay (:mod:`pluss_torch.overlay`)
    in the clean windows and on the device sort path in the others.
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


def syr2k(n: int = 128) -> LoopNestSpec:
    """syr2k (rectangular): ``C = beta*C + alpha*(A*B^T + B*A^T)``.

    BOTH operand arrays carry the symmetric moving/sweeping ref pair
    (``A[i][k]``/``A[j][k]`` and ``B[i][k]``/``B[j][k]``): two
    mixed-coefficient arrays in one nest, both on the sort path.
    ``A1``/``B1`` are the cross-thread references (row index j does not
    involve the parallel iterator), like GEMM's B0
    (``src/gemm_sampler.rs:196-201``).
    """
    span = share_span_formula(n)
    c = lambda nm, w=False: Ref(nm, "C", addr_terms=((0, n), (1, 1)),
                                is_write=w)
    inner = Loop(
        trip=n,
        body=(
            Ref("A0", "A", addr_terms=((0, n), (2, 1))),
            Ref("B1", "B", addr_terms=((1, n), (2, 1)), share_span=span),
            Ref("B0", "B", addr_terms=((0, n), (2, 1))),
            Ref("A1", "A", addr_terms=((1, n), (2, 1)), share_span=span),
            c("C2"),
            c("C3", w=True),
        ),
    )
    nest = Loop(trip=n, body=(Loop(trip=n,
                                   body=(c("C0"), c("C1", w=True), inner)),))
    return LoopNestSpec(
        name=f"syr2k{n}",
        arrays=(("C", n * n), ("A", n * n), ("B", n * n)),
        nests=(nest,),
    )


def syrk_triangular(n: int = 128) -> LoopNestSpec:
    """syrk, PolyBench 4.2 triangular form: only ``j <= i`` is touched.

    Mirrors the 4.2 kernel statement-for-statement: per parallel iteration
    ``i``, a bounded j-loop scales ``C[i][j]``, then the k-loop re-walks the
    bounded j-loop accumulating ``alpha*A[i][k]*A[j][k]``.  Both j-loops
    carry ``bound_coef=(1, 1)`` (trip ``i+1`` at parallel index ``i``); the
    cross-thread reference is ``A1 = A[j][k]`` as in the rectangular form.
    """
    span = share_span_formula(n)
    c01 = Loop(trip=n, bound_coef=(1, 1), body=(
        Ref("C0", "C", addr_terms=((0, n), (1, 1))),
        Ref("C1", "C", addr_terms=((0, n), (1, 1)), is_write=True),
    ))
    accum = Loop(trip=n, body=(
        Loop(trip=n, bound_coef=(1, 1), body=(
            Ref("A0", "A", addr_terms=((0, n), (1, 1))),
            Ref("A1", "A", addr_terms=((2, n), (1, 1)), share_span=span),
            Ref("C2", "C", addr_terms=((0, n), (2, 1))),
            Ref("C3", "C", addr_terms=((0, n), (2, 1)), is_write=True),
        )),
    ))
    return LoopNestSpec(
        name=f"syrk_tri{n}",
        arrays=(("C", n * n), ("A", n * n)),
        nests=(Loop(trip=n, body=(c01, accum)),),
    )


def symm(n: int = 128) -> LoopNestSpec:
    """symm, PolyBench 4.2: ``C := alpha*A*B + beta*C`` with symmetric A.

    Per (i, j): the bounded k-loop (``k < i`` — ``bound_coef=(0, 1)``, zero
    trip at i=0) does ``C[k][j] += alpha*B[i][j]*A[i][k]`` (loads B, A,
    C[k][j]; store) and accumulates ``temp2 += B[k][j]*A[i][k]`` (loads B,
    A — temp2 is a register, not modeled, per the generated-sampler style
    that only walks array refs); then the tail statement loads
    ``B[i][j]``, ``A[i][i]`` (diagonal: one squared-index-free term
    ``i*(n+1)``), ``C[i][j]`` and stores ``C[i][j]``.
    ``B0 = B[k][j]`` is the cross-thread reference.
    """
    span = share_span_formula(n)
    kloop = Loop(
        trip=max(n - 1, 1), bound_coef=(0, 1),
        body=(
            Ref("B1", "B", addr_terms=((0, n), (1, 1))),
            Ref("A0", "A", addr_terms=((0, n), (2, 1))),
            # C[k][j] and B[k][j] have no parallel-iterator term: their
            # reuses cross simulated threads, so both carry the span
            # (module convention — the structural twins of GEMM's B0)
            Ref("C0", "C", addr_terms=((2, n), (1, 1)), share_span=span),
            Ref("C1", "C", addr_terms=((2, n), (1, 1)), share_span=span,
                is_write=True),
            Ref("B0", "B", addr_terms=((2, n), (1, 1)), share_span=span),
            Ref("A1", "A", addr_terms=((0, n), (2, 1))),
        ),
    )
    tail = (
        Ref("B2", "B", addr_terms=((0, n), (1, 1))),
        Ref("A2", "A", addr_terms=((0, n + 1),)),
        Ref("C2", "C", addr_terms=((0, n), (1, 1))),
        Ref("C3", "C", addr_terms=((0, n), (1, 1)), is_write=True),
    )
    nest = Loop(trip=n, body=(Loop(trip=n, body=(kloop,) + tail),))
    return LoopNestSpec(
        name=f"symm{n}",
        arrays=(("C", n * n), ("A", n * n), ("B", n * n)),
        nests=(nest,),
    )


def covariance(n: int = 128) -> LoopNestSpec:
    """covariance, PolyBench 4.2 (the cov kernel's triangular nest).

    ``for i: for (j = i; j < n; j++)`` — varying START and varying TRIP on
    the same loop (``start_coef=1``, ``bound_coef=(n, -1)``).  Per (i, j):
    zero-store ``cov[i][j]``; the k-loop accumulates
    ``data[k][i]*data[k][j]`` re-loading/storing ``cov[i][j]`` each step
    (generated-sampler style); then the two tail statements
    ``cov[i][j] /= (float_n - 1)`` (load + store) and
    ``cov[j][i] = cov[i][j]`` (load + symmetric store).
    ``D1 = data[k][j]`` carries the share span: column ``j`` recurs across
    parallel iterations (every ``i <= j`` revisits it), so its reuses cross
    simulated threads, while ``D0 = data[k][i]``'s column IS the parallel
    iterator — thread-private.
    """
    span = share_span_formula(n)
    cov_ij = lambda nm, w=False: Ref(nm, "cov", addr_terms=((0, n), (1, 1)),
                                     is_write=w)
    kloop = Loop(trip=n, body=(
        Ref("D0", "data", addr_terms=((2, n), (0, 1))),
        Ref("D1", "data", addr_terms=((2, n), (1, 1)), share_span=span),
        cov_ij("C1"),
        cov_ij("C2", w=True),
    ))
    jloop = Loop(
        trip=n, start_coef=1, bound_coef=(n, -1),
        body=(
            cov_ij("C0", w=True),                           # zero store
            kloop,
            cov_ij("C3"),                                   # /= load
            cov_ij("C4", w=True),                           # /= store
            cov_ij("C5"),                                   # symm load
            Ref("C6", "cov", addr_terms=((1, n), (0, 1)),
                is_write=True),                             # cov[j][i] store
        ),
    )
    return LoopNestSpec(
        name=f"covariance{n}",
        arrays=(("cov", n * n), ("data", n * n)),
        nests=(Loop(trip=n, body=(jloop,)),),
    )


def correlation(n: int = 128) -> LoopNestSpec:
    """correlation, PolyBench 4.2 (square ``data`` for one size parameter).

    Four parallel nests back-to-back — the longest nest chain in the model
    zoo, mixing rectangular and triangular shapes: (1) column means over
    ``data`` (parallel j, reduce over i; tail = the ``/= float_n``
    load+store), (2) column stddevs (same shape, re-reading ``mean``;
    tail = the ``/=``, ``sqrt`` and epsilon-clamp statements, each a
    load+store of ``stddev[j]``), (3) the normalization sweep (parallel i
    over rows: ``data[i][j] -= mean[j]`` then ``data[i][j] /= ...`` —
    BOTH statements' load/load/store triples), (4) the correlation
    triangle (parallel i, ``j = i+1 .. n-1`` via
    ``start_coef``/``bound_coef``, covariance-style accumulation with the
    symmetric store).  Statements are linearized generated-sampler style
    (loads precede the store); the only non-modeled access is the scalar
    epilogue ``corr[n-1][n-1] = 1``, which sits outside every parallel
    nest.  Share spans follow the module convention (refs with no
    parallel-iterator address term): nest 3's ``mean[j]``/``stddev[j]``
    and nest 4's ``D5 = data[k][j]``.
    """
    span = share_span_formula(n)

    def column_reduce(out: str, extra_inner: tuple, tail_pairs: int) -> Loop:
        """``out[j] = 0; for i: out[j] += f(data[i][j], ...)`` plus
        ``tail_pairs`` load+store tail statements on ``out[j]`` — the
        shared shape of the mean and stddev nests."""
        o = lambda k, w=False: Ref(f"{out}{k}", out, addr_terms=((0, 1),),
                                   is_write=w)
        inner = Loop(trip=n, body=(
            Ref(f"D_{out}", "data", addr_terms=((1, n), (0, 1))),
            *extra_inner, o("_a"), o("_b", w=True),
        ))
        tail = tuple(o(f"_t{i}", w=bool(i % 2))
                     for i in range(2 * tail_pairs))
        return Loop(trip=n, body=(o("_z", w=True), inner) + tail)

    n1 = column_reduce("mean", (), tail_pairs=1)
    n2 = column_reduce(
        "stddev", (Ref("M5", "mean", addr_terms=((0, 1),)),), tail_pairs=3)
    data_ij = lambda nm, w=False: Ref(nm, "data",
                                      addr_terms=((0, n), (1, 1)),
                                      is_write=w)
    n3 = Loop(trip=n, body=(
        Loop(trip=n, body=(
            data_ij("D2"),
            Ref("M6", "mean", addr_terms=((1, 1),), share_span=span),
            data_ij("D3", w=True),
            data_ij("D4"),
            Ref("S5", "stddev", addr_terms=((1, 1),), share_span=span),
            data_ij("D5n", w=True),
        )),
    ))
    corr_ij = lambda nm, w=False: Ref(nm, "corr",
                                      addr_terms=((0, n), (1, 1)),
                                      is_write=w)
    n4 = Loop(trip=max(n - 1, 1), body=(
        Ref("C0", "corr", addr_terms=((0, n + 1),),
            is_write=True),                             # corr[i][i] = 1
        Loop(
            trip=max(n - 1, 1), start=1, start_coef=1,
            bound_coef=(n - 1, -1),
            body=(
                corr_ij("C1", w=True),                  # corr[i][j] = 0
                Loop(trip=n, body=(
                    Ref("D4", "data", addr_terms=((2, n), (0, 1))),
                    Ref("D5", "data", addr_terms=((2, n), (1, 1)),
                        share_span=span),
                    corr_ij("C2"), corr_ij("C3", w=True),
                )),
                corr_ij("C4"),                          # symm load
                Ref("C5", "corr", addr_terms=((1, n), (0, 1)),
                    is_write=True),                     # store ji
            ),
        ),
    ))
    return LoopNestSpec(
        name=f"correlation{n}",
        arrays=(("data", n * n), ("mean", n), ("stddev", n),
                ("corr", n * n)),
        nests=(n1, n2, n3, n4),
    )


def trmm(n: int = 128) -> LoopNestSpec:
    """trmm, PolyBench 4.2: ``B := alpha*A*B`` with lower-triangular A.

    The inner k loop runs ``k in [i+1, n)`` — a varying START as well as a
    varying trip: ``start=1, start_coef=1, bound_coef=(n-1, -1)``
    (spec.Loop).  Per (i, j): the k-loop accumulates
    ``B[i][j] += A[k][i]*B[k][j]`` (loads A, B[k][j], B[i][j]; store), then
    ``B[i][j] *= alpha`` (load + store).  ``B0 = B[k][j]`` is the
    cross-thread reference (its address has no parallel-iterator term, like
    GEMM's B0).
    """
    span = share_span_formula(n)
    b_ij = lambda nm, w=False: Ref(nm, "B", addr_terms=((0, n), (1, 1)),
                                   is_write=w)
    kloop = Loop(
        trip=max(n - 1, 1), start=1, step=1,
        bound_coef=(n - 1, -1), start_coef=1,
        body=(
            Ref("A0", "A", addr_terms=((2, n), (0, 1))),
            Ref("B0", "B", addr_terms=((2, n), (1, 1)), share_span=span),
            b_ij("B1"),
            b_ij("B2", w=True),
        ),
    )
    nest = Loop(trip=n, body=(
        Loop(trip=n, body=(kloop, b_ij("B3"), b_ij("B4", w=True))),
    ))
    return LoopNestSpec(
        name=f"trmm{n}",
        arrays=(("A", n * n), ("B", n * n)),
        nests=(nest,),
    )
