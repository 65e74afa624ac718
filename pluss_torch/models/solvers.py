"""PolyBench 4.2 solver/medley specs: trisolv, durbin, gramschmidt,
floyd_warshall.

Authored in the same ppcg/pluss generated-sampler style as
``c_lib/test/gemm.ppcg_omp.c:72-98`` (outermost loop =
the parallel dim, loads precede the store of the same statement, an
accumulation statement re-loads and re-stores its output element every
step, scalars live in registers and are not walked — the convention the
generated GEMM sampler encodes at ``…omp.cpp:214-300``).

These four cover the remaining PolyBench kernels expressible under the
spec language's affine contract (``pluss_torch.spec.Loop``: inner bounds and
starts affine in the parallel index, bounded loops not nested inside
each other).  Each stresses a distinct corner of the engine:

- ``trisolv``: the canonical triangular solve — one bounded inner loop
  plus rectangular tail refs after it (nonzero ``offset_k`` on the tail).
- ``durbin``: NEGATIVE address coefficients (``r[k-i-1]``/``y[k-i-1]``
  walk arrays backwards; ``addr_base=-1``) and three sibling bounded
  loops with refs between them.
- ``gramschmidt``: rectangular i-loops nested inside the bounded
  ``j in [k+1, n)`` loop (``start_coef=1`` with ``bound_coef=(n-1,-1)``),
  plus diagonal refs ``R[k][k]``.
- ``floyd_warshall``: ONE array under three access patterns, one of them
  parallel-invariant (``path[i][j]`` has no ``k`` term — every simulated
  thread re-touches the same address set each iteration).

``cholesky`` and ``lu`` are DOUBLY-triangular: their per-iteration access
counts are quadratic in the parallel index (cholesky's ``k < j < i``
chains two bounds; lu multiplies two parallel-bounded trips).  They ride
the quad position contract (``Loop.bound_level`` +
``pluss_torch.spec.flatten_nest_quad``: exact degree-2 closed-form stream
positions via ``tri(x) = x*(x-1)/2`` terms).  Triply-triangular shapes
(nussinov's ``k in (i, j)`` cross-bounds) stay out of contract.
"""

from __future__ import annotations

from pluss_torch.spec import Loop, LoopNestSpec, Ref, share_span_formula


def trisolv(n: int = 128) -> LoopNestSpec:
    """trisolv: ``x = L^-1 b`` by forward substitution.

    Per parallel iteration ``i``: ``x[i] = b[i]`` (load b, store x); the
    bounded ``j < i`` loop does ``x[i] -= L[i][j]*x[j]`` (loads L, x[j],
    x[i]; store x[i]); then ``x[i] /= L[i][i]`` (loads x[i], L[i][i];
    store x[i]).  ``x[j]`` is the cross-thread reference: every later
    parallel iteration re-reads the prefix ``x[0..i)``.
    """
    span = share_span_formula(n)
    x_i = lambda nm, w=False: Ref(nm, "x", addr_terms=((0, 1),),
                                  is_write=w)
    jloop = Loop(trip=max(n - 1, 1), bound_coef=(0, 1), body=(
        Ref("L0", "L", addr_terms=((0, n), (1, 1))),
        Ref("X1", "x", addr_terms=((1, 1),), share_span=span),
        x_i("X2"),
        x_i("X3", w=True),
    ))
    nest = Loop(trip=n, body=(
        Ref("B0", "b", addr_terms=((0, 1),)),
        x_i("X0", w=True),
        jloop,
        x_i("X4"),
        Ref("L1", "L", addr_terms=((0, n + 1),)),      # diagonal L[i][i]
        x_i("X5", w=True),
    ))
    return LoopNestSpec(
        name=f"trisolv{n}",
        arrays=(("x", n), ("L", n * n), ("b", n)),
        nests=(nest,),
    )


def durbin(n: int = 128) -> LoopNestSpec:
    """durbin: Levinson-Durbin recursion on a Toeplitz system.

    Parallel loop ``k in [1, n)`` (start=1, trip n-1); all three inner
    loops run ``i < k`` (``bound_coef=(1, 1)``).  Per k: the sum loop
    loads ``r[k-i-1]`` (addr ``k - i - 1``: terms ``((0,1),(1,-1))``,
    base −1 — a backwards walk) and ``y[i]``; then ``r[k]`` (the alpha
    statement); the z-loop loads ``y[i]``, ``y[k-i-1]`` and stores
    ``z[i]``; the copy loop loads ``z[i]`` and stores ``y[i]``; finally
    ``y[k]`` is stored.  Every prefix-indexed ref (y, z, and the
    backwards r walk) recurs across parallel iterations — all carry the
    share span; ``r[k]``/``y[k]`` ride the parallel iterator and stay
    thread-private.  Scalars (alpha, beta, sum) are registers.
    """
    span = share_span_formula(n)
    back = lambda nm, arr: Ref(nm, arr, addr_terms=((0, 1), (1, -1)),
                               addr_base=-1, share_span=span)
    sum_loop = Loop(trip=max(n - 1, 1), bound_coef=(1, 1), body=(
        back("R0", "r"),
        Ref("Y0", "y", addr_terms=((1, 1),), share_span=span),
    ))
    z_loop = Loop(trip=max(n - 1, 1), bound_coef=(1, 1), body=(
        Ref("Y1", "y", addr_terms=((1, 1),), share_span=span),
        back("Y2", "y"),
        Ref("Z0", "z", addr_terms=((1, 1),), share_span=span,
            is_write=True),
    ))
    copy_loop = Loop(trip=max(n - 1, 1), bound_coef=(1, 1), body=(
        Ref("Z1", "z", addr_terms=((1, 1),), share_span=span),
        Ref("Y3", "y", addr_terms=((1, 1),), share_span=span,
            is_write=True),
    ))
    nest = Loop(trip=n - 1, start=1, body=(
        sum_loop,
        Ref("R1", "r", addr_terms=((0, 1),)),
        z_loop,
        copy_loop,
        Ref("Y4", "y", addr_terms=((0, 1),), is_write=True),
    ))
    return LoopNestSpec(
        name=f"durbin{n}",
        arrays=(("y", n), ("z", n), ("r", n)),
        nests=(nest,),
    )


def gramschmidt(n: int = 128) -> LoopNestSpec:
    """gramschmidt: QR by modified Gram-Schmidt (square m = n).

    Per parallel iteration ``k``: the norm loop loads ``A[i][k]`` twice
    (the two operand occurrences of ``A[i][k]*A[i][k]``); ``R[k][k]`` is
    stored; the Q loop loads ``A[i][k]``, ``R[k][k]`` and stores
    ``Q[i][k]``; then ``j in [k+1, n)`` (``start_coef=1``,
    ``bound_coef=(n-1,-1)``) runs two rectangular i-loops: the projection
    (``R[k][j] += Q[i][k]*A[i][j]`` — zero-store, then load Q, load A,
    load+store R) and the update (``A[i][j] -= Q[i][k]*R[k][j]`` — load
    A, load Q, load R, store A).  Column ``j > k`` of A is re-read AND
    re-written by every earlier parallel iteration, and column ``k`` was
    written as some earlier iteration's ``j`` — so all A refs carry the
    share span; Q and R columns/rows ride the parallel iterator.
    """
    span = share_span_formula(n)
    a_ik = lambda nm: Ref(nm, "A", addr_terms=((1, n), (0, 1)),
                          share_span=span)
    r_kk = lambda nm, w=False: Ref(nm, "R", addr_terms=((0, n + 1),),
                                   is_write=w)
    norm_loop = Loop(trip=n, body=(a_ik("A0"), a_ik("A1")))
    q_loop = Loop(trip=n, body=(
        a_ik("A2"),
        r_kk("R1"),
        Ref("Q0", "Q", addr_terms=((1, n), (0, 1)), is_write=True),
    ))
    q_ik = lambda nm: Ref(nm, "Q", addr_terms=((2, n), (0, 1)))
    r_kj = lambda nm, w=False: Ref(nm, "R", addr_terms=((0, n), (1, 1)),
                                   is_write=w)
    a_ij = lambda nm, w=False: Ref(nm, "A", addr_terms=((2, n), (1, 1)),
                               share_span=span, is_write=w)
    proj_loop = Loop(trip=n, body=(
        q_ik("Q1"), a_ij("A3"), r_kj("R3"), r_kj("R4", w=True),
    ))
    update_loop = Loop(trip=n, body=(
        a_ij("A4"), q_ik("Q2"), r_kj("R5"), a_ij("A5", w=True),
    ))
    jloop = Loop(
        trip=max(n - 1, 1), start=1, start_coef=1, bound_coef=(n - 1, -1),
        body=(r_kj("R2", w=True), proj_loop, update_loop),
    )
    nest = Loop(trip=n, body=(norm_loop, r_kk("R0", w=True), q_loop,
                              jloop))
    return LoopNestSpec(
        name=f"gramschmidt{n}",
        arrays=(("A", n * n), ("R", n * n), ("Q", n * n)),
        nests=(nest,),
    )


def cholesky(n: int = 128) -> LoopNestSpec:
    """cholesky, PolyBench 4.2: in-place ``A = L*L^T`` factor (lower part).

    Per parallel iteration ``i``: the ``j < i`` loop (bound (0,1) on the
    parallel level) runs the DOUBLY-bounded ``k < j`` loop
    (``bound_coef=(0, 1), bound_level=1``) doing ``A[i][j] -=
    A[i][k]*A[j][k]`` (loads A_ik, A_jk, A_ij; store A_ij), then
    ``A[i][j] /= A[j][j]`` (loads A_ij, A_jj; store); the second ``k < i``
    loop accumulates ``A[i][i] -= A[i][k]^2`` (two operand loads, load
    A_ii, store); finally ``A[i][i] = sqrt(A[i][i])`` (load + store).
    Rows ``j``/``k`` below ``i`` recur across parallel iterations —
    ``A[j][k]`` and ``A[j][j]`` carry the share span; row-``i`` refs are
    thread-private.
    """
    span = share_span_formula(n)
    a_ij = lambda nm, w=False: Ref(nm, "A", addr_terms=((0, n), (1, 1)),
                                   is_write=w)
    a_ii = lambda nm, w=False: Ref(nm, "A", addr_terms=((0, n + 1),),
                                   is_write=w)
    kloop = Loop(trip=max(n - 1, 1), bound_coef=(0, 1), bound_level=1,
                 body=(
        Ref("A0", "A", addr_terms=((0, n), (2, 1))),
        Ref("A1", "A", addr_terms=((1, n), (2, 1)), share_span=span),
        a_ij("A2"),
        a_ij("A3", w=True),
    ))
    jloop = Loop(trip=max(n - 1, 1), bound_coef=(0, 1), body=(
        kloop,
        a_ij("A4"),
        Ref("A5", "A", addr_terms=((1, n + 1),), share_span=span),
        a_ij("A6", w=True),
    ))
    k2loop = Loop(trip=max(n - 1, 1), bound_coef=(0, 1), body=(
        Ref("A7", "A", addr_terms=((0, n), (1, 1))),
        Ref("A8", "A", addr_terms=((0, n), (1, 1))),
        a_ii("A9"),
        a_ii("A10", w=True),
    ))
    nest = Loop(trip=n, body=(jloop, k2loop, a_ii("A11"),
                              a_ii("A12", w=True)))
    return LoopNestSpec(
        name=f"cholesky{n}",
        arrays=(("A", n * n),),
        nests=(nest,),
    )


def lu(n: int = 128) -> LoopNestSpec:
    """lu, PolyBench 4.2: in-place LU decomposition.

    Per parallel iteration ``i``: the ``j < i`` part mirrors cholesky's
    but multiplies ``A[i][k]*A[k][j]`` (column walk) and divides by the
    pivot ``A[j][j]``; the second part runs ``j in [i, n)``
    (``start_coef=1, bound_coef=(n, -1)`` — varying start AND trip) whose
    body is the ``k < i`` loop doing ``A[i][j] -= A[i][k]*A[k][j]`` — two
    parallel-bounded loops NESTED (trip product ``(n-i)*i``), the other
    quadratic shape.  ``A[k][j]``/``A[j][j]`` rows sit below ``i`` and
    carry the share span.
    """
    span = share_span_formula(n)
    a_ij = lambda nm, w=False: Ref(nm, "A", addr_terms=((0, n), (1, 1)),
                                   is_write=w)
    a_kj = lambda nm: Ref(nm, "A", addr_terms=((2, n), (1, 1)),
                          share_span=span)
    kloop = Loop(trip=max(n - 1, 1), bound_coef=(0, 1), bound_level=1,
                 body=(
        Ref("A0", "A", addr_terms=((0, n), (2, 1))),
        a_kj("A1"),
        a_ij("A2"),
        a_ij("A3", w=True),
    ))
    jloop = Loop(trip=max(n - 1, 1), bound_coef=(0, 1), body=(
        kloop,
        a_ij("A4"),
        Ref("A5", "A", addr_terms=((1, n + 1),), share_span=span),
        a_ij("A6", w=True),
    ))
    k2loop = Loop(trip=max(n - 1, 1), bound_coef=(0, 1), body=(
        Ref("A7", "A", addr_terms=((0, n), (2, 1))),
        a_kj("A8"),
        a_ij("A9"),
        a_ij("A10", w=True),
    ))
    j2loop = Loop(trip=n, start_coef=1, bound_coef=(n, -1), body=(k2loop,))
    nest = Loop(trip=n, body=(jloop, j2loop))
    return LoopNestSpec(
        name=f"lu{n}",
        arrays=(("A", n * n),),
        nests=(nest,),
    )


def ludcmp(n: int = 128) -> LoopNestSpec:
    """ludcmp, PolyBench 4.2: LU factor + forward/back substitution.

    Three nests in one spec — the integration stress case (per-thread LAT
    tables and clocks persist across nests, as across the reference's
    sequential nests):

    1. the LU nest (identical structure to :func:`lu` — quad contract);
    2. forward substitution ``L y = b``: per i, load ``b[i]``; the
       ``j < i`` loop loads ``A[i][j]``, ``y[j]`` (cross-thread) and
       re-walks the running sum in a register; store ``y[i]``;
    3. back substitution ``U x = y`` with a DESCENDING parallel loop
       (``i = n-1 .. 0``: start n-1, step -1): load ``y[i]``; the
       ``j in [i+1, n)`` loop loads ``A[i][j]`` and ``x[j]``
       (cross-thread); then ``A[i][i]`` and the ``x[i]`` store.  With the
       parallel INDEX k (i = n-1-k), the j loop is start=n, start_coef=-1,
       trip = a + b*k with (a, b) = (0, 1).
    """
    span = share_span_formula(n)
    # nest 1 IS lu's nest (frozen dataclasses — safely shared); any fix to
    # the LU spec lands in both models by construction
    lu_nest = lu(n).nests[0]

    fwd_j = Loop(trip=max(n - 1, 1), bound_coef=(0, 1), body=(
        Ref("F0", "A", addr_terms=((0, n), (1, 1))),
        Ref("F1", "y", addr_terms=((1, 1),), share_span=span),
    ))
    fwd = Loop(trip=n, body=(
        Ref("B0", "b", addr_terms=((0, 1),)),
        fwd_j,
        Ref("Y0", "y", addr_terms=((0, 1),), is_write=True),
    ))

    back_j = Loop(trip=max(n - 1, 1), start=n, start_coef=-1,
                  bound_coef=(0, 1), body=(
        Ref("U0", "A", addr_terms=((0, n), (1, 1))),
        Ref("X0", "x", addr_terms=((1, 1),), share_span=span),
    ))
    back = Loop(trip=n, start=n - 1, step=-1, body=(
        Ref("Y1", "y", addr_terms=((0, 1),)),
        back_j,
        Ref("U1", "A", addr_terms=((0, n + 1),)),
        Ref("X1", "x", addr_terms=((0, 1),), is_write=True),
    ))
    return LoopNestSpec(
        name=f"ludcmp{n}",
        arrays=(("A", n * n), ("b", n), ("y", n), ("x", n)),
        nests=(lu_nest, fwd, back),
    )


def seidel2d(n: int = 64, tsteps: int = 8) -> LoopNestSpec:
    """seidel2d, PolyBench 4.2: in-place 9-point Gauss-Seidel sweeps.

    The parallel loop is the OUTER time loop (the ppcg pragma convention,
    ``c_lib/test/gemm.ppcg_omp.c:90``): every simulated
    thread revisits the identical address set each time step, so ALL nine
    loads and the store are parallel-invariant (floyd_warshall has one
    such pattern among three; here it is the whole nest) and all carry
    the share span.
    """
    m = n - 2
    span = share_span_formula(m)
    off = lambda di, dj: (di + 1) * n + (dj + 1)
    body = []
    for nm, (di, dj) in (("mm", (-1, -1)), ("mc", (-1, 0)), ("mp", (-1, 1)),
                         ("cm", (0, -1)), ("cc", (0, 0)), ("cp", (0, 1)),
                         ("pm", (1, -1)), ("pc", (1, 0)), ("pp", (1, 1))):
        body.append(Ref(f"A{nm}", "A", addr_terms=((1, n), (2, 1)),
                        addr_base=off(di, dj), share_span=span))
    body.append(Ref("Ao", "A", addr_terms=((1, n), (2, 1)),
                    addr_base=off(0, 0), share_span=span, is_write=True))
    nest = Loop(trip=tsteps, body=(
        Loop(trip=m, body=(Loop(trip=m, body=tuple(body)),)),
    ))
    return LoopNestSpec(
        name=f"seidel2d{n}x{tsteps}",
        arrays=(("A", n * n),),
        nests=(nest,),
    )


def floyd_warshall(n: int = 128) -> LoopNestSpec:
    """floyd_warshall: all-pairs shortest paths; parallel over ``k``.

    Per (k, i, j): ``path[i][j] = min(path[i][j], path[i][k]+path[k][j])``
    — loads path[i][j], path[i][k], path[k][j], stores path[i][j].  One
    array, three patterns: ``path[i][j]`` is PARALLEL-INVARIANT (no k
    term — every simulated thread revisits the identical address set),
    ``path[k][j]`` rides row k, and ``path[i][k]`` walks column k (which
    earlier iterations wrote as their ``j = k``).  Every ref's reuses can
    cross threads, so all four carry the share span and the per-reuse
    distance test classifies them individually.
    """
    span = share_span_formula(n)
    p_ij = lambda nm, w=False: Ref(nm, "path", addr_terms=((1, n), (2, 1)),
                               share_span=span, is_write=w)
    inner = Loop(trip=n, body=(
        p_ij("P0"),
        Ref("P1", "path", addr_terms=((1, n), (0, 1)), share_span=span),
        Ref("P2", "path", addr_terms=((0, n), (2, 1)), share_span=span),
        p_ij("P3", w=True),
    ))
    nest = Loop(trip=n, body=(Loop(trip=n, body=(inner,)),))
    return LoopNestSpec(
        name=f"floyd_warshall{n}",
        arrays=(("path", n * n),),
        nests=(nest,),
    )
