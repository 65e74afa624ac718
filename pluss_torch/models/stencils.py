"""Conv2d 3x3 and 7-point stencil-3D iteration spaces (BASELINE.json config 4).

Non-GEMM affine nests exercising multi-term addresses with constant bases
(neighbor offsets).  Authored in the reference's generated-sampler style (see
``pluss_torch.models.polybench``); the reference itself has no such kernels,
so the share-span choice is ours: refs whose address depends on the parallel
iterator *plus a nonzero offset* (halo rows/planes) reach across chunk
boundaries, so they carry the cross-thread test with the generated formula
``(trip+1)*trip+1`` of the loop just below the parallel one.
"""

from __future__ import annotations

from pluss_torch.spec import Loop, LoopNestSpec, Ref, share_span_formula


def conv2d(n: int = 128) -> LoopNestSpec:
    """3x3 convolution: ``out[i][j] = sum_{di,dj} W[di][dj] * in[i+di][j+dj]``.

    ``in`` is n x n, ``out`` is (n-2) x (n-2), W is 3x3.  Per (i,j): 9
    interleaved (W load, in load) pairs then the out store.
    """
    m = n - 2
    span = share_span_formula(m)
    body = []
    for di in range(3):
        for dj in range(3):
            body.append(Ref(f"W{di}{dj}", "W", addr_terms=(), addr_base=di * 3 + dj))
            body.append(
                Ref(
                    f"I{di}{dj}",
                    "in",
                    addr_terms=((0, n), (1, 1)),
                    addr_base=di * n + dj,
                    share_span=span if di != 0 else None,
                )
            )
    body.append(Ref("O0", "out", addr_terms=((0, m), (1, 1)),
                    is_write=True))
    nest = Loop(trip=m, body=(Loop(trip=m, body=tuple(body)),))
    return LoopNestSpec(
        name=f"conv2d{n}",
        arrays=(("out", m * m), ("in", n * n), ("W", 9)),
        nests=(nest,),
    )


def stencil3d(n: int = 32) -> LoopNestSpec:
    """7-point 3D stencil: center + 6 face neighbors, parallel over i planes.

    ``in``/``out`` are n^3; interior (n-2)^3 is updated.  Neighbor loads are
    emitted center-first then -i,+i,-j,+j,-k,+k, followed by the out store.
    The +/-i plane neighbors carry the cross-thread span.
    """
    m = n - 2
    span = share_span_formula(m)
    off = lambda di, dj, dk: (di + 1) * n * n + (dj + 1) * n + (dk + 1)
    terms = ((0, n * n), (1, n), (2, 1))
    body = [Ref("S000", "in", addr_terms=terms, addr_base=off(0, 0, 0))]
    for name, (di, dj, dk) in (
        ("SmI", (-1, 0, 0)), ("SpI", (1, 0, 0)),
        ("SmJ", (0, -1, 0)), ("SpJ", (0, 1, 0)),
        ("SmK", (0, 0, -1)), ("SpK", (0, 0, 1)),
    ):
        body.append(
            Ref(
                name,
                "in",
                addr_terms=terms,
                addr_base=off(di, dj, dk),
                share_span=span if di != 0 else None,
            )
        )
    body.append(
        Ref("O0", "out", addr_terms=((0, m * m), (1, m), (2, 1)),
            is_write=True)
    )
    nest = Loop(
        trip=m,
        body=(Loop(trip=m, body=(Loop(trip=m, body=tuple(body)),)),),
    )
    return LoopNestSpec(
        name=f"stencil3d{n}",
        arrays=(("out", m * m * m), ("in", n * n * n)),
        nests=(nest,),
    )


def fdtd2d(n: int = 64, tsteps: int = 2) -> LoopNestSpec:
    """fdtd-2d: per timestep, three interleaved sweeps over ey/ex/hz —
    time-stepped multi-nest with halo reads (ppcg-style rectangular interior;
    the boundary row/col updates of PolyBench's first loop are folded into
    the interior sweeps for rectangularity).

    The interior is ``m = n - 2`` per dimension: sweeps are centered at
    ``(i+1, j+1)`` and the hz sweep reads the ``+1`` neighbors
    (``ex[i][j+1]``, ``ey[i+1][j]``), so an ``n - 1`` interior would walk
    one full row/column past the ``n x n`` arrays — the spec analyzer's
    bounds prover (``pluss lint``, PL101) rejects exactly that shape."""
    m = n - 2
    span = share_span_formula(m)
    terms = ((0, n), (1, 1))
    off = lambda di, dj: (di + 1) * n + (dj + 1)

    def sweep(dst, srcs, t):
        body = []
        for nm, arr, (di, dj) in srcs:
            body.append(Ref(f"{nm}{t}", arr, addr_terms=terms,
                            addr_base=off(di, dj),
                            share_span=span if di != 0 else None))
        body.append(Ref(f"{dst}s{t}", dst, addr_terms=terms,
                        addr_base=off(0, 0), is_write=True))
        return Loop(trip=m, body=(Loop(trip=m, body=tuple(body)),))

    nests = []
    for t in range(tsteps):
        nests.append(sweep("ey", (("eyc", "ey", (0, 0)),
                                  ("hzm", "hz", (-1, 0))), t))
        nests.append(sweep("ex", (("exc", "ex", (0, 0)),
                                  ("hzj", "hz", (0, -1))), t))
        nests.append(sweep("hz", (("hzc", "hz", (0, 0)),
                                  ("exn", "ex", (0, 1)),
                                  ("eyn", "ey", (1, 0))), t))
    return LoopNestSpec(
        name=f"fdtd2d{n}x{tsteps}",
        arrays=(("ey", n * n), ("ex", n * n), ("hz", n * n)),
        nests=tuple(nests),
    )


def heat3d(n: int = 24, tsteps: int = 2) -> LoopNestSpec:
    """heat-3d: alternating 7-point sweeps A->B then B->A per timestep."""
    m = n - 2
    span = share_span_formula(m)
    terms = ((0, n * n), (1, n), (2, 1))
    off = lambda di, dj, dk: (di + 1) * n * n + (dj + 1) * n + (dk + 1)

    def sweep(src, dst, t):
        body = [Ref(f"{src}c{t}", src, addr_terms=terms,
                    addr_base=off(0, 0, 0))]
        for nm, d in (("mI", (-1, 0, 0)), ("pI", (1, 0, 0)),
                      ("mJ", (0, -1, 0)), ("pJ", (0, 1, 0)),
                      ("mK", (0, 0, -1)), ("pK", (0, 0, 1))):
            body.append(Ref(f"{src}{nm}{t}", src, addr_terms=terms,
                            addr_base=off(*d),
                            share_span=span if d[0] != 0 else None))
        body.append(Ref(f"{dst}o{t}", dst, addr_terms=terms,
                        addr_base=off(0, 0, 0), is_write=True))
        return Loop(trip=m, body=(
            Loop(trip=m, body=(Loop(trip=m, body=tuple(body)),)),
        ))

    nests = []
    for t in range(tsteps):
        nests.append(sweep("A", "B", t))
        nests.append(sweep("B", "A", t))
    return LoopNestSpec(
        name=f"heat3d{n}x{tsteps}",
        arrays=(("A", n * n * n), ("B", n * n * n)),
        nests=tuple(nests),
    )
