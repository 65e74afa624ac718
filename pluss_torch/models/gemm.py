"""PolyBench GEMM: ``C[i][j] = beta*C[i][j] + alpha*A[i][k]*B[k][j]``.

Reference order per (i, j): C0, C1, then per k: A0, B0, C2, C3 — the
generated sampler's state chain (``gemm_sampler.rs:135-266``).  Only B0
carries the cross-thread share test, with the generated threshold
``(trip+1)*trip + 1`` (16513 for trip=128).
"""

from __future__ import annotations

from pluss_torch.spec import Loop, LoopNestSpec, Ref, share_span_formula


def gemm(n: int = 128) -> LoopNestSpec:
    span = share_span_formula(n)
    # C0/C2 are the loads, C1/C3 the stores of the two C statements
    c0 = lambda name, w=False: Ref(name, "C", addr_terms=((0, n), (1, 1)),
                                   is_write=w)
    inner = Loop(
        trip=n,
        body=(
            Ref("A0", "A", addr_terms=((0, n), (2, 1))),
            Ref("B0", "B", addr_terms=((2, n), (1, 1)), share_span=span),
            c0("C2"),
            c0("C3", w=True),
        ),
    )
    nest = Loop(
        trip=n,
        body=(Loop(trip=n, body=(c0("C0"), c0("C1", w=True), inner)),),
    )
    return LoopNestSpec(
        name=f"gemm{n}",
        arrays=(("C", n * n), ("A", n * n), ("B", n * n)),
        nests=(nest,),
    )
