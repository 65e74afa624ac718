"""The frontend's PolyBench corpus (the port's copy of
``pluss/frontend/polybench.py``): pragma-C sources for the families the
registry does NOT hand-transcribe, auto-imported in one sweep.

The registry covers 29 families; PolyBench's remaining affine kernels —
``jacobi1d``, ``adi``, ``deriche`` (4.2) and ``reg_detect``,
``fdtd_apml`` (3.x) — ship here as checked-in ``#pragma pluss
parallel`` C under ``pluss_torch/frontend/examples/`` (the port's own
copies of the JAX package's files; ``nussinov`` stays
out: its cross bounds are outside the engine's degree-2 position
contract by design).  :func:`import_polybench` derives all of them
through the frontend, gates each on the lint, and returns
engine-ready specs — the "registry becomes a test corpus" milestone:
new scenario coverage now enters as SOURCE, not as hand-folded
coefficient tables.

``tests/test_torch_frontend.py`` holds the sweep codec-equal to the JAX
package's and engine-runnable (histogram mass == stream length per
family).
"""

from __future__ import annotations

import os

EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "examples")

#: family -> checked-in pragma-C source (the NEW, untranscribed ones)
FAMILIES = {
    "jacobi1d": "jacobi1d.c",
    "adi": "adi.c",
    "deriche": "deriche.c",
    "reg_detect": "reg_detect.c",
    "fdtd_apml": "fdtd_apml.c",
}

#: the reference-shaped gemm source (the bit-identity gate's input —
#: not part of the "new families" sweep, the registry has gemm)
GEMM_PPCG = "gemm.ppcg_omp.c"


def source_path(family: str) -> str:
    fn = FAMILIES.get(family, family if family.endswith(".c")
                      else f"{family}.c")
    return os.path.join(EXAMPLES_DIR, fn)


def gemm_source_path() -> str:
    return os.path.join(EXAMPLES_DIR, GEMM_PPCG)


def import_polybench(cfg=None, families=None):
    """Derive + analyzer-gate every corpus family in one sweep.

    Returns ``{family: LoopNestSpec}``; any family whose source fails
    the frontend or the analyzer gate raises (typed), because a corpus
    that silently shrinks is a coverage regression, not a convenience.
    """
    from pluss_torch import frontend

    out = {}
    if families is None:
        families = sorted(FAMILIES)
    for family in families:
        pairs = frontend.import_path(source_path(family), cfg)
        (spec, _diags), = pairs   # one spec per C file, by construction
        out[family] = spec
    return out
