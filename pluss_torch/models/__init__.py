"""Workload specs: the 29 families of the JAX package's registry.

Each model function returns a :class:`pluss_torch.spec.LoopNestSpec`, equal
to the one the JAX package's function of the same name emits (the tests
carry the JAX specs across through the codec and compare).

New nests also enter as DSL or pragma-C source through ``cli import``
(:mod:`pluss_torch.frontend`); ``cli import --register`` (and ``cli
transform --register``) write them as codec-JSON files, and
:func:`register_spec_dir` folds such a directory back into ``REGISTRY``.
Point ``PLUSS_SPEC_DIR`` at it and every entry point (the CLI's
``--model`` and positional models) sees the imported specs as models.
File-registered specs are fixed-size (the size is baked into the source
they were derived from); their builders accept and ignore ``n``.
"""

import os
import sys

from pluss_torch.models.gemm import gemm
from pluss_torch.models.linalg import (atax, bicg, doitgen, gemver, gesummv,
                                       jacobi2d, mvt)
from pluss_torch.models.polybench import (correlation, covariance, mm2, mm3,
                                          symm, syr2k, syrk, syrk_triangular,
                                          trmm)
from pluss_torch.models.solvers import (cholesky, durbin, floyd_warshall,
                                        gramschmidt, lu, ludcmp, seidel2d,
                                        trisolv)
from pluss_torch.models.stencils import conv2d, fdtd2d, heat3d, stencil3d

REGISTRY = {
    "gemm": gemm,
    "2mm": mm2,
    "3mm": mm3,
    "syrk": syrk,
    "syr2k": syr2k,
    "syrk_tri": syrk_triangular,
    "trmm": trmm,
    "symm": symm,
    "covariance": covariance,
    "correlation": correlation,
    "conv2d": conv2d,
    "stencil3d": stencil3d,
    "atax": atax,
    "mvt": mvt,
    "bicg": bicg,
    "gesummv": gesummv,
    "doitgen": doitgen,
    "jacobi2d": jacobi2d,
    "gemver": gemver,
    "fdtd2d": fdtd2d,
    "heat3d": heat3d,
    "trisolv": trisolv,
    "durbin": durbin,
    "gramschmidt": gramschmidt,
    "floyd_warshall": floyd_warshall,
    "cholesky": cholesky,
    "lu": lu,
    "ludcmp": ludcmp,
    "seidel2d": seidel2d,
}



def register_spec_dir(path: str, registry: dict | None = None) -> list[str]:
    """Fold codec-JSON spec files (``cli import --register``) into the
    registry.  Returns the names added; files that fail the codec are
    skipped with a stderr notice (a broken file must not take down every
    entry point's import), and hand-written builders are never shadowed.
    """
    from pluss_torch.spec_codec import load_spec_file

    reg = REGISTRY if registry is None else registry
    added: list[str] = []
    try:
        entries = sorted(os.listdir(path))
    except OSError as e:
        print(f"pluss_torch.models: cannot read PLUSS_SPEC_DIR {path}: {e}",
              file=sys.stderr)
        return added
    for fn in entries:
        if not fn.endswith(".json"):
            continue
        full = os.path.join(path, fn)
        try:
            spec = load_spec_file(full)
        except Exception as e:  # noqa: BLE001 — typed InvalidRequest or IO
            print(f"pluss_torch.models: skipping {full}: {e}", file=sys.stderr)
            continue
        if spec.name in reg:
            print(f"pluss_torch.models: {full}: name {spec.name!r} already "
                  "registered; not shadowing", file=sys.stderr)
            continue
        reg[spec.name] = _fixed_size_builder(spec)
        added.append(spec.name)
    return added


def _fixed_size_builder(spec):
    """Builder for a file-registered spec: fixed-size.  A caller-supplied
    ``n`` is accepted (the CLI always passes one) but NOTICED on stderr
    once per spec, so a request for another size is never silently
    answered at the baked one."""
    warned = []

    def build(n=None):
        if n is not None and not warned:
            warned.append(True)
            print(f"pluss_torch.models: {spec.name!r} is a file-registered "
                  f"fixed-size spec; ignoring n={n} (re-import the "
                  "source at another size to change it)",
                  file=sys.stderr)
        return spec

    return build


if os.environ.get("PLUSS_SPEC_DIR"):
    register_spec_dir(os.environ["PLUSS_SPEC_DIR"])


__all__ = [
    "gemm", "mm2", "mm3", "syrk", "syr2k", "conv2d", "stencil3d",
    "atax", "mvt", "bicg", "gesummv", "doitgen", "jacobi2d",
    "gemver", "fdtd2d", "heat3d", "syrk_triangular", "trmm", "symm",
    "covariance", "correlation", "trisolv", "durbin", "gramschmidt",
    "floyd_warshall", "cholesky", "lu", "ludcmp", "seidel2d",
    "REGISTRY", "register_spec_dir",
]
