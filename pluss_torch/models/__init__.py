"""Workload specs: the 29 families of the JAX package's registry.

Each model function returns a :class:`pluss_torch.spec.LoopNestSpec`, equal
to the one the JAX package's function of the same name emits (the tests
carry the JAX specs across through the codec and compare).
"""

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

__all__ = [
    "gemm", "mm2", "mm3", "syrk", "syr2k", "conv2d", "stencil3d",
    "atax", "mvt", "bicg", "gesummv", "doitgen", "jacobi2d",
    "gemver", "fdtd2d", "heat3d", "syrk_triangular", "trmm", "symm",
    "covariance", "correlation", "trisolv", "durbin", "gramschmidt",
    "floyd_warshall", "cholesky", "lu", "ludcmp", "seidel2d",
    "REGISTRY",
]
