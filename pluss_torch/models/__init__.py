"""Workload specs of this slice: the rectangular PolyBench nests.

Each model function returns a :class:`pluss_torch.spec.LoopNestSpec`, equal
to the one the JAX package's function of the same name emits (the tests
carry the JAX specs across through the codec and compare).
"""

from pluss_torch.models.gemm import gemm
from pluss_torch.models.linalg import atax, bicg, gesummv, mvt
from pluss_torch.models.polybench import mm2, mm3, syrk

REGISTRY = {
    "gemm": gemm,
    "2mm": mm2,
    "3mm": mm3,
    "syrk": syrk,
    "atax": atax,
    "mvt": mvt,
    "bicg": bicg,
    "gesummv": gesummv,
}

__all__ = ["gemm", "mm2", "mm3", "syrk", "atax", "mvt", "bicg", "gesummv",
           "REGISTRY"]
