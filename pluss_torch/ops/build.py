"""Build the port's CUDA kernel from ``pluss_torch/csrc`` at first use.

``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with ``ctypes``: a file
that does not include PyTorch's headers builds in seconds, where a PyTorch
extension takes minutes.  Libraries land in ``pluss_torch/_build/``
(git-ignored), named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused.  Nothing is built when a
module is imported; :func:`load` builds on the first launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on
    ``PATH``, else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    if home:
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + repr(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(name: str) -> list[str]:
    """Compile ``csrc/<name>.cu`` unless it is built already.  Returns the
    compiler's ``ptxas info`` lines (empty when nothing was compiled);
    raises ``RuntimeError`` with the compiler's output if the build fails."""
    lib = library_path(name)
    if os.path.exists(lib):
        return []
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.tmp{os.getpid()}"
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"kernel build failed: nvcc exited "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, lib)
    return [ln for ln in proc.stdout.splitlines() if "ptxas info" in ln]


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it first if
    needed."""
    build(name)
    return ctypes.CDLL(library_path(name))
