"""Build the port's native code from ``pluss_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, loaded with ``ctypes``: a file
that does not include PyTorch's headers builds in seconds, where a PyTorch
extension takes minutes.  Each ``csrc/<name>.cpp`` (host code: the trace
feed's line mapper) compiles the same way with the host C++ compiler.
Libraries land in ``pluss_torch/_build/`` (git-ignored), named by a hash
of the source, the shared headers (``csrc/*.cuh``, for CUDA sources) and
the flags, so an edited source rebuilds and an unchanged one is reused.
Nothing is built when a module is imported; :func:`load` builds on the
first use, and :func:`build` compiles several sources at once, one
compiler each, all started together.  A failed build raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on
    ``PATH``, else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    if home:
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def cxx() -> str:
    """Path of the host C++ compiler (``c++`` on ``PATH``)."""
    return shutil.which("c++") or "c++"


def _source(name: str) -> str:
    """``csrc/<name>.cu`` or, for host code, ``csrc/<name>.cpp``."""
    cu = os.path.join(CSRC, f"{name}.cu")
    return cu if os.path.exists(cu) else os.path.join(CSRC, f"{name}.cpp")


def _command(name: str, out: str) -> list[str]:
    src = _source(name)
    if src.endswith(".cu"):
        return [nvcc(), *NVCC_FLAGS, "-o", out, src]
    return [cxx(), *CXX_FLAGS, "-o", out, src]


def library_path(name: str) -> str:
    src = _source(name)
    cuda = src.endswith(".cu")
    digest = hashlib.sha256(repr(NVCC_FLAGS if cuda else CXX_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh")) \
        if cuda else []
    for f in [os.path.basename(src), *headers]:
        with open(os.path.join(CSRC, f), "rb") as fh:
            digest.update(f.encode() + fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(*names: str) -> dict[str, dict]:
    """Compile each ``csrc/<name>.cu`` or ``.cpp`` that is not built
    already, one compiler process per source, all started together.
    Returns, per name, the seconds from the start to that compiler's exit
    and its ``ptxas info`` lines (0 and empty when nothing was compiled);
    raises ``RuntimeError`` with the compilers' output if a build fails
    (a missing compiler included)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = [n for n in names if not os.path.exists(library_path(n))]
    out = {n: {"seconds": 0.0, "ptxas": []} for n in names}
    t0 = time.perf_counter()

    def compile_one(name: str):
        lib = library_path(name)
        tmp = f"{lib}.tmp{os.getpid()}"
        try:
            proc = subprocess.run(_command(name, tmp), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            return subprocess.CompletedProcess([], 127, f"{e}"), 0.0
        seconds = time.perf_counter() - t0
        if not proc.returncode:
            os.replace(tmp, lib)
        return proc, seconds

    failed = []
    with ThreadPoolExecutor(max_workers=max(1, len(todo))) as pool:
        for name, (proc, seconds) in zip(todo, pool.map(compile_one, todo)):
            if proc.returncode:
                failed.append(f"{name}: compiler exited {proc.returncode}\n"
                              f"{proc.stdout}")
                continue
            out[name] = {"seconds": seconds,
                         "ptxas": [ln for ln in proc.stdout.splitlines()
                                   if "ptxas info" in ln or "spill" in ln]}
    if failed:
        raise RuntimeError("native build failed: " + "\n".join(failed))
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>``, building it first if
    needed."""
    build(name)
    return ctypes.CDLL(library_path(name))


def launch_context(dev):
    """The context a kernel launch on CUDA device ``dev`` runs in: ``dev``
    made the current device, or nothing to do when it already is (the
    common case, which then costs no device switch)."""
    import torch

    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)
