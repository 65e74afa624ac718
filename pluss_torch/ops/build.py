"""Build the port's native code from ``pluss_torch/csrc`` and
``pluss_torch/cpp`` at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, loaded with ``ctypes``: a file
that does not include PyTorch's headers builds in seconds, where a PyTorch
extension takes minutes.  Each ``csrc/<name>.cpp`` (host code: the trace
feed's line mapper, the plan's window template) compiles the same way with
the host C++ compiler.  The
native runtime (``cpp/``, :mod:`pluss_torch.native`) has two targets of
several sources each, built with OpenMP (:data:`HOST_TARGETS`): the
``pluss_rt`` library and the standalone ``pluss_cpp`` binary.
Outputs land in ``pluss_torch/_build/`` (git-ignored), named by a hash of
every source, the shared headers (``csrc/*.cuh`` for CUDA sources,
``cpp/*.hpp`` for the runtime) and the flags, so an edited source or header
rebuilds and an unchanged one is reused; the runtime's targets are also
published under stable names (``_build/libpluss_rt.so``,
``_build/pluss_cpp``, links to the current build).  Nothing is built when a
module is imported; :func:`load` builds on the first use, and :func:`build`
compiles several targets at once, one compiler each, all started together.
A failed build raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
CPP = os.path.join(_PKG, "cpp")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
#: the native runtime's flags: OpenMP fans the simulated threads out
RT_FLAGS = ("-O2", "-std=c++17", "-fopenmp", "-fPIC")

#: the native runtime's targets, each of several ``cpp/`` sources:
#: name -> (sources, shared library or executable)
HOST_TARGETS = {
    "pluss_rt": (("pluss_rt.cpp", "capi.cpp"), True),
    "pluss_cpp": (("main.cpp", "pluss_rt.cpp"), False),
}


class BuildError(RuntimeError):
    """A native build failed (the compiler's output is in the message).
    :func:`pluss_torch.resilience.errors.classify` maps it to
    ``CompileError``."""


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


def _recipe(name: str) -> tuple:
    """``(directory, sources, headers, flags, shared)`` of a target: one
    ``csrc`` source, or one of :data:`HOST_TARGETS`."""
    if name in HOST_TARGETS:
        srcs, shared = HOST_TARGETS[name]
        headers = sorted(f for f in os.listdir(CPP) if f.endswith(".hpp"))
        return CPP, srcs, headers, \
            RT_FLAGS + (("-shared",) if shared else ()), shared
    src = _source(name)
    cuda = src.endswith(".cu")
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh")) \
        if cuda else []
    return CSRC, (os.path.basename(src),), headers, \
        NVCC_FLAGS if cuda else CXX_FLAGS, True


def _command(name: str, out: str) -> list[str]:
    d, srcs, _, flags, _ = _recipe(name)
    paths = [os.path.join(d, f) for f in srcs]
    return [nvcc() if srcs[0].endswith(".cu") else cxx(), *flags, "-o", out,
            *paths]


def library_path(name: str) -> str:
    """The build output of ``name``: ``lib<name>-<hash>.so`` for a shared
    library, ``<name>-<hash>`` for an executable."""
    d, srcs, headers, flags, shared = _recipe(name)
    digest = hashlib.sha256(repr(flags).encode())
    for f in [*srcs, *headers]:
        with open(os.path.join(d, f), "rb") as fh:
            digest.update(f.encode() + fh.read())
    tag = digest.hexdigest()[:12]
    return os.path.join(BUILD_DIR,
                        f"lib{name}-{tag}.so" if shared else f"{name}-{tag}")


def stable_path(name: str) -> str:
    """The stable name of a :data:`HOST_TARGETS` output in ``_build/``
    (``libpluss_rt.so``, ``pluss_cpp``): a link to its current build."""
    shared = HOST_TARGETS[name][1]
    return os.path.join(BUILD_DIR, f"lib{name}.so" if shared else name)


def _publish(name: str) -> None:
    """Point :func:`stable_path` at the current build (a relative link,
    swapped in atomically)."""
    link, target = stable_path(name), os.path.basename(library_path(name))
    if os.path.islink(link) and os.readlink(link) == target:
        return
    tmp = f"{link}.tmp{os.getpid()}-{threading.get_ident()}"
    os.symlink(target, tmp)
    os.replace(tmp, link)


_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()
_load_locks: dict[str, threading.Lock] = {}
_build_locks: dict[str, threading.Lock] = {}


def _lock_of(table: dict, name: str) -> threading.Lock:
    with _load_lock:
        return table.setdefault(name, threading.Lock())


def build(*names: str) -> dict[str, dict]:
    """Compile each ``csrc/<name>.cu`` or ``.cpp``, or runtime target of
    :data:`HOST_TARGETS`, that is not built already, one compiler process
    per target, all started together (a runtime target is then published
    under its :func:`stable_path`).
    Returns, per name, the seconds from the start to that compiler's exit
    and its ``ptxas info`` lines (0 and empty when nothing was compiled);
    raises :class:`BuildError` with the compilers' output if a build fails
    (a missing compiler included)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = [n for n in names if not os.path.exists(library_path(n))]
    out = {n: {"seconds": 0.0, "ptxas": []} for n in names}
    t0 = time.perf_counter()

    def compile_one(name: str):
        lib = library_path(name)
        # one compiler per source in this process: a thread that finds a
        # build of its source running waits for it and compiles nothing
        with _lock_of(_build_locks, name):
            if os.path.exists(lib):
                return subprocess.CompletedProcess([], 0, ""), 0.0
            # unique per process and thread: another process building the
            # same source never writes this file
            tmp = f"{lib}.tmp{os.getpid()}-{threading.get_ident()}"
            try:
                proc = subprocess.run(_command(name, tmp),
                                      stdout=subprocess.PIPE,
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
        raise BuildError("native build failed: " + "\n".join(failed))
    for name in names:
        if name in HOST_TARGETS:
            _publish(name)
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>``, building it first if
    needed.  Single-flight per name: threads that ask for one library at
    once (the serving daemon's device loop, warm thread and background
    compile; the sweep's precompile thread) run one build and share one
    handle.  A failed build raises and is not memoized: the next caller
    builds again."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock_of(_load_locks, name):
        lib = _loaded.get(name)
        if lib is None:
            build(name)
            lib = _loaded[name] = ctypes.CDLL(library_path(name))
    return lib


def _forget() -> None:
    """Drop the loaded handles, so the next :func:`load` builds or
    reloads (tests that repoint ``BUILD_DIR``/``CSRC``)."""
    with _load_lock:
        _loaded.clear()


#: the ``functools.cache`` spelling the callers already use
load.cache_clear = _forget


_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, a kernel wrapper's launch count,
    under a lock: the shard dispatch launches kernels from several worker
    threads at once, and an unlocked ``+= 1`` (a read, an add, a write)
    can lose one of two racing updates.  The launch also lands in the
    telemetry counter ``kernel.launches.<wrapper>``, which is how another
    process (the serving daemon) reports its launches."""
    from pluss_torch import obs

    with _count_lock:
        wrapper.launches += 1
    obs.counter_add(f"kernel.launches.{wrapper.__name__}")


def launch_context(dev):
    """The context a kernel launch on CUDA device ``dev`` runs in: ``dev``
    made the current device, or nothing to do when it already is (the
    common case, which then costs no device switch)."""
    import torch

    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)
