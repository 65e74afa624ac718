"""The port's native host code: the C++ sampler runtime, the trace feed's
line mapper and the plan's window template, bound with ctypes.

The runtime (``pluss_torch/cpp``: ``pluss_rt.hpp``, ``pluss_rt.cpp``,
``capi.cpp``, ``main.cpp``) is an independent sampler on the host: it
interprets the same :class:`~pluss_torch.spec.LoopNestSpec` the card's
engine runs, marshalled as a flat int64 token stream (:func:`spec_tokens`,
grammar in ``pluss_rt.hpp``), with OpenMP across the simulated threads and
its own CRI and AET.  It is the oracle the card's results are held
against, and the ``pluss_cpp`` binary prints the reference's ``acc``,
``mrc`` and ``trace`` blocks.  :func:`build` compiles the library
(:data:`LIB_PATH`) and the binary (:data:`BIN_PATH`) with the host
compiler into ``pluss_torch/_build/`` (:mod:`pluss_torch.ops.build`);
:func:`run` and :func:`replay` build the library at first use.  A failed
build raises; this is a host oracle, not a device path, so nothing here
runs on the card.

The line mapper (:func:`line_mapper`) is ``csrc/map_lines.cpp`` and the
window template (:func:`template_builder`, the plan's analysis of a clean
window) ``csrc/window_template.cpp``, each a library of its own.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import sys

import numpy as np

from pluss_torch.config import DEFAULT, SamplerConfig
from pluss_torch.ops import build as _ops
from pluss_torch.spec import LoopNestSpec, Ref, flatten_nest

CPP_DIR = _ops.CPP
LIB_PATH = _ops.stable_path("pluss_rt")
BIN_PATH = _ops.stable_path("pluss_cpp")

#: magic word of the on-disk spec format ("PLUS" little-endian), read by
#: ``pluss_cpp --spec`` (main.cpp)
SPEC_FILE_MAGIC = 0x53554C50


def build(quiet: bool = True) -> dict[str, dict]:
    """Build the runtime's library and binary from ``pluss_torch/cpp``
    (host ``c++`` with OpenMP, both at once); a no-op when both are current.
    Returns :func:`pluss_torch.ops.build.build`'s seconds per target;
    raises ``RuntimeError`` (:class:`~pluss_torch.ops.build.BuildError`)
    with the compiler's output when a build fails."""
    out = _ops.build("pluss_rt", "pluss_cpp")
    if not quiet:
        for name, info in out.items():
            print(f"native: {name} built in {info['seconds']:.3f} s "
                  f"-> {_ops.library_path(name)}", file=sys.stderr)
    return out


def available(autobuild: bool = False) -> bool:
    """True when the library of the current sources is built (after a
    build if ``autobuild``).  With no host compiler at all a failed build
    leaves the answer to whatever is built; a failed compile with the
    compiler present raises, since a stale library would corrupt every
    comparison."""
    if autobuild:
        try:
            build()
        except _ops.BuildError:
            if shutil.which("c++") is not None:
                raise
    return os.path.exists(_ops.library_path("pluss_rt"))


@functools.cache
def _load() -> ctypes.CDLL:
    """The runtime's library with its C signatures (built at first use)."""
    lib = _ops.load("pluss_rt")
    i64p = ctypes.POINTER(ctypes.c_longlong)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.pluss_run.restype = ctypes.c_void_p
    lib.pluss_run.argtypes = [
        i64p, ctypes.c_longlong, i64p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ]
    lib.pluss_total_count.restype = ctypes.c_longlong
    lib.pluss_total_count.argtypes = [ctypes.c_void_p]
    for name in ("pluss_get_noshare", "pluss_get_share"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_longlong
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, i64p, f64p,
                       ctypes.c_longlong]
    lib.pluss_get_ri.restype = ctypes.c_longlong
    lib.pluss_get_ri.argtypes = [ctypes.c_void_p, i64p, f64p,
                                 ctypes.c_longlong]
    lib.pluss_get_mrc.restype = ctypes.c_longlong
    lib.pluss_get_mrc.argtypes = [ctypes.c_void_p, f64p, ctypes.c_longlong]
    lib.pluss_replay.restype = ctypes.c_void_p
    lib.pluss_replay.argtypes = [i64p, ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_longlong]
    lib.pluss_destroy.restype = None
    lib.pluss_destroy.argtypes = [ctypes.c_void_p]
    return lib


@functools.cache
def line_mapper():
    """``map_lines(raw, shift, start, width, base) -> int32 ids | None``.

    ``raw`` is a 1-D array of u64 byte addresses (or precompacted line ids
    with ``shift`` 0); each maps to ``(int64(raw) >> shift) - start +
    base``.  None when some line falls outside ``[start, start + width)``
    (the caller then probes the cluster table in general).  Builds the
    library on the first call and raises ``RuntimeError`` if that fails.
    """
    fn = _ops.load("map_lines").pluss_torch_map_lines
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def map_lines(raw: np.ndarray, shift: int, start: int, width: int,
                  base: int) -> np.ndarray | None:
        raw = np.ascontiguousarray(raw, dtype="<u8")
        if raw.ndim != 1:
            raise ValueError(f"raw must be 1-D, got shape {raw.shape}")
        if not 0 <= shift < 64:
            raise ValueError(f"shift must be in [0, 64), got {shift}")
        out = np.empty(raw.shape[0], np.int32)
        ok = fn(raw.ctypes.data, raw.shape[0], shift, start, width, base,
                out.ctypes.data)
        return out if ok else None

    return map_lines


#: the window template's arrays: name -> dtype, in the emit call's order
TEMPLATE_ARRAYS = (("local_hist", np.int64), ("share_vals", np.int64),
                   ("share_cnts", np.int64), ("head_line", np.int32),
                   ("head_pos", np.int64), ("head_span", np.int32),
                   ("head_dline", np.int32), ("hs_idx", np.int32),
                   ("tail_line", np.int32), ("tail_pos", np.int64),
                   ("tail_dline", np.int32))


#: most threads one template build walks with: on an 8-core H100 host 4
#: threads take GEMM-1024's builds from 0.26 s to 0.10-0.11 s a schedule
#: and 8 only to 0.09 s, and four planners at once plan no faster at 8
#: than at 4 (PERF.md), so a cold plan leaves half of such a host to the
#: device loop and to other planners beside it
TEMPLATE_THREADS = 4


@functools.cache
def template_builder():
    """``build(refs, line_bases, dlines, owned_row, r0, W, sched, cfg,
    nbins) -> (arrays, entries, threads)``: the window template of one
    thread's window of rounds ``[r0, r0 + W)``
    (``csrc/window_template.cpp``).

    ``refs`` are the template's :class:`~pluss_torch.spec.FlatRef`\\ s of a
    rectangular nest, ``line_bases`` and ``dlines`` their arrays' line
    bases and line shifts per unit, ``owned_row`` the thread's row of
    chunk ids.  ``arrays`` maps each name of :data:`TEMPLATE_ARRAYS` to its
    array; ``entries`` counts the accesses walked and ``threads`` the
    threads that walked them, at most :data:`TEMPLATE_THREADS` and the
    cores this process may run on; the template is the same whatever their
    number.  Positions omit the nest's base clock.  Raises ``RuntimeError``
    when two accesses share a position.  Builds the library on the first
    call and raises ``RuntimeError`` if that fails.
    """
    lib = _ops.load("window_template")
    fn = lib.pluss_torch_window_template
    fn.restype = ctypes.c_void_p
    fn.argtypes = [ctypes.c_longlong] + [ctypes.c_void_p] * 5 \
        + [ctypes.c_longlong] * 9 + [ctypes.c_void_p, ctypes.c_char_p]
    emit = lib.pluss_torch_window_template_emit
    emit.restype = None
    emit.argtypes = [ctypes.c_void_p] * (1 + len(TEMPLATE_ARRAYS))
    free = lib.pluss_torch_window_template_free
    free.restype = None
    free.argtypes = [ctypes.c_void_p]

    def build(refs, line_bases, dlines, owned_row: np.ndarray, r0: int,
              W: int, sched, cfg: SamplerConfig, nbins: int):
        if not len(refs) == len(line_bases) == len(dlines):
            raise ValueError(f"{len(refs)} refs, {len(line_bases)} line "
                             f"bases, {len(dlines)} line shifts")
        meta, levels = [], []
        for fr, lb in zip(refs, line_bases):
            rows = (fr.trips, fr.pos_strides, fr.addr_coefs, fr.starts,
                    fr.steps)
            if len({len(r) for r in rows}) != 1:
                raise ValueError(f"ref {fr.ref.name}: levels of unequal "
                                 f"length {[len(r) for r in rows]}")
            meta += [len(fr.trips), fr.offset, fr.ref.addr_base, lb]
            for row in zip(*rows):
                levels += row
        meta = np.array(meta, np.int64)
        levels = np.array(levels or [0], np.int64)
        span = np.array([fr.ref.share_span or 0 for fr in refs], np.int32)
        dline = np.array(dlines, np.int32)
        chunks = np.ascontiguousarray(owned_row[r0:r0 + W], dtype=np.int64)
        if chunks.shape != (W,):
            raise ValueError(f"rounds [{r0}, {r0 + W}) outside the owned "
                             f"row of {len(owned_row)}")
        sizes = np.zeros(5, np.int64)
        err = ctypes.create_string_buffer(256)
        h = fn(len(refs), meta.ctypes.data, levels.ctypes.data,
               span.ctypes.data, dline.ctypes.data, chunks.ctypes.data, W,
               r0, cfg.chunk_size, cfg.ds, cfg.cls, sched.start, sched.step,
               nbins, min(TEMPLATE_THREADS, len(os.sched_getaffinity(0))),
               sizes.ctypes.data, err)
        if not h:
            raise RuntimeError(f"window template: {err.value.decode()}")
        try:
            entries, n_heads, n_share, n_hs, threads = (int(x)
                                                        for x in sizes)
            size = {"local_hist": nbins, "share_vals": n_share,
                    "share_cnts": n_share, "hs_idx": n_hs}
            arrays = {name: np.empty(size.get(name, n_heads), dt)
                      for name, dt in TEMPLATE_ARRAYS}
            emit(h, *(a.ctypes.data for a in arrays.values()))
        finally:
            free(h)
        return arrays, entries, threads

    return build


def spec_tokens(spec: LoopNestSpec) -> np.ndarray:
    """Marshal a spec into the int64 token grammar of ``pluss_rt.hpp``.

    Runs the engine's structural checks first (:func:`flatten_nest`: no
    bounds on the parallel loop, no nested bounded loops, bounds within
    ``[0, trip]``), so the runtime refuses exactly what the engine refuses
    instead of reading an invalid spec as rectangular."""
    for nest in spec.nests:
        flatten_nest(nest)
    toks: list[int] = [len(spec.nests)]

    def emit(item) -> None:
        if isinstance(item, Ref):
            toks.extend([1, spec.array_index(item.array), item.addr_base,
                         -1 if item.share_span is None else item.share_span,
                         len(item.addr_terms)])
            for depth, coef in item.addr_terms:
                toks.extend([depth, coef])
        elif item.bound_coef is not None or item.start_coef:
            # a bounded loop (TRI): effective trip a + b*idx of the level
            # bound_level names (0 = the parallel index), first value
            # start + start_coef*k; a varying start with a fixed trip ships
            # the constant bound (trip, 0)
            a, b = item.bound_coef or (item.trip, 0)
            toks.extend([2, item.trip, item.start, item.step, a, b,
                         item.start_coef, item.bound_level, len(item.body)])
            for bd in item.body:
                emit(bd)
        else:
            toks.extend([0, item.trip, item.start, item.step, len(item.body)])
            for bd in item.body:
                emit(bd)

    for nest in spec.nests:
        emit(nest)
    return np.asarray(toks, np.int64)


def write_spec_file(spec: LoopNestSpec, path: str) -> None:
    """Write a spec for ``pluss_cpp <mode> --spec <path>``: little-endian
    int64 words ``magic, n_arrays, elems[n_arrays], n_tokens,
    tokens[n_tokens]`` (:func:`spec_tokens`' grammar), replaced
    atomically."""
    toks = spec_tokens(spec)
    elems = [e for _, e in spec.arrays]
    out = np.concatenate([
        np.asarray([SPEC_FILE_MAGIC, len(elems)], np.int64),
        np.asarray(elems, np.int64),
        np.asarray([len(toks)], np.int64),
        toks,
    ])
    tmp = path + ".tmp"
    out.astype("<i8").tofile(tmp)
    os.replace(tmp, path)


class NativeResult:
    """One native run: the per-thread histograms of
    :class:`pluss_torch.engine.SamplerResult`, the CRI histogram and the
    MRC, read from the runtime's handle (freed with the object)."""

    def __init__(self, handle, lib, thread_num: int):
        self._h = handle
        self._lib = lib
        self.thread_num = thread_num

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pluss_destroy(self._h)
            self._h = None

    def _hist(self, getter, *pre) -> dict:
        cap = 256
        while True:
            keys = np.empty(cap, np.int64)
            vals = np.empty(cap, np.float64)
            n = getter(
                self._h, *pre,
                keys.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
                vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap,
            )
            if n < 0:
                raise ValueError("bad tid")
            if n <= cap:
                return {int(k): float(v) for k, v in zip(keys[:n], vals[:n])}
            cap = int(n)

    def noshare_list(self) -> list[dict]:
        return [self._hist(self._lib.pluss_get_noshare, t)
                for t in range(self.thread_num)]

    def share_list(self) -> list[dict]:
        out = []
        for t in range(self.thread_num):
            h = self._hist(self._lib.pluss_get_share, t)
            out.append({self.thread_num - 1: h} if h else {})
        return out

    def rihist(self) -> dict:
        return self._hist(self._lib.pluss_get_ri)

    def mrc(self) -> np.ndarray:
        n = self._lib.pluss_get_mrc(self._h, None, 0)
        out = np.empty(n, np.float64)
        got = self._lib.pluss_get_mrc(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n)
        if got != n:
            raise RuntimeError(f"native MRC: {got} entries, expected {n}")
        return out

    @property
    def max_iteration_count(self) -> int:
        return int(self._lib.pluss_total_count(self._h))


def run(spec: LoopNestSpec, cfg: SamplerConfig = DEFAULT) -> NativeResult:
    """Run the sampler and CRI in the native runtime, on the host."""
    lib = _load()
    toks = spec_tokens(spec)
    elems = np.asarray([n for _, n in spec.arrays], np.int64)
    h = lib.pluss_run(
        toks.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), len(toks),
        elems.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), len(elems),
        cfg.thread_num, cfg.chunk_size, cfg.ds, cfg.cls, cfg.cache_kb,
    )
    if not h:
        raise ValueError("native runtime rejected the spec")
    return NativeResult(h, lib, cfg.thread_num)


def replay(addrs: np.ndarray, cls: int = 64,
           cache_kb: int = DEFAULT.cache_kb) -> NativeResult:
    """Native trace replay (``pluss::replay_trace``), the host twin of
    :func:`pluss_torch.trace.replay`: one clock, no CRI dilation; results
    through ``rihist()`` and ``mrc()``."""
    lib = _load()
    a = np.ascontiguousarray(np.asarray(addrs, np.int64))
    h = lib.pluss_replay(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), len(a),
        cls, cache_kb,
    )
    if not h:
        raise RuntimeError("native replay failed")
    return NativeResult(h, lib, thread_num=1)
