"""The interleave overlay window as one CUDA kernel.

:func:`overlay_window` launches ``pluss_torch/csrc/overlay_window.cu``:
one overlaid array's window for a batch of thread rows, the algebra of
:func:`pluss_torch.overlay.device_window_plain` in one pass, bit for bit.
It replaces no TPU kernel: the JAX package's overlay window is jnp that XLA
fuses, where the port's plain version is ~350 eager torch operators a
window, each a launch of its own.

:func:`pluss_torch.overlay.device_window` is the wrapper the engine calls:
it checks its inputs (:func:`check_inputs`), takes the plain version for
CPU tensors and this kernel for CUDA tensors.  A kernel that fails to
build or launch raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pluss_torch.config import NBINS
from pluss_torch.ops import build

_POS_DTYPES = (torch.int32, torch.int64)


class _Geom(ctypes.Structure):
    """The window's geometry, field for field ``Geom`` of the CUDA source."""

    _fields_ = [(name, ctypes.c_longlong) for name in (
        "T", "CS", "R", "lpe", "J", "SL", "W", "K", "n_lines", "line_base",
        "row_len", "w", "dpos", "d_s0", "d_sj", "d_sk", "d_off", "d_span",
        "s_s0", "s_su", "s_sk", "s_off", "s_span", "a_blocks")]


def widths(ov, cfg) -> tuple[int, int]:
    """Entries of a row of the window's ``plus`` and ``minus`` pairs:
    ``(2*NA + W*CS*R + n_lines, NA + W*CS*R)`` with ``NA = SL*SL*K`` the
    arrivals of a row."""
    na = ov.SL * ov.SL * ov.s_ref.trips[-1]
    wc = ov.W * cfg.chunk_size * ov.R
    return 2 * na + wc + ov.n_lines, na + wc


def check_inputs(dov, tids, nb, last_pos) -> None:
    """Refuse what neither version takes: ``last_pos`` a contiguous
    ``[Tb, lines]`` int32|int64 table that holds the overlaid array's lines;
    ``tids`` and ``nb`` contiguous ``[Tb]`` int64; the overlay's tables
    int64, contiguous, of the plan's shapes; all on one device."""
    ov = dov.ov
    if last_pos.ndim != 2:
        raise ValueError(f"last_pos must be [Tb, lines], got shape "
                         f"{tuple(last_pos.shape)}")
    if last_pos.dtype not in _POS_DTYPES:
        raise ValueError(f"last_pos must be int32 or int64, got "
                         f"{last_pos.dtype}")
    if last_pos.shape[1] < ov.line_base + ov.n_lines:
        raise ValueError(f"last_pos has {last_pos.shape[1]} lines; array "
                         f"{ov.array!r} ends at line "
                         f"{ov.line_base + ov.n_lines}")
    Tb = last_pos.shape[0]
    want = {"last_pos": (last_pos, last_pos.dtype, tuple(last_pos.shape)),
            "tids": (tids, torch.int64, (Tb,)),
            "nb": (nb, torch.int64, (Tb,)),
            "static_hist": (dov.static_hist, torch.int64, (NBINS,)),
            "prefix": (dov.prefix, torch.int64, (ov.n_lines + 1, NBINS)),
            "first0": (dov.first0, torch.int64, (ov.n_lines,)),
            "last0": (dov.last0, torch.int64, (ov.n_lines,))}
    for name, (t, dt, shape) in want.items():
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != last_pos.device:
            raise ValueError(f"{name} is on {t.device}, last_pos on "
                             f"{last_pos.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("overlay_window")
    for fn in (lib.pluss_overlay_window_i32, lib.pluss_overlay_window_i64):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] \
            + [ctypes.c_void_p] * 13
        fn.restype = ctypes.c_int
    return lib


def overlay_window(dov, cfg, w: int, tids, nb, last_pos):
    """Launch the kernel on CUDA inputs that :func:`check_inputs` took
    (one memset of the histogram and one kernel, on the current stream,
    inside the profiler range ``pluss::overlay_window``) and count it;
    ``last_pos`` is rewritten in place.  Returns the window's ``(hist
    [Tb, NBINS] int64, (plus reuse, plus share), (minus reuse, minus
    share))``, as ``overlay.device_window`` documents."""
    ov = dov.ov
    Tb = last_pos.shape[0]
    n_plus, n_minus = widths(ov, cfg)
    dev = last_pos.device
    geom = _Geom(
        T=cfg.thread_num, CS=cfg.chunk_size, R=ov.R, lpe=ov.lpe, J=ov.J,
        SL=ov.SL, W=ov.W, K=ov.s_ref.trips[-1], n_lines=ov.n_lines,
        line_base=ov.line_base, row_len=last_pos.shape[1], w=w,
        dpos=(w - ov.w0) * ov.pos_shift, d_s0=ov.d_s0, d_sj=ov.d_sj,
        d_sk=ov.d_sk, d_off=ov.d_off, d_span=ov.d_span, s_s0=ov.s_s0,
        s_su=ov.s_su, s_sk=ov.s_sk, s_off=ov.s_off, s_span=ov.s_span)
    hist = torch.empty((Tb, NBINS), dtype=torch.int64, device=dev)
    plus = (torch.empty((Tb, n_plus), dtype=torch.int64, device=dev),
            torch.empty((Tb, n_plus), dtype=torch.bool, device=dev))
    minus = (torch.empty((Tb, n_minus), dtype=torch.int64, device=dev),
             torch.empty((Tb, n_minus), dtype=torch.bool, device=dev))
    lib = _library()
    fn = lib.pluss_overlay_window_i32 if last_pos.dtype == torch.int32 \
        else lib.pluss_overlay_window_i64
    # a function-scope range, unlike a ``record_function`` (user scope),
    # makes torch.profiler tie the memset and the kernel to the host
    # ranges around the call, as inductor does for its Triton launches
    with build.launch_context(dev), \
            torch._C._profiler._RecordFunctionFast("pluss::overlay_window"):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ctypes.addressof(geom), Tb, tids.data_ptr(), nb.data_ptr(),
                 last_pos.data_ptr(), dov.static_hist.data_ptr(),
                 dov.prefix.data_ptr(), dov.first0.data_ptr(),
                 dov.last0.data_ptr(), plus[0].data_ptr(),
                 plus[1].data_ptr(), minus[0].data_ptr(),
                 minus[1].data_ptr(), hist.data_ptr(), stream)
    if err:
        raise RuntimeError(f"overlay_window launch failed: CUDA error {err}")
    build.count_launch(overlay_window)
    return hist, plus, minus


overlay_window.launches = 0
