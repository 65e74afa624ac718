"""Fused carried-event histogram of ghost-merged sorted windows.

Counterpart of ``pluss/ops/pallas_events.py:event_histogram_fused`` (the
TPU kernel ``_kernel``): boundary detection, carried/cold classification,
reuse differences, share masking, log2 binning and the ``[NBINS]``
accumulation in one pass over each sorted window.  The CUDA kernel lives in
``pluss_torch/csrc/event_hist.cu``; :func:`event_histogram_plain` is the
same function in plain torch ops.

:func:`event_histogram` takes the plain version only for tensors on the
CPU.  For CUDA tensors it launches the kernel, and a kernel that fails to
build or launch raises — nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from pluss_torch.config import NBINS
from pluss_torch.ops import build
from pluss_torch.ops.reuse import bin_histogram, carried_events, log2_bin

_POS_DTYPES = (torch.int32, torch.int64)


def event_histogram_plain(key_s, pos_s, span_s, valid_s, win_start):
    """``[T, NBINS]`` int64 histogram of ``[T, L]`` sorted windows in plain
    torch ops: ``carried_events`` followed by the JAX package's
    ``event_histogram`` (no-share events binned at log2, cold in slot 0)."""
    ev = carried_events(key_s, pos_s, span_s, valid_s, win_start)
    evt = ev["is_evt"] & ~ev["share"]
    bins = torch.where(evt, log2_bin(ev["reuse"]), 0)
    return bin_histogram(bins, ev["cold"] | evt)


def _check(key_s, pos_s, span_s, valid_s, win_start) -> None:
    if key_s.ndim != 2:
        raise ValueError(f"key_s must be [T, L], got shape "
                         f"{tuple(key_s.shape)}")
    want = {"key_s": (key_s, torch.int32), "pos_s": (pos_s, pos_s.dtype),
            "span_s": (span_s, torch.int32), "valid_s": (valid_s, torch.bool),
            "win_start": (win_start, pos_s.dtype)}
    if pos_s.dtype not in _POS_DTYPES:
        raise ValueError(f"pos_s must be int32 or int64, got {pos_s.dtype}")
    for name, (t, dt) in want.items():
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != key_s.device:
            raise ValueError(f"{name} is on {t.device}, key_s on "
                             f"{key_s.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        shape = key_s.shape[:1] if name == "win_start" else key_s.shape
        if t.shape != shape:
            raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")


def event_histogram(key_s, pos_s, span_s, valid_s, win_start):
    """``[T, NBINS]`` int64 carried-event histogram of ``[T, L]`` sorted,
    ghost-merged windows (``key_s`` int32, ``pos_s`` int32|int64, ``span_s``
    int32, ``valid_s`` bool, ``win_start [T]`` of the position dtype).

    CPU tensors take :func:`event_histogram_plain`; CUDA tensors launch the
    kernel on the current stream, counted in ``event_histogram.launches``.
    """
    _check(key_s, pos_s, span_s, valid_s, win_start)
    if key_s.device.type == "cpu":
        return event_histogram_plain(key_s, pos_s, span_s, valid_s, win_start)
    if key_s.device.type != "cuda":
        raise ValueError(f"no event-histogram kernel for device "
                         f"{key_s.device}")
    return _launch(key_s, pos_s, span_s, valid_s, win_start)


event_histogram.launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load("event_hist")
    for fn in (lib.pluss_event_hist_i32, lib.pluss_event_hist_i64):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 \
            + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    return lib


def _launch(key_s, pos_s, span_s, valid_s, win_start):
    """Launch the CUDA kernel (one launch for all T rows) and count it."""
    lib = _library()
    fn = lib.pluss_event_hist_i32 if pos_s.dtype == torch.int32 \
        else lib.pluss_event_hist_i64
    T, L = key_s.shape
    out = torch.zeros((T, NBINS), dtype=torch.int64, device=key_s.device)
    with torch.cuda.device(key_s.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(key_s.data_ptr(), pos_s.data_ptr(), span_s.data_ptr(),
                 valid_s.data_ptr(), win_start.data_ptr(), T, L,
                 out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"carried_event_hist launch failed: CUDA error "
                           f"{err}")
    event_histogram.launches += 1
    return out
