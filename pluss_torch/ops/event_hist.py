"""The two event-histogram kernels of the port.

- :func:`event_histogram`: counterpart of
  ``pluss/ops/pallas_events.py:event_histogram_fused`` (the TPU kernel
  ``_kernel``): boundary detection, carried/cold classification, reuse
  differences, share masking, log2 binning and the ``[NBINS]``
  accumulation in one pass over each ghost-merged sorted window (the
  engine's sort windows).  CUDA source ``pluss_torch/csrc/event_hist.cu``.
- :func:`masked_histogram`: counterpart of
  ``pluss/ops/pallas_events.py:fused_event_histogram`` (the TPU kernel
  ``_hist_kernel``): log2 binning and the ``[NBINS]`` accumulation of an
  already classified event stream (the trace replay's batches).  CUDA
  source ``pluss_torch/csrc/masked_hist.cu``.

``*_plain`` are the same functions in plain torch ops.  Each wrapper takes
its plain version only for tensors on the CPU.  For CUDA tensors it
launches its kernel, and a kernel that fails to build or launch raises —
nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

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
    build.count_launch(event_histogram)
    return out


def masked_histogram_plain(reuse, is_evt, share, cold,
                           include_cold: bool = True):
    """``[NBINS]`` int64 histogram of a classified event stream in plain
    torch ops: the JAX package's ``event_histogram`` epilogue (no-share
    events binned at log2, cold weighed in slot 0 when ``include_cold``)."""
    evt = is_evt & ~share
    bins = torch.where(evt, log2_bin(reuse), 0)
    return bin_histogram(bins, (cold | evt) if include_cold else evt)


def _check_masked(reuse, is_evt, share, cold) -> None:
    if reuse.numel() == 0:
        # a launch over nothing would be counted without running
        raise ValueError("empty event stream")
    if reuse.dtype not in _POS_DTYPES:
        raise ValueError(f"reuse must be int32 or int64, got {reuse.dtype}")
    for name, t in (("reuse", reuse), ("is_evt", is_evt), ("share", share),
                    ("cold", cold)):
        if name != "reuse" and t.dtype != torch.bool:
            raise ValueError(f"{name} must be bool, got {t.dtype}")
        if t.ndim != 1 or t.shape != reuse.shape:
            raise ValueError(f"{name} must have shape {tuple(reuse.shape)} "
                             f"(1-D), got {tuple(t.shape)}")
        if t.device != reuse.device:
            raise ValueError(f"{name} is on {t.device}, reuse on "
                             f"{reuse.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def masked_histogram(reuse, is_evt, share, cold, include_cold: bool = True):
    """``[NBINS]`` int64 histogram of a classified 1-D event stream:
    ``reuse`` int32|int64 and the ``is_evt``/``share``/``cold`` bool masks
    of ``window_events``.

    CPU tensors take :func:`masked_histogram_plain`; CUDA tensors launch
    the kernel on the current stream, counted in
    ``masked_histogram.launches``.
    """
    _check_masked(reuse, is_evt, share, cold)
    if reuse.device.type == "cpu":
        return masked_histogram_plain(reuse, is_evt, share, cold,
                                      include_cold)
    if reuse.device.type != "cuda":
        raise ValueError(f"no masked-histogram kernel for device "
                         f"{reuse.device}")
    return _launch_masked(reuse, is_evt, share, cold, include_cold)


masked_histogram.launches = 0


#: entries each thread of the masked-histogram kernel takes per step
RUN = 16

#: ``vec`` bits of :func:`masked_vector_plan`: the arrays the kernel reads
#: with 16-byte vector loads after the head
VEC_EVT, VEC_SHARE, VEC_COLD, VEC_REUSE = 1, 2, 4, 8


def masked_vector_plan(addrs, reuse_size: int, n: int) -> tuple[int, int]:
    """``(head, vec)`` of the masked-histogram kernel for the device
    addresses ``addrs = (reuse, is_evt, share, cold)`` of an ``n``-entry
    stream with ``reuse_size``-byte reuses.

    The kernel bins ``head`` (< :data:`RUN`) entries one at a time, then
    runs of :data:`RUN` entries from entry ``head`` on, reading each array
    whose bit is set in ``vec`` with 16-byte vector loads (the others with
    scalar loads), then a tail of fewer than :data:`RUN` entries one at a
    time.  The head is the one that puts the most bytes per entry on
    16-byte boundaries (the smallest such head on a tie); views that start
    on the same 16-byte phase, as fresh allocations do, all align at once.
    """
    if not any(a % 16 for a in addrs):
        return 0, VEC_REUSE | VEC_EVT | VEC_SHARE | VEC_COLD
    sizes = (reuse_size, 1, 1, 1)
    bits = (VEC_REUSE, VEC_EVT, VEC_SHARE, VEC_COLD)
    best = (-1, 0, 0)
    for h in range(min(RUN, n + 1)):
        ok = [(a + h * sz) % 16 == 0 for a, sz in zip(addrs, sizes)]
        score = sum(sz for sz, o in zip(sizes, ok) if o)
        vec = sum(b for b, o in zip(bits, ok) if o)
        if score > best[0]:
            best = (score, h, vec)
    return best[1], best[2]


@functools.cache
def _masked_library() -> ctypes.CDLL:
    lib = build.load("masked_hist")
    for fn in (lib.pluss_masked_hist_i32, lib.pluss_masked_hist_i64):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int,
                                               ctypes.c_longlong,
                                               ctypes.c_longlong,
                                               ctypes.c_int,
                                               ctypes.c_void_p,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch_masked(reuse, is_evt, share, cold, include_cold):
    """Launch the CUDA kernel (one launch for the whole stream, after one
    memset of the output) and count it."""
    if reuse.data_ptr() % reuse.element_size():
        raise ValueError("reuse must start on an element boundary")
    lib = _masked_library()
    fn = lib.pluss_masked_hist_i32 if reuse.dtype == torch.int32 \
        else lib.pluss_masked_hist_i64
    n = reuse.numel()
    head, vec = masked_vector_plan(
        (reuse.data_ptr(), is_evt.data_ptr(), share.data_ptr(),
         cold.data_ptr()), reuse.element_size(), n)
    out = torch.empty(NBINS, dtype=torch.int64, device=reuse.device)
    with build.launch_context(reuse.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(reuse.data_ptr(), is_evt.data_ptr(), share.data_ptr(),
                 cold.data_ptr(), int(bool(include_cold)), n, head, vec,
                 out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"masked_hist launch failed: CUDA error {err}")
    build.count_launch(masked_histogram)
    return out
