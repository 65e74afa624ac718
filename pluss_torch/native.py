"""Host-native helpers of the port: the trace feed's line mapper.

The port's counterpart of ``pluss/native.py:line_mapper`` over its own
``csrc/map_lines.cpp`` (the copy of ``pluss_map_lines``,
``pluss/cpp/capi.cpp``), built by :mod:`pluss_torch.ops.build` with the
host compiler at first use and bound with ctypes.  A failed build raises;
nothing falls back to numpy.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from pluss_torch.ops import build


@functools.cache
def line_mapper():
    """``map_lines(raw, shift, start, width, base) -> int32 ids | None``.

    ``raw`` is a 1-D array of u64 byte addresses (or precompacted line ids
    with ``shift`` 0); each maps to ``(int64(raw) >> shift) - start +
    base``.  None when some line falls outside ``[start, start + width)``
    (the caller then probes the cluster table in general).  Builds the
    library on the first call and raises ``RuntimeError`` if that fails.
    """
    fn = build.load("map_lines").pluss_torch_map_lines
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
