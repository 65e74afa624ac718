"""d24v wire decode on the device.

Counterpart of ``pluss/ops/pallas_decode.py:decode_d24v`` (the TPU kernel
``_kernel``).  The CUDA kernel lives in ``pluss_torch/csrc/d24v_decode.cu``;
:func:`pluss_torch.ops.wirecodec.decode_d24v_plain` is the same function in
plain torch ops.

:func:`decode_d24v` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel, and a kernel that fails to build
or launch raises — nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pluss_torch.ops import build
from pluss_torch.ops.wirecodec import BLOCK, decode_d24v_plain


def _check(payload, wm) -> None:
    for name, t in (("payload", payload), ("wm", wm)):
        if t.dtype != torch.uint8:
            raise ValueError(f"{name} must be uint8, got {t.dtype}")
        if t.ndim != 1:
            raise ValueError(f"{name} must be 1-D, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if wm.device != payload.device:
        raise ValueError(f"wm is on {wm.device}, payload on {payload.device}")
    if payload.numel() == 0 or payload.numel() % 4:
        raise ValueError(f"payload length {payload.numel()} is not a "
                         "positive multiple of 4 (wirecodec.pad_len)")
    if wm.numel() == 0:
        raise ValueError("wm is empty")


def decode_d24v(payload: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
    """``(payload uint8[P], wm uint8[nb]) -> int32[nb * BLOCK]`` line ids
    of one d24v-encoded batch (``P`` a multiple of 4, as
    ``wirecodec.pad_len`` makes it).

    CPU tensors take :func:`decode_d24v_plain`; CUDA tensors launch the
    kernel on the current stream, counted in ``decode_d24v.launches`` (one
    per call: one kernel after one memset of its scratch).
    """
    _check(payload, wm)
    if payload.device.type == "cpu":
        return decode_d24v_plain(payload, wm)
    if payload.device.type != "cuda":
        raise ValueError(f"no d24v decode kernel for device "
                         f"{payload.device}")
    return _launch(payload, wm)


decode_d24v.launches = 0


#: wire blocks per tile of the CUDA decode: one CTA, one warp per block
TILE_BLOCKS = 8

#: most wire blocks per call: block start words stay below 2^32
MAX_BLOCKS = 1 << 22


def tiles(nb: int) -> int:
    """Tiles (CTAs) of the decode of ``nb`` wire blocks."""
    return -(-nb // TILE_BLOCKS)


def scratch_bytes(nb: int) -> int:
    """Bytes of the decode's look-back scratch: the tile counter (16 B),
    then a start-word flag and a carry flag (8 B each) per tile."""
    return 16 + 16 * tiles(nb)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("d24v_decode")
    fn = lib.pluss_d24v_decode
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _launch(payload, wm):
    """Launch the CUDA decode (one memset of the scratch, one kernel, on
    the current stream) and count it."""
    if payload.data_ptr() % 4:
        raise ValueError("payload must start on a 4-byte boundary")
    nb = wm.numel()
    if nb > MAX_BLOCKS:
        raise ValueError(f"{nb} wire blocks in one call; the decode takes "
                         f"at most {MAX_BLOCKS}")
    fn = _library().pluss_d24v_decode
    out = torch.empty(nb * BLOCK, dtype=torch.int32, device=payload.device)
    scratch = torch.empty(scratch_bytes(nb), dtype=torch.uint8,
                          device=payload.device)
    with build.launch_context(payload.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(payload.data_ptr(), payload.numel() // 4, wm.data_ptr(), nb,
                 out.data_ptr(), scratch.data_ptr(), scratch.numel(), stream)
    if err:
        raise RuntimeError(f"d24v_decode launch failed: CUDA error {err}")
    decode_d24v.launches += 1
    return out
