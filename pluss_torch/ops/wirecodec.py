"""Compressed trace wire format ``d24v``: delta + zigzag + nibble bit-pack.

The port's copy of ``pluss/ops/wirecodec.py``.  A batch of dense int32 line
ids is split into :data:`BLOCK`-id blocks; each block stores either the
zigzag-mapped global deltas (the batch's first delta is taken against 0) or
the raw ids, whichever needs fewer nibbles, bit-packed at the smallest
nibble-aligned width (0..6 nibbles).  Raw blocks reset the delta chain.

Wire layout per batch:

- ``wm``: ``uint8[n_blocks]`` — low 3 bits = nibbles per value (0..6),
  bit 7 = raw mode.  Block byte lengths (``nibbles * BLOCK/2``), and so the
  block offsets, follow from ``wm`` alone (:func:`used_bytes`).
- ``payload``: the packed value bits, little-endian bytes, low nibble
  first, padded by :func:`pad_len` (4-byte alignment + one u32 guard word
  + eighth-octave quantization).

:func:`encode_d24v` is the host encoder (numpy).  The decode runs on the
device: :func:`pluss_torch.ops.decode.decode_d24v` launches the CUDA kernel
for CUDA tensors; :func:`decode_d24v_plain` is the same function in plain
torch ops, equal to ``pluss.ops.wirecodec.decode_d24v``.
"""

from __future__ import annotations

import numpy as np
import torch

#: ids per bit-width block
BLOCK = 1024

#: wm mode bit: block stores raw ids, not zigzag deltas
RAW_MODE = 0x80

#: hard ceiling of the format: one nibble-width field (0..6 nibbles) holds
#: any value, so ids top out at 24 bits
MAX_ID = (1 << 24) - 1


def pad_len(nbytes: int) -> int:
    """Padded payload length: 4-aligned + one u32 guard word, then
    quantized to an eighth of the nearest lower power of two, wasting
    <= ~12.5% of the wire on padding."""
    base = -(-(nbytes + 4) // 4) * 4
    if base <= 4096:
        q = 64
    else:
        q = max(64, (1 << (int(base).bit_length() - 1)) // 8)
    return -(-base // q) * q


def used_bytes(wm: np.ndarray) -> int:
    """Real payload bytes of an encoded batch (before :func:`pad_len`
    padding), derived from the width map alone."""
    w = np.asarray(wm, np.int64)
    return int(((w & 0x7) * (BLOCK // 2)).sum())


def _bit_length(m: np.ndarray) -> np.ndarray:
    """Vectorized bit_length of non-negative ints < 2**53 (frexp's
    exponent IS the bit length, exactly, for anything float64 holds)."""
    return np.frexp(m.astype(np.float64))[1].astype(np.int64)


def encode_d24v(ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Encode one batch of dense int32 line ids.  Returns
    ``(payload uint8[pad_len(P)], wm uint8[n_blocks])``.

    Raises on ids outside ``[0, 2**24)``: wider tables take the plain i32
    wire instead.
    """
    ids = np.ascontiguousarray(ids, np.int32)
    n = ids.shape[0]
    if n == 0:
        raise ValueError("cannot d24v-encode an empty batch")
    nb = -(-n // BLOCK)
    if n < nb * BLOCK:
        # pad with the last id: delta 0, free under either block mode
        ids = np.concatenate(
            [ids, np.full(nb * BLOCK - n, ids[-1], np.int32)])
    blk = ids.reshape(nb, BLOCK)
    if int(blk.min()) < 0 or int(blk.max()) > MAX_ID:
        raise ValueError(
            f"d24v wire holds ids in [0, 2**24); got "
            f"[{int(blk.min())}, {int(blk.max())}]")
    # global diffs (first vs 0): a block head costs bit_length(|step|),
    # not bit_length(id)
    d = np.diff(ids, prepend=np.int32(0)).reshape(nb, BLOCK)
    z = ((d << 1) ^ (d >> 31)).view(np.uint32)       # zigzag, unsigned
    raw = blk.view(np.uint32)
    k_delta = (_bit_length(z.max(axis=1)) + 3) // 4
    k_raw = (_bit_length(raw.max(axis=1)) + 3) // 4
    # raw wins ties: no prefix sum on decode, and it caps k at 6 nibbles
    # (a 24-bit table's deltas can need 25 bits; its raw ids never do)
    mode_raw = k_raw <= k_delta
    k = np.where(mode_raw, k_raw, k_delta)
    wm = (k | np.where(mode_raw, RAW_MODE, 0)).astype(np.uint8)
    vals = np.where(mode_raw[:, None], raw, z)
    blk_bytes = k * (BLOCK // 2)
    starts = np.concatenate([[0], np.cumsum(blk_bytes)[:-1]])
    payload = np.zeros(pad_len(int(blk_bytes.sum())), np.uint8)
    for kk in range(1, 7):
        sel = np.nonzero(k == kk)[0]
        if not sel.size:
            continue
        v = vals[sel]                                    # [m, BLOCK] u32
        sh = np.arange(kk, dtype=np.uint32) * 4
        nib = ((v[:, :, None] >> sh[None, None, :]) & 0xF).astype(np.uint8)
        nib = nib.reshape(sel.size, BLOCK * kk)          # low nibble first
        byts = nib[:, 0::2] | (nib[:, 1::2] << 4)
        idx = starts[sel][:, None] + np.arange(BLOCK * kk // 2)[None, :]
        payload[idx.reshape(-1)] = byts.reshape(-1)
    return payload, wm


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2**32 (two's complement), explicitly: the
    decode's prefix sums wrap like the JAX package's int32 cumsums."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def decode_d24v_plain(payload: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
    """``(payload uint8, wm uint8) -> int32[n_blocks * BLOCK]`` in plain
    torch ops, equal to ``pluss.ops.wirecodec.decode_d24v``.

    Every sum runs in int64 and wraps to int32 once at the end: wrapping is
    a ring map mod 2**32, so this equals the JAX decoder's int32 sums that
    wrap at every step.  Word reads past the payload clamp to its last
    word, as the JAX gathers do.  Ids past the encoder's real length
    decode to its padding value: callers slice to the batch length.
    """
    k = (wm & 0x7).to(torch.int64)
    mode_raw = (wm & RAW_MODE) != 0
    nb = k.shape[0]
    b4 = payload.view(-1, 4).to(torch.int64)
    words = b4[:, 0] | (b4[:, 1] << 8) | (b4[:, 2] << 16) | (b4[:, 3] << 24)
    last_word = words.shape[0] - 1
    # every block starts on a word: its payload is k * 128 words long
    start = torch.cumsum(k * (BLOCK // 8), 0) - k * (BLOCK // 8)
    r = torch.arange(BLOCK, dtype=torch.int64, device=wm.device)
    bit = r[None, :] * (k[:, None] * 4)                  # [nb, BLOCK]
    word = start[:, None] + (bit >> 5)
    lo = words[word.clamp(max=last_word)]
    hi = words[(word + 1).clamp(max=last_word)]
    v = ((lo | (hi << 32)) >> (bit & 31)) & ((1 << (k[:, None] * 4)) - 1)
    d = (v >> 1) ^ -(v & 1)                              # zigzag inverse
    csum = torch.cumsum(d, 1)                            # block-local prefix
    # cross-block carry: the base of block b is the last id of block b-1.
    # Raw blocks know their last id absolutely; a run of delta blocks adds
    # its block sums onto the nearest raw last (or 0 at the batch head).
    idx = torch.arange(nb, dtype=torch.int64, device=wm.device)
    last_raw = torch.cummax(torch.where(mode_raw, idx, -1), 0).values
    p = torch.cumsum(torch.where(mode_raw, 0, csum[:, -1]), 0)
    lr = last_raw.clamp(min=0)
    c_raw = torch.where(last_raw >= 0, v[lr, -1], 0)
    p_raw = torch.where(last_raw >= 0, p[lr], 0)
    c = torch.where(mode_raw, v[:, -1], c_raw + (p - p_raw))  # last id of b
    base = torch.cat([c.new_zeros(1), c[:-1]])
    return _wrap32(torch.where(mode_raw[:, None], v,
                               base[:, None] + csum)).reshape(-1)
