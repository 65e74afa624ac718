"""The CRI reuse histogram and the AET miss-ratio curve, in plain numpy.

The benchmark's own reading of PLUSS's post-pass, from its published
statistics:

- **Noshare.** The threads' noshare histograms are summed key by key.  The
  cold key passes through.  With ``T > 1`` threads a reuse ``n`` is
  dilated by the other threads' accesses: ``n + k`` with the pmf of
  NegativeBinomial(r=n, p=1/T) at ``k``, for k = 0, 1, ... up to and
  including the first term at which the running mass exceeds 0.9999; from
  ``n >= 4000*(T-1)/T`` on, all of it sits at ``T*n``.  Each dilated key
  is binned at ``2**floor(log2(key))``.
- **Share** (the racetrack).  Each share reuse ``r`` is dilated the same
  way; each dilated ``ri`` splits over the bins ``i = 1, 2, ...`` while
  ``2**i <= ri`` with ``(1 - 2**(i-1)/ri)**n - (1 - 2**i/ri)**n`` (``n`` =
  the share ratio ``T-1``), emitted at ``2**(i-1)``; the split stops early
  when the running sum equals 1.0, and otherwise the last computed bin is
  overwritten by ``1 - sum`` (the sum including it).  ``ri < 2`` puts all
  of it at key 0.  With one thread, reuses pass through.
- **MRC.** ``P[k]`` for each key but -1, from the largest down, is the
  mass of the cold key and of every larger key over the total; ``P[0] =
  1``.  A cursor ``t`` walks up from 0 adding ``P`` of the largest key at
  most ``t``; the miss ratio at cache size ``c`` (0 up to the lesser of the
  largest key and the cache's 8-byte entries) is that step value at the
  cursor's last step once the sum reaches ``c``, the cursor stopping past
  the largest key.

``dtype`` is the precision every product and sum is taken in: float64 for
the reference, float32 for the lower-precision control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NBD_CUTOFF = 4000.0
NBD_MASS = 0.9999


def _bin(key: int) -> int:
    return 1 << (int(key).bit_length() - 1) if key > 0 else key


def nbd(T: int, n: int, dtype=np.float64) -> tuple[np.ndarray, np.ndarray]:
    """(dilated keys, pmf) of a thread-local reuse ``n``."""
    if n >= NBD_CUTOFF * (T - 1) / T:
        return np.array([T * n], np.int64), np.ones(1, dtype)
    p = 1.0 / T
    size = 64 + 2 * (T - 1) * n + 64
    while True:
        k = torch.arange(size, dtype=torch.float64)
        lp = (torch.lgamma(k + n) - torch.lgamma(k + 1.0)
              - math.lgamma(n) + n * math.log(p) + k * math.log1p(-p))
        pmf = torch.exp(lp).numpy().astype(dtype)
        cum = np.cumsum(pmf, dtype=dtype)
        over = np.flatnonzero(cum > dtype(NBD_MASS))
        if over.size:
            stop = int(over[0]) + 1
            return np.arange(stop, dtype=np.int64) + n, pmf[:stop]
        size *= 2


def _add(hist: dict, key: int, v, dtype) -> None:
    hist[key] = dtype(hist.get(key, dtype(0)) + v)


def _racetrack(ri: np.ndarray, w: np.ndarray, n: float, rihist: dict,
               dtype) -> None:
    """Split each dilated share reuse ``ri`` (weight ``w``) over its bins;
    the entries are taken in groups with the same number of bins."""
    one, nn = dtype(1.0), dtype(n)
    nb = np.zeros(len(ri), np.int64)   # bins: the largest i with 2**i <= ri
    for i in range(1, 64):
        more = (1 << i) <= ri
        if not more.any():
            break
        nb[more] = i
    low = w[nb == 0]
    if low.size:
        _add(rihist, 0, np.sum(low, dtype=dtype), dtype)
    for B in np.unique(nb[nb > 0]).tolist():
        rows = nb == B
        rf = ri[rows].astype(dtype)[:, None]
        i = np.arange(1, B + 1, dtype=np.float64)[None, :]
        lo = (one - (2.0 ** (i - 1)).astype(dtype) / rf) ** nn
        hi = (one - (2.0 ** i).astype(dtype) / rf) ** nn
        prob = (lo - hi).astype(dtype)
        csum = np.cumsum(prob, axis=1, dtype=dtype)
        hit = csum == one
        first = np.where(hit.any(axis=1), hit.argmax(axis=1), B)
        keep = np.arange(B)[None, :] <= first[:, None]
        prob = np.where(keep, prob, dtype(0))
        miss = first == B
        prob[miss, B - 1] = one - csum[miss, B - 1]
        per_bin = np.sum(prob * w[rows].astype(dtype)[:, None], axis=0,
                         dtype=dtype)
        for b in range(B):
            if per_bin[b]:
                _add(rihist, 1 << b, per_bin[b], dtype)


def distribute(noshare: list, share: list, T: int,
               dtype=np.float64) -> dict:
    """The whole-system reuse histogram of per-thread ``noshare`` ({key:
    count}) and ``share`` ({reuse: count}) histograms."""
    rihist: dict = {}
    merged: dict = {}
    for h in noshare:
        for k, v in h.items():
            merged[k] = dtype(merged.get(k, dtype(0)) + dtype(v))
    for k in sorted(merged):
        v = merged[k]
        if k < 0 or T == 1:
            _add(rihist, _bin(k), v, dtype)
            continue
        keys, pmf = nbd(T, k, dtype)
        e = np.floor(np.log2(keys.astype(np.float64))).astype(np.int64)
        e += (np.left_shift(1, e + 1) <= keys).astype(np.int64)
        e -= (np.left_shift(1, e) > keys).astype(np.int64)
        starts = np.flatnonzero(np.diff(e, prepend=-1))
        sums = np.add.reduceat((v * pmf).astype(dtype), starts)
        for b, sv in zip(e[starts].tolist(), sums):
            _add(rihist, 1 << b, sv, dtype)
    sh: dict = {}
    for h in share:
        for r, c in h.items():
            sh[r] = dtype(sh.get(r, dtype(0)) + dtype(c))
    if T == 1:
        for r in sorted(sh):
            _add(rihist, _bin(r), sh[r], dtype)
        return rihist
    ri_parts, w_parts = [], []
    for r in sorted(sh):
        keys, pmf = nbd(T, r, dtype)
        ri_parts.append(keys)
        w_parts.append((sh[r] * pmf).astype(dtype))
    if ri_parts:
        _racetrack(np.concatenate(ri_parts), np.concatenate(w_parts),
                   float(T - 1), rihist, dtype)
    return rihist


def aet_mrc(rihist: dict, cache_kb: int, dtype=np.float64) -> np.ndarray:
    """Miss ratio at each cache size 0..min(largest key, cache entries)."""
    if not rihist or max(rihist) < 0:
        return np.ones(1, dtype)
    total = dtype(0)
    for v in rihist.values():
        total = dtype(total + v)
    keys = sorted(k for k in rihist if k != -1)
    acc = dtype(rihist.get(-1, 0))
    P = {}
    for k in reversed(keys):
        P[k] = dtype(acc / total)
        acc = dtype(acc + rihist[k])
    P[0] = dtype(1.0)
    ks = np.array(sorted(P), np.int64)
    vs = np.array([P[k] for k in ks.tolist()], dtype)
    max_rt = max(rihist)
    ends = np.append(ks[1:], max_rt + 1)
    seg = np.cumsum(vs * (ends - ks).astype(dtype), dtype=dtype)
    c_max = min(max_rt, cache_kb * 1024 // 8)
    cs = np.arange(1, c_max + 1, dtype=dtype)
    j = np.minimum(np.searchsorted(seg, cs, side="left"), len(ks) - 1)
    return np.concatenate([np.ones(1, dtype), vs[j]])
