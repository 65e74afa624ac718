"""CRI model: per-thread reuse intervals -> whole-system reuse intervals.

Host post-pass (numpy, f64), the port's copy of ``pluss/cri.py``, preserving
the reference's exact statistics (``utils.rs:213-349``,
``pluss_utils.h:986-1208``):

1. **NBD dilation** — a thread-local reuse of length n is stretched by the
   other threads' interleaved accesses; the number of foreign accesses k
   follows NegativeBinomial(r=n, p=1/T).  Terms accumulate until mass >
   0.9999 (the crossing term included); n >= 4000*(T-1)/T short-circuits to
   a point mass at T*n.
2. **No-share distribute** — merge per-thread no-share histograms, pass cold
   (key < 0) through, NBD-dilate the rest into the log2-binned histogram.
3. **Racetrack** — share reuses are split across log2 bins with
   ``prob[i] = (1-2^(i-1)/ri)^n - (1-2^i/ri)^n`` and the *last computed bin
   overwritten* by the residual ``1-prob_sum`` (pluss_utils.h:1078-1093),
   emitting ``new_ri = 2^(i-1)``.

The histograms are tiny, so matching the C++ doubles on the host is worth
more than device offload.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from pluss_torch.config import NBD_CUTOFF_COEF, NBD_MASS_CUT

try:  # scipy is optional; the fallback is the same function, scalar
    from scipy.special import gammaln as _gammaln
except ImportError:  # pragma: no cover
    _gammaln = np.vectorize(math.lgamma, otypes=[np.float64])

Histogram = dict  # key: int reuse (or -1 cold); value: float count


def histogram_update(hist: Histogram, reuse: int, cnt: float) -> None:
    """``_pluss_histogram_update`` (utils.rs:142-152): log2-bin positive keys."""
    if reuse > 0:
        reuse = 1 << (int(reuse).bit_length() - 1)
    hist[reuse] = hist.get(reuse, 0.0) + cnt


def merge(hists: list[Histogram]) -> Histogram:
    """Plain key-wise sum (the reference's per-thread merge loops)."""
    out: Histogram = {}
    for h in hists:
        for k, v in h.items():
            out[k] = out.get(k, 0.0) + v
    return out


@functools.lru_cache(maxsize=4096)
def nbd_dilate(thread_cnt: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """``_pluss_cri_nbd`` (utils.rs:213-236): (system reuse values, pmf).

    Keys ``n + k`` for k = 0..K, K the first index where the cumulative pmf
    exceeds NBD_MASS_CUT (that term included), or the single point mass
    ``T*n`` past the cutoff.  Memoized; the cached arrays are read-only.
    """
    if n >= NBD_CUTOFF_COEF * (thread_cnt - 1) / thread_cnt:
        keys = np.array([thread_cnt * n], np.int64)
        pmf = np.array([1.0])
        keys.setflags(write=False)
        pmf.setflags(write=False)
        return keys, pmf
    p = 1.0 / thread_cnt
    r = float(n)
    # mean of NB(r, p) is r(1-p)/p = (T-1)n; 0.9999 mass sits within a few stds
    block = max(64, int((thread_cnt - 1) * n * 2) + 64)
    ks = np.arange(0, block, dtype=np.float64)
    while True:
        pmf = np.exp(
            _gammaln(ks + r) - _gammaln(ks + 1.0) - _gammaln(r)
            + r * math.log(p) + ks * math.log1p(-p)
        )
        cum = np.cumsum(pmf)
        over = np.nonzero(cum > NBD_MASS_CUT)[0]
        if over.size:
            stop = int(over[0]) + 1  # include the crossing term
            keys = np.arange(stop, dtype=np.int64) + n
            pmf = pmf[:stop]
            keys.setflags(write=False)
            pmf.setflags(write=False)
            return keys, pmf
        ks = np.arange(0, ks.size * 2, dtype=np.float64)  # pragma: no cover


@functools.lru_cache(maxsize=4096)
def nbd_dilate_p(p: float, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Heterogeneous-rate NBD dilation: ``nbd_dilate`` generalized from
    T identical threads (slot-ownership probability 1/T) to an arbitrary
    ownership probability ``p`` in (0, 1] — the share of the interleaved
    access stream this thread owns when K co-scheduled workloads with
    different access rates compete for one cache (the r15 co-tenancy
    composition, :mod:`pluss_torch.analysis.interference`).

    ``p = 1/T`` reproduces ``nbd_dilate(T, n)`` exactly: the cutoff
    ``n >= NBD_CUTOFF_COEF * (1 - p)`` equals the homogeneous
    ``NBD_CUTOFF_COEF * (T-1)/T`` and the point mass ``round(n / p)``
    equals ``T * n``.  Same mass-cut accumulation, same pmf
    parameterization, same frozen memoized arrays.
    """
    if p >= 1.0:
        keys = np.array([n], np.int64)
        pmf = np.array([1.0])
        keys.setflags(write=False)
        pmf.setflags(write=False)
        return keys, pmf
    if n >= NBD_CUTOFF_COEF * (1.0 - p):
        keys = np.array([int(round(n / p))], np.int64)
        pmf = np.array([1.0])
        keys.setflags(write=False)
        pmf.setflags(write=False)
        return keys, pmf
    r = float(n)
    block = max(64, int(n * (1.0 - p) / p * 2) + 64)
    ks = np.arange(0, block, dtype=np.float64)
    while True:
        pmf = np.exp(
            _gammaln(ks + r) - _gammaln(ks + 1.0) - _gammaln(r)
            + r * math.log(p) + ks * math.log1p(-p)
        )
        cum = np.cumsum(pmf)
        over = np.nonzero(cum > NBD_MASS_CUT)[0]
        if over.size:
            stop = int(over[0]) + 1  # include the crossing term
            keys = np.arange(stop, dtype=np.int64) + n
            pmf = pmf[:stop]
            keys.setflags(write=False)
            pmf.setflags(write=False)
            return keys, pmf
        ks = np.arange(0, ks.size * 2, dtype=np.float64)  # pragma: no cover


def noshare_distribute(noshare: list[Histogram], rihist: Histogram,
                       thread_cnt: int) -> None:
    """``_pluss_cri_noshare_distribute`` (utils.rs:307-344).  Keys are
    consumed in sorted order, so the float accumulation depends only on the
    histogram contents."""
    for k, v in sorted(merge(noshare).items()):
        if k < 0:
            histogram_update(rihist, k, v)
            continue
        if thread_cnt > 1:
            keys, pmf = nbd_dilate(thread_cnt, k)
            for kk, vv in zip(keys, pmf):
                histogram_update(rihist, int(kk), v * float(vv))
        else:
            histogram_update(rihist, k, v)


def _racetrack_emit(ri: np.ndarray, w: np.ndarray, n: float,
                    rihist: Histogram) -> None:
    """The reference's racetrack bin split (pluss_utils.h:1076-1097),
    vectorized over [M] dilated reuses: the exact-1.0 early break keeps
    later bins uncomputed and skips the overwrite; otherwise the last
    computed bin is overwritten by the residual; a reuse < 2 emits
    everything at key 0."""
    ri = np.asarray(ri, np.float64)
    w = np.asarray(w, np.float64)
    # bins i = 1..B(ri): largest i with 2^i <= ri
    B = np.where(ri >= 2, np.floor(np.log2(np.maximum(ri, 2.0))), 0.0)
    B = B.astype(np.int64)
    # floor(log2) can be off by one at exact powers under FP; fix exactly
    B = np.where(2.0 ** (B + 1) <= ri, B + 1, B)
    B = np.where(2.0 ** B > ri, B - 1, B)
    Imax = int(B.max(initial=0))
    if Imax == 0:
        rihist[0] = rihist.get(0, 0.0) + float(w.sum())
        return
    i = np.arange(1, Imax + 1, dtype=np.float64)[None, :]
    live = i <= B[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        probs = np.where(
            live,
            (1.0 - 2.0 ** (i - 1) / ri[:, None]) ** n
            - (1.0 - 2.0 ** i / ri[:, None]) ** n,
            0.0,
        )
    csum = np.add.accumulate(probs, axis=1)
    hit = csum == 1.0
    any_hit = hit.any(axis=1)
    first_hit = np.where(any_hit, hit.argmax(axis=1), Imax)  # 0-based
    live &= np.arange(Imax)[None, :] <= first_hit[:, None]
    probs = np.where(live, probs, 0.0)
    last = np.maximum(B - 1, 0)
    prob_sum = np.where(any_hit, 1.0,
                        csum[np.arange(len(ri)), np.maximum(B, 1) - 1])
    needs = ~any_hit
    probs[needs, last[needs]] = np.where(B[needs] >= 1,
                                         1.0 - prob_sum[needs], 0.0)
    zero_w = np.where(B == 0, w, 0.0)
    if zero_w.any():
        rihist[0] = rihist.get(0, 0.0) + float(zero_w.sum())
    # emission keys 2^(b-1) are powers of two: log2 binning is the identity
    per_bin = (probs * w[:, None]).sum(axis=0)
    for b in range(1, Imax + 1):
        v = float(per_bin[b - 1])
        if v:
            key = 1 << (b - 1)
            rihist[key] = rihist.get(key, 0.0) + v


def racetrack(share: list[Histogram], rihist: Histogram,
              thread_cnt: int) -> None:
    """``_pluss_cri_racetrack`` (utils.rs:238-301).

    ``share``: per-thread {share_ratio: {raw reuse: count}}.  Past-cutoff
    reuses dilate to a point mass in bulk; the sub-cutoff ones run the full
    NBD and join the same vectorized bin split.
    """
    merged: dict[int, Histogram] = {}
    for h in share:
        for n_key, hist in h.items():
            m = merged.setdefault(n_key, {})
            for r, c in hist.items():
                m[r] = m.get(r, 0.0) + c
    cut = NBD_CUTOFF_COEF * (thread_cnt - 1) / thread_cnt \
        if thread_cnt > 1 else 0.0
    for n_key in sorted(merged):
        hist = merged[n_key]
        n = float(n_key)
        if thread_cnt <= 1:
            for r in sorted(hist):
                histogram_update(rihist, r, hist[r])
            continue
        items = sorted(hist.items())
        rs = np.fromiter((k for k, _ in items), np.int64, len(items))
        cs = np.fromiter((v for _, v in items), np.float64, len(items))
        big = rs >= cut
        ri_parts = [thread_cnt * rs[big]]
        w_parts = [cs[big]]
        for r, c in zip(rs[~big].tolist(), cs[~big].tolist()):
            keys, pmf = nbd_dilate(thread_cnt, r)
            ri_parts.append(keys)
            w_parts.append(c * pmf)
        ri = np.concatenate(ri_parts)
        w = np.concatenate(w_parts)
        if ri.size:
            _racetrack_emit(ri, w, n, rihist)


def distribute(noshare: list[Histogram], share: list[Histogram],
               thread_cnt: int) -> Histogram:
    """``pluss_cri_distribute`` (utils.rs:346-349): a fresh result per call."""
    rihist: Histogram = {}
    noshare_distribute(noshare, rihist, thread_cnt)
    racetrack(share, rihist, thread_cnt)
    return rihist
