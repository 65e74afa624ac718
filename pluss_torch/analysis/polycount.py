"""Exact lattice-point machinery for the symbolic reuse-interval pass.

The port's copy of ``pluss/analysis/polycount.py``.

:mod:`pluss_torch.analysis.ri` derives reuse-interval histograms *statically* —
no engine dispatch, no stream walk on a device.  What makes that possible
is that every supported nest shape gives each reference occurrence a
closed-form stream position and element address in the iteration vector
(:class:`pluss_torch.spec.FlatRef`): rectangular families are pure affine forms
(the Ehrhart-style uniform case — lattice counts of the reuse polyhedra
are periodic in the chunk schedule, see :func:`pluss_torch.analysis.ri` for the
closed-form composition), and the triangular/quad-contract families add
``tri(x) = x*(x-1)/2`` terms that stay exact polynomial counts.

This module holds the shared counting kernels:

- :func:`flatref_events` evaluates one FlatRef's (position, line, span)
  lattice over a set of owned parallel iterations — the same arithmetic
  as the engine's ``_ref_window`` (:mod:`pluss_torch.engine`), in host numpy,
  so the derived events are bit-identical to the device enumeration.
- :func:`scan_events` turns a position-ordered event block into exact
  reuse intervals against a carried last-access table — the PARDA-style
  decomposition of :mod:`pluss_torch.ops.reuse`, vectorized per block.
- :func:`pow2_floor` is the reference's insert-time log2 binning
  (``1 << (x.bit_length() - 1)``) as integer bit-smearing — no float
  ``log2`` anywhere, so binning is exact for any 63-bit reuse.

Everything here is integer numpy on the host; no device work.
"""

from __future__ import annotations

import numpy as np

from pluss_torch.config import SamplerConfig
from pluss_torch.spec import (FlatRef, Loop, LoopNestSpec, flatten_nest,
                        nest_iteration_sizes)

#: enumeration cells one event block may materialize (memory bound; the
#: iteration axis is blocked to stay under it)
BLOCK_CELLS = 1 << 22


def pow2_floor(x: np.ndarray) -> np.ndarray:
    """Highest power of two <= x, elementwise, for x >= 1 (int64).

    The reference's insert-time binning is ``1 << (bit_length - 1)``
    (``_pluss_histogram_update``, utils.rs:142-152); bit-smearing computes
    the same without a Python loop or float rounding.
    """
    x = np.asarray(x, np.int64)
    for s in (1, 2, 4, 8, 16, 32):
        x = x | (x >> s)
    return x - (x >> 1)


def tri(x):
    """tri(x) = x*(x-1)//2 — the quad contract's closed-form term."""
    return x * (x - 1) // 2


def ref_box_cells(fr: FlatRef) -> int:
    """Lattice cells one parallel iteration of this ref enumerates (the
    static inner box; bounded levels count at their declared maximum)."""
    n = 1
    for t in fr.trips[1:]:
        n *= max(int(t), 0)
    return n


def nest_cells(nest: Loop) -> int:
    """Enumeration cells of one nest = trip * sum of per-ref boxes."""
    return max(int(nest.trip), 0) * sum(
        ref_box_cells(fr) for fr in flatten_nest(nest))


def spec_cells(spec: LoopNestSpec) -> int:
    """Total enumeration cells of a dense derivation of ``spec``."""
    return sum(nest_cells(nest) for nest in spec.nests)


def flatref_events(fr: FlatRef, nest: Loop, gs: np.ndarray,
                   clks: np.ndarray, line_base: int, line_count: int,
                   cfg: SamplerConfig):
    """(pos, line, span) int64 arrays of one ref over parallel iterations
    ``gs`` (global indices) with per-iteration start clocks ``clks``.

    Replicates the engine's ``_ref_window`` evaluation exactly: positions
    are the thread-stream clock at the access, addresses the affine form
    over iteration VALUES, lines ``base + addr*ds//cls``.  Invalid lattice
    cells (bounded levels) are masked out.  Lines are clipped into the
    array's range — out-of-range addresses are impossible for lint-clean
    specs (PL101 gates prediction), the clip just keeps a hostile spec
    from indexing outside the last-access table.
    """
    d = len(fr.trips)
    nd = 1 + (d - 1)

    def axis(arr, ax):
        return np.asarray(arr, np.int64).reshape(
            (1,) * ax + (-1,) + (1,) * (nd - ax - 1))

    g = axis(gs, 0)
    pos = axis(clks, 0) + fr.offset + fr.offset_k * g
    if fr.offset_g2:
        pos = pos + fr.offset_g2 * tri(g)
    addr = fr.ref.addr_base + fr.addr_coefs[0] * (
        nest.start + g * nest.step)
    valid = np.ones((len(gs),) + tuple(int(t) for t in fr.trips[1:]),
                    bool)
    idxs = {}
    for l in range(1, d):
        idx = axis(np.arange(int(fr.trips[l])), l)
        idxs[l] = idx
        sk = fr.pos_strides_k[l] if fr.pos_strides_k else 0
        pos = pos + idx * (fr.pos_strides[l] + sk * g)
        if fr.pos_quads and fr.pos_quads[l]:
            pos = pos + fr.pos_quads[l] * tri(idx)
        if fr.bounds and fr.bounds[l] is not None:
            a, b = fr.bounds[l]
            valid = valid & (idx < a + b * g)
        if fr.addr_coefs[l]:
            start_l = fr.starts[l]
            if fr.starts_k and fr.starts_k[l]:
                start_l = start_l + fr.starts_k[l] * g
            addr = addr + fr.addr_coefs[l] * (start_l + idx * fr.steps[l])
    for lv, a, b, rl in fr.inner_bounds or ():
        valid = valid & (idxs[lv] < a + b * idxs[rl])
    line = line_base + np.clip(addr * cfg.ds // cfg.cls, 0,
                               line_count - 1)
    if valid.all():
        # rectangular fast path: no constrained level, every lattice cell
        # is an access — a plain broadcast copy beats the boolean gather
        line = np.ascontiguousarray(
            np.broadcast_to(line, valid.shape)).ravel()
        pos = np.ascontiguousarray(
            np.broadcast_to(pos, valid.shape)).ravel()
    else:
        line = np.broadcast_to(line, valid.shape)[valid]
        pos = np.broadcast_to(pos, valid.shape)[valid]
    span = np.full(len(line), fr.ref.share_span or 0, np.int64)
    return pos, line, span


def nest_block_events(nest: Loop, frs: list[FlatRef], gs: np.ndarray,
                      clks: np.ndarray, line_base_of, line_count_of,
                      cfg: SamplerConfig):
    """Concatenated (pos, line, span) of every ref of ``nest`` over the
    iteration block ``gs`` — one scan_events input."""
    parts = [
        flatref_events(fr, nest, gs, clks, line_base_of(fr.ref.array),
                       line_count_of(fr.ref.array), cfg)
        for fr in frs
    ]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts]))


def scan_events(last_pos: np.ndarray, pos: np.ndarray, line: np.ndarray,
                span: np.ndarray, count_from: int | None = None):
    """One exact reuse scan of a position-ordered event block.

    ``last_pos`` is the carried dense last-access table (global line ->
    last stream position, -1 cold), updated in place; blocks MUST arrive
    in nondecreasing position order per thread.  Returns
    ``(ns_keys, ns_cnts, sh_keys, sh_cnts, n_cold)``: log2-binned noshare
    reuse keys with counts, raw share reuse keys with counts, and the
    number of first-touch (cold) accesses in the block.  Classification
    is the reference's: share iff ``span > 0 and 2*reuse > span`` using
    the LATER access's span; cold accesses emit no event (the end-of-run
    flush accounts for them).  ``count_from``: only accesses at positions
    >= it contribute events (the table still updates from all — the
    suffix-window tail composition of :mod:`pluss_torch.analysis.ri`).
    """
    empty = np.empty(0, np.int64)
    if not len(pos):
        return empty, empty, empty, empty, 0
    # one composite-key argsort beats lexsort's two stable passes; the
    # key packs (line, pos) losslessly whenever both fit 63 bits
    p_hi = int(pos.max())
    l_hi = int(line.max())
    shift = max(p_hi, 0).bit_length()
    if l_hi.bit_length() + shift < 63:
        order = np.argsort((line << shift) | pos)
    else:
        order = np.lexsort((pos, line))
    ls, ps, sp = line[order], pos[order], span[order]
    first = np.empty(len(ls), bool)
    first[0] = True
    first[1:] = ls[1:] != ls[:-1]
    prev = np.empty(len(ls), np.int64)
    prev[1:][~first[1:]] = ps[:-1][~first[1:]]
    prev[first] = last_pos[ls[first]]
    # update the carry before any early return: last event per line
    last = np.empty(len(ls), bool)
    last[-1] = True
    last[:-1] = ls[1:] != ls[:-1]
    last_pos[ls[last]] = ps[last]
    reuse = ps - prev
    seen = prev >= 0
    n_cold = int((~seen).sum())
    if count_from is not None:
        counted = ps >= count_from
        n_cold = int((~seen & counted).sum())
        seen = seen & counted
    shr = seen & (sp > 0) & (2 * reuse > sp)
    nsh = seen & ~shr
    if nsh.any():
        # unique BEFORE binning: raw reuses are massively duplicated in
        # the uniform families, so the bit-smear runs on the few distinct
        # values; pow2_floor is monotone, so equal bins are adjacent
        rk, rc = np.unique(reuse[nsh], return_counts=True)
        bk = pow2_floor(rk)
        cut = np.flatnonzero(np.concatenate(([True], bk[1:] != bk[:-1])))
        ns_keys, ns_cnts = bk[cut], np.add.reduceat(rc, cut)
    else:
        ns_keys, ns_cnts = empty, empty
    sh_keys, sh_cnts = np.unique(reuse[shr], return_counts=True) \
        if shr.any() else (empty, empty)
    return ns_keys, ns_cnts, sh_keys, sh_cnts, n_cold


def bump(hist: dict, keys: np.ndarray, cnts: np.ndarray) -> None:
    """Add (keys, counts) into a {int: float} histogram dict — the same
    value format as ``SamplerResult.noshare_dict``/``share_dict``."""
    for k, c in zip(keys.tolist(), cnts.tolist()):
        hist[k] = hist.get(k, 0.0) + float(c)


def owned_iterations(sched, tid: int) -> np.ndarray:
    """Global iteration indices thread ``tid`` owns, execution order."""
    CS = sched.chunk_size
    out = []
    for cid in sched.chunks_of_thread(tid):
        b, e = sched.chunk_index_range(cid)
        out.append(np.arange(b, e, dtype=np.int64))
    if not out:
        return np.empty(0, np.int64)
    return np.concatenate(out)


def start_clocks(nest: Loop, gs: np.ndarray, base: int) -> np.ndarray:
    """Per-iteration start clocks of a thread's owned iterations ``gs``:
    ``base`` (the thread's clock entering the nest) plus the exclusive
    running sum of the exact per-iteration access counts."""
    if not len(gs):
        return np.empty(0, np.int64)
    sizes = np.asarray(nest_iteration_sizes(nest, gs), np.int64)
    return base + np.concatenate(
        ([0], np.cumsum(sizes[:-1], dtype=np.int64)))


def iteration_blocks(gs: np.ndarray, cells_per_iter: int,
                     budget: int = BLOCK_CELLS):
    """Split an iteration vector into contiguous blocks of at most
    ``budget`` enumeration cells (always at least one iteration)."""
    step = max(1, budget // max(1, cells_per_iter))
    for i in range(0, len(gs), step):
        yield i, min(i + step, len(gs))
