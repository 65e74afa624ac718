"""Sweep groups: closed-form histograms for D+S array pairs in triangular
nests (the port's copy of ``pluss/sweepgroup.py``), the companion of
:mod:`pluss_torch.rowpriv` for the other half of the stream.

After row-private extraction, syrk_tri's device sort still walks its ``A``
array: ``D = A0 = A[i][k]`` (the top row, walked by the mid loop, moving
with the parallel loop) and ``S = A1 = A[j][k]`` (a sweep over all rows
``j <= i`` every iteration).  With line ``(r, o)`` = row r, column-octave
``o = k // lpe``:

- S touches ``(r, o)`` once per ``k`` of octave o (at ``j = r``): ``lpe``
  touches with uniform gap ``S_k``, one head per iteration;
- D touches only the top row ``(g, o)``: per ``k``, ``m`` consecutive
  touches at gap ``s_j``, the S touch at ``j = g`` rides ``off_S - off_D``
  behind D's last, and the bridge back to the next ``k``'s first D touch
  closes the octave;
- cross-iteration heads resolve against the previous owned iteration's
  octave-o last touch — closed form because the schedule is — and rows
  the triangle just grew are colds.

Six gap classes, affine in ``(g, o)``.  Share classification applies the
accessing ref's span per class, so the cross-iteration heads land raw in
the share dict and everything else bins — no device work at all.  The
array's contribution becomes a ``[T, NW, NBINS]`` table plus per-thread
static share (value, count) dicts.

Exactness is checked, not argued: a per-slot count invariant (class counts
must sum to the iteration's exact D+S stream length) runs for every slot,
and sampled (previous, current) iteration pairs replay through a brute
two-iteration lexsort oracle; any mismatch leaves the refs on the sort
path.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pluss_torch.config import NBINS, SamplerConfig
from pluss_torch.ops.reuse import share_mask
from pluss_torch.spec import FlatRef, LoopNestSpec, flatten_nest


def eligible(spec: LoopNestSpec, ni: int, frs: list[FlatRef],
             cfg: SamplerConfig, sched) -> str | None:
    """None if the array's refs form an eligible (D, S) sweep pair."""
    arr = frs[0].ref.array
    for oi, nest in enumerate(spec.nests):
        if oi != ni and any(fr.ref.array == arr
                            for fr in flatten_nest(nest)):
            return f"array {arr} is touched by nest {oi} too"
    if len(frs) != 2:
        return "not exactly two refs"
    d = [fr for fr in frs if fr.addr_coefs[0]]
    s = [fr for fr in frs if not fr.addr_coefs[0]]
    if len(d) != 1 or len(s) != 1:
        return "no unique (moving, sweeping) split"
    d, s = d[0], s[0]
    if len(d.trips) != 3 or len(s.trips) != 3:
        return "level chain is not (parallel, mid, inner)"
    if d.trips != s.trips or d.pos_strides != s.pos_strides or \
            d.pos_strides_k != s.pos_strides_k or d.bounds != s.bounds or \
            d.starts != s.starts or d.steps != s.steps or \
            (d.starts_k or (0, 0, 0)) != (s.starts_k or (0, 0, 0)):
        return "refs differ beyond their position offset"
    if d.bounds is None or d.bounds[2] != (1, 1) or d.bounds[1] is not None:
        return "inner bound is not the (1, 1) triangle"
    if any(d.starts[1:]) or any(d.steps[l] != 1 for l in (1, 2)) or \
            (d.starts_k and any(d.starts_k)):
        return "mid/inner walks are not 0-based unit walks"
    c0 = d.addr_coefs[0]
    # D: addr = base + c0*g + 1*k (top row, walked by the mid loop);
    # S: addr = base + c0*j + 1*k (row j, same column walk)
    if d.addr_coefs[1] != 1 or d.addr_coefs[2] != 0:
        return "moving ref is not a mid-walked top row"
    if s.addr_coefs[1] != 1 or s.addr_coefs[2] != c0:
        return "sweeping ref does not stride the same row space"
    if s.offset <= d.offset or s.offset_k != d.offset_k:
        return "sweeping ref does not trail the moving ref in the body"
    if d.ref.addr_base != s.ref.addr_base:
        return "refs disagree on the base address"
    if d.ref.share_span:
        return "moving ref carries a share span"
    if sched.start != 0 or sched.step != 1:
        return "parallel loop is not a 0-based unit walk"
    ds, cls = cfg.ds, cfg.cls
    if cls % ds:
        return "element size does not divide the line size"
    lpe = cls // ds
    K = d.trips[1]
    if K % lpe:
        return "mid trip not a whole number of line octaves"
    if (c0 * ds) % cls or (d.ref.addr_base * ds) % cls:
        return "rows are not cache-line aligned"
    if d.trips[2] - 1 >= c0:
        return "row walk spills into the next row"
    return None


def brute_pair_hist(d: FlatRef, s: FlatRef, cfg: SamplerConfig,
                    g_prev: int | None, g: int,
                    clk_prev: int, clk: int):
    """(hist [NBINS], share {value: count}) of iteration ``g``'s D+S
    events, with iteration ``g_prev`` (same thread) as the warm-up that
    seeds the table — the verification oracle for one slot."""
    ds, cls = cfg.ds, cfg.cls

    def stream(fr, gi, clk0):
        m = min(1 + gi, fr.trips[2])
        K = fr.trips[1]
        k = np.arange(K)[:, None]
        j = np.arange(m)[None, :]
        sk = fr.pos_strides[1] + (fr.pos_strides_k[1] if fr.pos_strides_k
                                  else 0) * gi
        sj = fr.pos_strides[2] + (fr.pos_strides_k[2] if fr.pos_strides_k
                                  else 0) * gi
        pos = clk0 + fr.offset + fr.offset_k * gi + k * sk + j * sj
        addr = fr.ref.addr_base + fr.addr_coefs[0] * gi \
            + fr.addr_coefs[1] * k + fr.addr_coefs[2] * j
        addr = np.broadcast_to(addr, pos.shape)
        span = fr.ref.share_span or 0
        return (pos.ravel(), (addr.ravel() * ds) // cls,
                np.full(pos.size, span, np.int64))

    parts = []
    if g_prev is not None:
        parts += [stream(d, g_prev, clk_prev), stream(s, g_prev, clk_prev)]
    parts += [stream(d, g, clk), stream(s, g, clk)]
    pos = np.concatenate([p[0] for p in parts])
    line = np.concatenate([p[1] for p in parts])
    span = np.concatenate([p[2] for p in parts])
    order = np.lexsort((pos, line))
    line_s, pos_s, span_s = line[order], pos[order], span[order]
    same = np.concatenate([[False], line_s[1:] == line_s[:-1]])
    cur = pos_s >= clk
    hist = np.zeros(NBINS, np.int64)
    share: dict = {}
    gaps = pos_s[1:] - pos_s[:-1]
    ev = same[1:] & cur[1:]
    sh = ev & share_mask(gaps, span_s[1:])
    ns = ev & ~sh
    if ns.any():
        np.add.at(hist, np.frexp(gaps[ns].astype(np.float64))[1]
                  .astype(np.int64), 1)
    for v in gaps[sh].tolist():
        share[v] = share.get(v, 0) + 1
    hist[0] = int((~same & cur).sum())
    return hist, share


def _derive_thread(d: FlatRef, s: FlatRef, cfg: SamplerConfig, sched,
                   owned_row: np.ndarray, W: int, NW: int,
                   clock_row: np.ndarray):
    """One thread's A-contribution: (hist_w [NW, NBINS], share dict,
    slot table for verification) — or None if any invariant fails."""
    ds, cls = cfg.ds, cfg.cls
    lpe = cls // ds
    CS = cfg.chunk_size
    K = d.trips[1]
    C = K // lpe
    mt = d.trips[2]

    slots = owned_row[:, None].astype(np.int64) * CS + np.arange(CS)
    slots = slots.reshape(-1)
    valid = (np.repeat(owned_row >= 0, CS)) & (slots < sched.trip)
    idx = np.nonzero(valid)[0]
    if idx.size == 0:
        return np.zeros((NW, NBINS), np.int64), {}, []
    g = slots[idx]
    clk = clock_row[idx]
    win = idx // (W * CS)
    m = np.minimum(1 + g, mt)
    S_k = d.pos_strides[1] + (d.pos_strides_k[1] if d.pos_strides_k
                              else 0) * g
    s_j = d.pos_strides[2] + (d.pos_strides_k[2] if d.pos_strides_k
                              else 0) * g
    off_D = d.offset + d.offset_k * g
    off_S = s.offset + s.offset_k * g
    n_s = idx.size
    # previous owned iteration (shift by one in the valid sequence)
    has_prev = np.arange(n_s) > 0
    m_prev = np.where(has_prev, np.concatenate([[0], m[:-1]]), 0)
    clk_prev = np.concatenate([[0], clk[:-1]])
    S_k_prev = np.concatenate([[0], S_k[:-1]])
    off_S_prev = np.concatenate([[0], off_S[:-1]])

    hist_w = np.zeros((NW, NBINS), np.int64)
    share: dict = {}
    total = np.zeros(n_s, np.int64)   # per-slot event count invariant

    def emit(vals, counts, span, win_idx):
        """One gap class: split share/noshare, bin, count."""
        vals = np.asarray(vals, np.int64)
        counts = np.asarray(counts, np.int64)
        vals, counts = np.broadcast_arrays(vals, counts)
        live = counts > 0
        if not live.any():
            return True
        if (vals[live] < 1).any():
            return False
        w_idx = np.broadcast_to(win_idx, vals.shape)
        np.add.at(total, np.broadcast_to(
            np.arange(n_s).reshape((-1,) + (1,) * (vals.ndim - 1)),
            vals.shape)[live], counts[live])
        sh = live & share_mask(vals, np.int64(span)) if span else \
            np.zeros_like(live)
        ns = live & ~sh
        if ns.any():
            bins = np.frexp(vals[ns].astype(np.float64))[1].astype(np.int64)
            np.add.at(hist_w, (w_idx[ns], bins), counts[ns])
        if sh.any():
            for v, cnt in zip(vals[sh].tolist(), counts[sh].tolist()):
                share[v] = share.get(v, 0) + cnt
        return True

    span_S = s.ref.share_span or 0
    o = np.arange(C)[None, :]                     # [1, C] octave ids
    winc = np.broadcast_to(win[:, None], (n_s, C))

    ok = True
    # A. S intra-octave gaps: rows r < g, lpe touches per line at gap S_k
    ok = ok and (lpe == 1 or emit(S_k, (m - 1) * C * (lpe - 1), span_S,
                                  win))
    # B. cross-iteration heads: rows r <= g_prev (every previously-touched
    # row, INCLUDING the previous collision row — its octave-last touch is
    # the trailing S ref either way, so one class covers all)
    vB = (clk - clk_prev)[:, None] + o * lpe * (S_k - S_k_prev)[:, None] \
        - (lpe - 1) * S_k_prev[:, None] + (off_S - off_S_prev)[:, None]
    ok = ok and emit(vB, np.where(has_prev[:, None], m_prev[:, None], 0),
                     span_S, winc)
    # C. colds: the rows the triangle grew this iteration
    cold = (m - m_prev) * C
    np.add.at(hist_w, (win, np.zeros(n_s, np.int64)), cold)
    np.add.at(total, np.arange(n_s), cold)
    # D. D's walk on the top row: m consecutive touches per k at gap s_j
    ok = ok and emit(s_j, K * (m - 1), 0, win)
    # E. D-last -> the trailing S touch (every k)
    ok = ok and emit(off_S - off_D, np.full(n_s, K), span_S, win)
    # F. S -> next k's first D touch (k not octave-last)
    vF = S_k - (m - 1) * s_j - (off_S - off_D)
    ok = ok and (lpe == 1 or emit(vF, C * (lpe - 1), 0, win))
    if not ok:
        return None
    # invariant: every D+S access of the iteration is exactly one event or
    # cold — a wrong count formula cannot ship silently
    if not (total == 2 * m * K).all():
        return None
    return hist_w, share, list(zip(idx.tolist(), g.tolist(),
                                   clk.tolist()))


def build_sweepgroup(spec: LoopNestSpec, ni: int, refs, cfg: SamplerConfig,
                     sched, owned: np.ndarray, W: int, NW: int,
                     clock: np.ndarray):
    """(sort_refs, hist_w [T, NW, NBINS] | None, share_adds | None).

    ``share_adds``: per thread, a dict of raw share value -> count to add
    at finalize time (the closed-formed refs' share events).
    """
    T = owned.shape[0]
    by_arr: dict[str, list] = {}
    for fr in refs:
        by_arr.setdefault(fr.ref.array, []).append(fr)
    hist_total = None
    share_total = None
    done = set()
    for arr, frs in by_arr.items():
        if eligible(spec, ni, frs, cfg, sched) is not None:
            continue
        d = next(fr for fr in frs if fr.addr_coefs[0])
        s = next(fr for fr in frs if not fr.addr_coefs[0])
        per_t = []
        failed = False
        for t in range(T):
            out = _derive_thread(d, s, cfg, sched, owned[t], W, NW,
                                 clock[t])
            if out is None:
                failed = True
                break
            per_t.append(out)
        if failed:
            continue
        # verification: replay sampled slots through the brute pair oracle
        if not _verify(d, s, cfg, per_t, owned, W, NW, clock):
            continue
        hw = np.stack([p[0] for p in per_t])
        if hist_total is None:
            hist_total = hw
            share_total = [dict(p[1]) for p in per_t]
        else:
            hist_total = hist_total + hw
            for t in range(T):
                for v, cnt in per_t[t][1].items():
                    share_total[t][v] = share_total[t].get(v, 0) + cnt
        done.add(arr)
    if not done:
        return tuple(refs), None, None
    sort_refs = tuple(fr for fr in refs if fr.ref.array not in done)
    return sort_refs, hist_total, tuple(share_total)


def _verify(d, s, cfg, per_t, owned, W, NW, clock) -> bool:
    """Brute-replay sampled (prev, cur) slot pairs per thread.

    The closed form's per-slot contribution is recovered by diffing
    cumulative tables — instead, re-derive each sampled slot ALONE via a
    single-slot `_derive_thread` call on a synthetic one-slot schedule...
    that would not exercise the prev-coupling, so the oracle replays the
    (prev, cur) pair directly and the closed form is evaluated for the
    pair's second slot by construction: sample slots where the pair's
    events can be isolated — the FIRST slot (cold-only) plus slots whose
    brute pair events equal (closed_form[cur slot]).  Mechanically: for
    each sampled cur slot, brute = events of cur given prev warm-up; the
    per-slot closed-form contribution is recomputed by running
    `_derive_thread` on a 2-slot owned sequence {prev, cur}, whose second
    slot's events are exactly the pair's.
    """
    T = owned.shape[0]
    for t in range(min(T, 2)):
        slots = per_t[t][2]
        if not slots:
            continue
        picks = sorted({0, 1, len(slots) // 2, len(slots) - 1}
                       & set(range(len(slots))))
        for pi in picks:
            idx, g, clk = slots[pi]
            if pi == 0:
                gp = None
                clkp = 0
            else:
                _, gp, clkp = slots[pi - 1]
            want_h, want_s = brute_pair_hist(d, s, cfg, gp, g, clkp, clk)
            got = _slot_contribution(d, s, cfg, gp, g, clkp, clk)
            if got is None:
                return False
            got_h, got_s = got
            if not (want_h == got_h).all() or want_s != got_s:
                return False
    return True


def _slot_contribution(d, s, cfg, g_prev, g, clk_prev, clk):
    """Closed-form (hist, share) of ONE slot, via a 2-slot derivation."""
    class _Sched:
        trip = max(g + 1, 1 + (g_prev if g_prev is not None else 0) + 1)
        start = 0
        step = 1

    # synthetic one-thread schedule owning exactly the pair (chunk size 1)
    cfg1 = dataclasses.replace(cfg, chunk_size=1, thread_num=1)
    if g_prev is None:
        owned_row = np.asarray([g], np.int32)
        clock_row = np.asarray([clk], np.int64)
    else:
        owned_row = np.asarray([g_prev, g], np.int32)
        clock_row = np.asarray([clk_prev, clk], np.int64)
    NW1 = len(owned_row)
    out = _derive_thread(d, s, cfg1, _Sched, owned_row, 1, NW1, clock_row)
    if out is None:
        return None
    hist_w, share, _ = out
    if g_prev is None:
        return hist_w[0], share
    # second slot's hist is its window row; share dict mixes both slots'
    # share events — subtract the first slot's own (prev-less) share
    first = _derive_thread(d, s, cfg1, _Sched,
                           np.asarray([g_prev], np.int32), 1, 1,
                           np.asarray([clk_prev], np.int64))
    if first is None:
        return None
    share2 = dict(share)
    for v, cnt in first[1].items():
        share2[v] = share2.get(v, 0) - cnt
        if share2[v] == 0:
            del share2[v]
    return hist_w[1], share2
