"""Interleave overlays: exact O(lines) windows for mixed-coefficient arrays.

Counterpart of ``pluss/overlay.py``.  The static window template needs
every ref of an array to share one parallel-dim address coefficient;
syrk's ``A`` (``A0 = A[i][k]`` moves with the parallel loop, ``A1 =
A[j][k]`` sweeps the whole array in every iteration) fails that test.  Each
group alone is shift-invariant, though, and the two meet only on the
**collision lines**: the rows the moving group D touches in the current
window.  On those rows the sweeping group S contributes a sparse set of
**arrivals**, and every quantity the merge needs (D's predecessor and
successor of an arrival, D's first and last access per line, S's previous
and next arrival on a line) has a closed form.  An ultra window then costs:

- S template: per-line head resolution, a static local histogram and the
  tails over the whole line set, minus its precomputed per-line part on
  the collision rows;
- D template: heads, tails and the static histogram on the collision rows;
- arrival corrections: one event per arrival, against the latest of its
  D predecessor, its own S predecessor and the carried table, plus a
  substitution per broken D gap; no sort at all.

Exactness is checked, not argued: :func:`verify_overlay` replays the
correction algebra in numpy (:func:`arrival_corrections`,
:func:`np_window_prediction`) against a brute-force lexsort of real
windows at plan time, and a mismatch leaves the array on the sort path.
:func:`device_window_plain` is the same algebra in torch, batched over
the simulated threads (the JAX package's ``vmap`` axis as the leading
dimension); the engine's tests hold it against ``pluss.engine.run``.  On
the card, :func:`device_window` runs it as one CUDA kernel
(``csrc/overlay_window.cu``), held element for element to the plain
version.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from pluss_torch.config import NBINS, SamplerConfig
from pluss_torch.ops.overlay_window import check_inputs, overlay_window
from pluss_torch.ops.reuse import bin_histogram, log2_bin, share_mask
from pluss_torch.spec import FlatRef


@dataclasses.dataclass(frozen=True)
class OverlayPlan:
    """Static geometry and tables of one overlaid array in one nest.

    Line ids are ARRAY-LOCAL (0-based); ``line_base`` converts them to the
    engine's global line space.  Positions are thread-local stream clocks
    WITHOUT the nest base (the device step adds it); they are the same for
    every thread (every thread's window ``w`` spans the same rank range)
    and shift by ``pos_shift`` per window.
    """

    array: str
    line_base: int
    n_lines: int
    d_ref: FlatRef                # moving group (coef0 != 0), single ref
    s_ref: FlatRef                # sweeping group (coef0 == 0), single ref
    R: int                        # lines per parallel row
    lpe: int                      # elements (inner-var steps) per line
    J: int                        # D's free middle-loop trip
    SL: int                       # window parallel slots = W * CS
    W: int                        # window rounds
    w0: int                       # template origin window
    pos_shift: int                # window-to-window position shift
    # D pos(g_rank, j, k) = g_rank*d_s0 + j*d_sj + k*d_sk + d_off
    d_s0: int
    d_sj: int
    d_sk: int
    d_off: int
    # S pos(g_rank, u_idx, k) = g_rank*s_s0 + u_idx*s_su + k*s_sk + s_off
    s_s0: int
    s_su: int
    s_sk: int
    s_off: int
    d_span: int                   # share span of D's ref (0 = never share)
    s_span: int
    d_local_hist: np.ndarray      # [NBINS] D's static in-window event hist
    s_local_hist: np.ndarray      # [NBINS] S's static in-window event hist
    d_share_vals: np.ndarray      # D static in-window share (value, count)
    d_share_cnts: np.ndarray
    s_share_vals: np.ndarray      # S static in-window share (value, count)
    s_share_cnts: np.ndarray
    #: [n_lines+1, NBINS] prefix sums of S's per-line static event hist
    s_hist_prefix: np.ndarray
    #: [n_lines, mtrip] per-line static share (value, count) pairs, 0-padded
    s_line_share_val: np.ndarray
    s_line_share_cnt: np.ndarray
    #: [n_lines] S's first/last access position per line at window w0
    s_first0: np.ndarray
    s_last0: np.ndarray


def _single_coef_levels(fr: FlatRef):
    """Indices of loop levels with nonzero address coefficients."""
    return [l for l, c in enumerate(fr.addr_coefs) if c]


def _row_geometry(fr: FlatRef, lvl_u: int, cfg: SamplerConfig, sched):
    """(row0, R, lpe, u_start, u_step, u_trip) of a dense-row ref ``addr =
    base + c*u + k``, or None.

    Requires an innermost coefficient 1 with start 0 and step 1, aligned
    rows (``(base + c*u_start)*ds % cls == 0`` and ``c*u_step*ds % cls ==
    0``) and exact density (``k_trip == c*u_step``: each row's inner range
    fills the row, so line = row0 + u_idx*R + k//lpe).
    """
    ds, cls = cfg.ds, cfg.cls
    if cls % ds:
        return None
    lpe = cls // ds
    kl = len(fr.trips) - 1
    c = fr.addr_coefs[lvl_u]
    if fr.addr_coefs[kl] != 1 or fr.starts[kl] != 0 or fr.steps[kl] != 1:
        return None
    if lvl_u == 0:
        u_start, u_step, u_trip = sched.start, sched.step, sched.trip
    else:
        u_start, u_step, u_trip = fr.starts[lvl_u], fr.steps[lvl_u], \
            fr.trips[lvl_u]
    base = fr.ref.addr_base + c * u_start
    if (base * ds) % cls or (c * u_step * ds) % cls:
        return None
    R = c * u_step * ds // cls
    if R <= 0 or fr.trips[kl] != c * u_step:   # exact row density
        return None
    return (base * ds // cls, R, lpe, u_start, u_step, u_trip)


def _static_events(line, pos, span: int):
    """Lexsorted (line, pos) of one group's origin window and its local
    events: ``(line, pos, same, reuse, share, evt)``."""
    order = np.lexsort((pos, line))
    line, pos = line[order], pos[order]
    same = np.concatenate([[False], line[1:] == line[:-1]])
    reuse = np.where(same, pos - np.concatenate([[0], pos[:-1]]), 0)
    sh = same & share_mask(reuse, np.full(reuse.shape, span))
    return line, pos, same, reuse, sh, same & ~sh


def build_overlay(array: str, refs: list[FlatRef], cfg: SamplerConfig, sched,
                  spec, W: int, w0: int, body: int) -> OverlayPlan | None:
    """Overlay plan for one array's refs, or None if ineligible.

    Eligibility (each check falls back to the sort path, never errors):
    exactly one moving ref D (``addr = base + c*par + k``) and one sweeping
    ref S (``addr = base + c*u + k`` over an inner loop u that mirrors the
    parallel loop's range), both row-dense and aligned, sharing base, c and
    the k structure, with D's free loop coarser than a row (the closed-form
    pred/succ digit condition).
    """
    if len(refs) != 2:
        return None
    movers = [fr for fr in refs if fr.addr_coefs[0]]
    sweeps = [fr for fr in refs if not fr.addr_coefs[0]]
    if len(movers) != 1 or len(sweeps) != 1:
        return None
    d, s = movers[0], sweeps[0]
    kl_d, kl_s = len(d.trips) - 1, len(s.trips) - 1
    if _single_coef_levels(d) != [0, kl_d] or kl_d < 2:
        return None
    lv_s = _single_coef_levels(s)
    if len(lv_s) != 2 or lv_s[1] != kl_s or lv_s[0] == 0:
        return None
    if d.addr_coefs[0] != s.addr_coefs[lv_s[0]] or \
            d.ref.addr_base != s.ref.addr_base:
        return None
    gd = _row_geometry(d, 0, cfg, sched)
    gs = _row_geometry(s, lv_s[0], cfg, sched)
    if gd is None or gs is None:
        return None
    row0_d, R, lpe, *_ = gd
    row0_s, R_s, lpe_s, us, ust, utr = gs
    # S's u loop must BE the parallel range (collision rows == u rows)
    if (row0_d, R, lpe) != (row0_s, R_s, lpe_s) or \
            (us, ust, utr) != (sched.start, sched.step, sched.trip):
        return None
    if row0_d != 0:
        return None  # array-local line 0 at row 0 keeps slicing simple
    ai = spec.array_index(array)
    n_lines = spec.line_counts(cfg)[ai]
    if sched.trip * R != n_lines or s.trips[lv_s[0]] != sched.trip:
        return None  # S must cover the array's full contiguous line range
    if kl_d != 2:   # chains deeper than (par, mid, inner) not yet handled
        return None
    J = d.trips[1]
    d_sj = d.pos_strides[1]
    d_sk = d.pos_strides[kl_d]
    if d_sj <= (lpe - 1) * d_sk:      # digit condition for pred/succ
        return None
    if kl_s != 2 or lv_s[0] != 1:
        return None
    s_su = s.pos_strides[1]
    s_sk = s.pos_strides[kl_s]
    if s.pos_strides[0] <= (lpe - 1) * s_sk:   # arrival-lattice digits
        return None

    # static tables from an origin-window numpy enumeration of S
    line_s, pos_s, same, reuse, sh, evt = _static_events(
        *_np_ref_positions(s, W, w0, cfg, sched), s.ref.share_span or 0)
    slots = np.frexp(reuse[evt].astype(np.float64))[1].astype(np.int64)
    per_line = np.zeros((n_lines, NBINS), np.int64)
    np.add.at(per_line, (line_s[evt], slots), 1)
    s_hist_prefix = np.concatenate(
        [np.zeros((1, NBINS), np.int64), np.cumsum(per_line, axis=0)])
    # per-line share pairs, padded to the max count per line
    uniq, cnts = np.unique(np.stack([line_s[sh], reuse[sh]], axis=1), axis=0,
                           return_counts=True)
    mtrip = 1
    if len(uniq):
        mtrip = int(np.bincount(uniq[:, 0], minlength=n_lines).max())
    lsv = np.zeros((n_lines, mtrip), np.int64)
    lsc = np.zeros((n_lines, mtrip), np.int64)
    fill = np.zeros(n_lines, np.int64)
    for (ln, v), c in zip(uniq.tolist(), cnts.tolist()):
        lsv[ln, fill[ln]] = v
        lsc[ln, fill[ln]] = c
        fill[ln] += 1
    # S first/last position per line at w0 (line-sorted: segment ends)
    head = ~same
    tail = ~np.concatenate([line_s[1:] == line_s[:-1], [False]])
    s_first0 = np.zeros(n_lines, np.int64)
    s_last0 = np.zeros(n_lines, np.int64)
    s_first0[line_s[head]] = pos_s[head]
    s_last0[line_s[tail]] = pos_s[tail]
    sv, sc = np.unique(reuse[sh], return_counts=True)

    # D static histogram and share from its own origin enumeration
    _, _, _, reuse, shd, evtd = _static_events(
        *_np_ref_positions(d, W, w0, cfg, sched), d.ref.share_span or 0)
    slots = np.frexp(reuse[evtd].astype(np.float64))[1].astype(np.int64)
    dv, dc = np.unique(reuse[shd], return_counts=True)

    return OverlayPlan(
        array=array,
        line_base=spec.line_bases(cfg)[ai],
        n_lines=n_lines,
        d_ref=d,
        s_ref=s,
        R=R,
        lpe=lpe,
        J=J,
        SL=W * cfg.chunk_size,
        W=W,
        w0=w0,
        pos_shift=W * cfg.chunk_size * body,
        d_s0=d.pos_strides[0],
        d_sj=d_sj,
        d_sk=d_sk,
        d_off=d.offset,
        s_s0=s.pos_strides[0],
        s_su=s_su,
        s_sk=s_sk,
        s_off=s.offset,
        d_span=d.ref.share_span or 0,
        s_span=s.ref.share_span or 0,
        d_local_hist=np.bincount(slots, minlength=NBINS).astype(np.int64),
        s_local_hist=s_hist_prefix[-1].copy(),
        d_share_vals=dv.astype(np.int64),
        d_share_cnts=dc.astype(np.int64),
        s_share_vals=sv.astype(np.int64),
        s_share_cnts=sc.astype(np.int64),
        s_hist_prefix=s_hist_prefix,
        s_line_share_val=lsv,
        s_line_share_cnt=lsc,
        s_first0=s_first0,
        s_last0=s_last0,
    )


def _np_ref_positions(fr: FlatRef, W: int, w0: int, cfg: SamplerConfig,
                      sched, t: int = 0):
    """(array-local line, thread-local pos) of one ref over window ``w0``
    of thread ``t``, in numpy: the static origin tables (t=0) and the
    brute-force verifier (any t).  Positions exclude the nest base."""
    shape = (W, cfg.chunk_size) + fr.trips[1:]
    nd = len(shape)

    def iota(axis):
        return np.arange(shape[axis], dtype=np.int64).reshape(
            (1,) * axis + (-1,) + (1,) * (nd - axis - 1))

    r, p = iota(0), iota(1)
    cid = (w0 * W + r) * cfg.thread_num + t
    g = cid * cfg.chunk_size + p
    rank = (w0 * W + r) * cfg.chunk_size + p
    pos = rank * fr.pos_strides[0] + fr.offset
    addr = fr.ref.addr_base + fr.addr_coefs[0] * (sched.start + g * sched.step)
    for l in range(1, len(fr.trips)):
        idx = iota(l + 1)
        pos = pos + idx * fr.pos_strides[l]
        if fr.addr_coefs[l]:
            addr = addr + fr.addr_coefs[l] * (fr.starts[l] + idx * fr.steps[l])
    line = addr * cfg.ds // cfg.cls
    line = np.broadcast_to(line, shape).reshape(-1)
    pos = np.broadcast_to(pos, shape).reshape(-1)
    return line, pos


# --------------------------------------------------------------------------
# The correction algebra in numpy: the plan-time verifier's prediction.
# --------------------------------------------------------------------------


def window_geometry(ov: OverlayPlan, cfg: SamplerConfig, w: int, t: int):
    """[W] collision row starts (array-local g index) of window ``w`` of
    thread ``t``, and the window's position shift relative to w0."""
    r = np.arange(ov.W, dtype=np.int64)
    row_start = ((w * ov.W + r) * cfg.thread_num + t) * cfg.chunk_size
    return row_start, (w - ov.w0) * ov.pos_shift


def arrival_corrections(ov: OverlayPlan, cfg: SamplerConfig, w: int, t: int,
                        carried_coll: np.ndarray) -> dict:
    """Every per-arrival and per-collision-line correction of one window.

    ``carried_coll``: [W, CS*R] carried last positions of the collision
    lines (array-local row blocks, before the tail write), nest-local.

    Returns a dict of flat arrays:
      add_reuse/add_cold/add_share/add_w: arrival and gap-substitution ADD
        events (``add_w`` 0 marks padding);
      sub_reuse/sub_cold/sub_share/sub_w: substitution SUB events;
      new_tail: [W, CS*R] true end-of-window tails of the collision lines.
    """
    CS, T = cfg.chunk_size, cfg.thread_num
    R, lpe, J, SL, W = ov.R, ov.lpe, ov.J, ov.SL, ov.W
    row_start, _ = window_geometry(ov, cfg, w, t)

    # arrival lattice [slot s, row slot m, k]: slot s is the window's s-th
    # parallel iteration (rank order), m the collision row the arrival
    # lands on, k S's inner index
    s_ = np.arange(SL, dtype=np.int64).reshape(SL, 1, 1)
    m_ = np.arange(SL, dtype=np.int64).reshape(1, SL, 1)
    k_ = np.arange(ov.s_ref.trips[-1], dtype=np.int64).reshape(1, 1, -1)
    rank = (w * W + s_ // CS) * CS + s_ % CS
    u_g = ((w * W + m_ // CS) * T + t) * CS + m_ % CS   # the m-th row
    q = rank * ov.s_s0 + u_g * ov.s_su + k_ * ov.s_sk + ov.s_off
    L = u_g * R + k_ // lpe                       # array-local line
    k0 = (L % R) * lpe                            # line's inner-octet start

    # D's closed forms on the arrival's line (D row == collision row)
    g_d = L // R
    rank_d = g_d // (T * CS) * CS + g_d % CS
    c_l = rank_d * ov.d_s0 + ov.d_off
    dfirst = c_l + k0 * ov.d_sk
    qp = q - c_l
    has_dpred = qp >= k0 * ov.d_sk
    jq = np.clip((qp - k0 * ov.d_sk) // ov.d_sj, 0, J - 1)
    kq = np.minimum(k0 + lpe - 1, (qp - jq * ov.d_sj) // ov.d_sk)
    dpred = np.where(has_dpred, c_l + jq * ov.d_sj + kq * ov.d_sk, -1)
    # successor = lattice increment of the predecessor (positions unique)
    k_wrap = kq >= k0 + lpe - 1
    jn = np.where(k_wrap, jq + 1, jq)
    kn = np.where(k_wrap, k0, kq + 1)
    has_dsucc = np.where(has_dpred, jn < J, True)
    dsucc = np.where(has_dpred, c_l + jn * ov.d_sj + kn * ov.d_sk, dfirst)

    # the arrival's own S neighbours (same line: fixed u, octet)
    in_oct = k_ % lpe
    has_aprev = (in_oct > 0) | (s_ > 0)
    aprev = np.where(in_oct > 0, q - ov.s_sk,
                     q - ov.s_s0 + (lpe - 1) * ov.s_sk)   # (s-1, octet end)
    aprev = np.where(has_aprev, aprev, -1)
    has_anext = (in_oct < lpe - 1) | (s_ < SL - 1)
    anext = np.where(in_oct < lpe - 1, q + ov.s_sk,
                     q + ov.s_s0 - (lpe - 1) * ov.s_sk)
    anext = np.where(has_anext, anext, -1)

    # carried lookup: collision lines are [W] runs of CS*R
    run = m_ // CS * np.ones_like(L)
    off = (m_ % CS) * R + k_ // lpe
    carried = carried_coll[run, off + np.zeros_like(L)]

    # per-arrival event: q against max(dpred, aprev, carried)
    pred = np.maximum(np.maximum(dpred, aprev), carried)
    a_cold = pred < 0
    a_reuse = np.where(a_cold, 0, q - pred)
    a_share = ~a_cold & share_mask(a_reuse, ov.s_span + np.zeros_like(a_reuse))

    # gap substitution (once per broken D gap: the gap's LAST arrival)
    last_in_gap = has_dsucc & (~has_anext | (anext > dsucc))
    g_reuse = np.where(last_in_gap, dsucc - q, 0)
    g_share = last_in_gap & share_mask(g_reuse,
                                       ov.d_span + np.zeros_like(g_reuse))
    # SUB the D event the gap used to carry (only with a D predecessor;
    # without one it is D's head event, handled per line)
    sub_gap = last_in_gap & has_dpred
    s_reuse = np.where(sub_gap, dsucc - dpred, 0)
    s_share = sub_gap & share_mask(s_reuse,
                                   ov.d_span + np.zeros_like(s_reuse))

    # per-collision-line corrections
    off_l = np.arange(CS * R, dtype=np.int64).reshape(1, CS * R)
    g_l = row_start.reshape(W, 1) + off_l // R
    rank_l = g_l // (T * CS) * CS + g_l % CS
    k0_l = (off_l % R) * lpe
    c_ll = rank_l * ov.d_s0 + ov.d_off
    dfirst_l = c_ll + k0_l * ov.d_sk
    dlast_l = c_ll + (J - 1) * ov.d_sj + (k0_l + lpe - 1) * ov.d_sk
    # arrivals on line (m, k0): the first at (slot 0, octet start), the
    # last at (slot SL-1, octet end)
    rank0 = w * W * CS
    rankz = (w * W + (SL - 1) // CS) * CS + (SL - 1) % CS
    qfirst_l = rank0 * ov.s_s0 + g_l * ov.s_su + k0_l * ov.s_sk + ov.s_off
    qlast_l = rankz * ov.s_s0 + g_l * ov.s_su \
        + (k0_l + lpe - 1) * ov.s_sk + ov.s_off
    new_tail = np.maximum(dlast_l, qlast_l)
    # D-template head events on every collision line (dfirst vs carried)
    dh_cold = carried_coll < 0
    dh_reuse = np.where(dh_cold, 0, dfirst_l - carried_coll)
    dh_share = ~dh_cold & share_mask(dh_reuse,
                                     ov.d_span + np.zeros_like(dh_reuse))
    # D head substitution: an arrival before D's first access means that
    # head event never happened (the gap ADD above emitted D-first's true
    # event against its preceding arrival instead)
    head_broken = qfirst_l < dfirst_l
    hb_cold = head_broken & dh_cold
    hb_evt = head_broken & ~dh_cold
    hb_reuse = np.where(hb_evt, dh_reuse, 0)
    hb_share = hb_evt & dh_share

    flat = np.ravel
    return {
        "add_reuse": np.concatenate(
            [flat(a_reuse), flat(g_reuse), flat(dh_reuse)]),
        "add_cold": np.concatenate(
            [flat(a_cold), flat(np.zeros_like(g_reuse, bool)),
             flat(dh_cold)]),
        "add_share": np.concatenate(
            [flat(a_share), flat(g_share), flat(dh_share)]),
        "add_w": np.concatenate(
            [flat(np.ones_like(a_reuse)), flat(last_in_gap.astype(np.int64)),
             flat(np.ones_like(dh_reuse))]),
        "sub_reuse": np.concatenate([flat(s_reuse), flat(hb_reuse)]),
        "sub_cold": np.concatenate([flat(np.zeros_like(s_reuse, bool)),
                                    flat(hb_cold)]),
        "sub_share": np.concatenate([flat(s_share), flat(hb_share)]),
        "sub_w": np.concatenate([flat(sub_gap.astype(np.int64)),
                                 flat((hb_evt | hb_cold).astype(np.int64))]),
        "new_tail": new_tail,
    }


def coll_mask_of(ov: OverlayPlan, cfg: SamplerConfig, w: int,
                 t: int) -> np.ndarray:
    """[n_lines] True on this window's collision lines (array-local)."""
    row_start, _ = window_geometry(ov, cfg, w, t)
    lines = np.arange(ov.n_lines, dtype=np.int64)
    lo = row_start.reshape(-1, 1) * ov.R
    hi = lo + cfg.chunk_size * ov.R
    return ((lines.reshape(1, -1) >= lo) & (lines.reshape(1, -1) < hi)).any(0)


def s_template_heads(ov: OverlayPlan, w: int, carried_all: np.ndarray,
                     coll_mask: np.ndarray) -> dict:
    """S-template per-line head events on NON-collision lines (numpy).

    ``carried_all``: [n_lines] carried positions of the whole array;
    ``coll_mask``: [n_lines] True on collision lines (suppressed: their S
    accesses are handled as arrivals)."""
    dpos = (w - ov.w0) * ov.pos_shift
    first = ov.s_first0 + dpos
    act = ~coll_mask
    cold = act & (carried_all < 0)
    evt = act & (carried_all >= 0)
    reuse = np.where(evt, first - carried_all, 0)
    share = evt & share_mask(reuse, ov.s_span + np.zeros_like(reuse))
    return {"reuse": reuse, "cold": cold, "evt": evt, "share": share,
            "tails": ov.s_last0 + dpos}


def np_window_prediction(ov: OverlayPlan, cfg: SamplerConfig, w: int, t: int,
                         carried: np.ndarray):
    """Numpy replay of one overlay window, assembled into ``(hist[NBINS],
    share{val: cnt}, tails[n_lines])``.

    ``carried``: [n_lines] nest-local carried positions (-1 = untouched).
    Used by :func:`verify_overlay`.
    """
    CS, R = cfg.chunk_size, ov.R
    hist = np.zeros(NBINS, np.int64)
    share: dict[int, int] = {}

    def bump(reuse, cold, shr, wgt):
        reuse, cold, shr = np.ravel(reuse), np.ravel(cold), np.ravel(shr)
        wgt = np.ravel(wgt).astype(np.int64)
        evt = (wgt != 0) & ~cold & ~shr
        slots = np.frexp(np.maximum(reuse, 1).astype(np.float64))[1]
        np.add.at(hist, np.where(evt, slots, 0), np.where(evt, wgt, 0))
        hist[0] += int((cold * wgt).sum())
        for v, c in zip(reuse[shr & (wgt != 0)].tolist(),
                        wgt[shr & (wgt != 0)].tolist()):
            share[v] = share.get(v, 0) + c

    row_start, _ = window_geometry(ov, cfg, w, t)
    cc = np.stack([carried[rs * R: rs * R + CS * R] for rs in row_start])
    cm = coll_mask_of(ov, cfg, w, t)

    # S-template heads on non-collision lines, and the static histograms
    sh = s_template_heads(ov, w, carried, cm)
    bump(sh["reuse"], sh["cold"], sh["share"],
         sh["evt"] | sh["cold"] | sh["share"])
    hist += ov.s_local_hist + ov.d_local_hist
    for v, c in zip(ov.s_share_vals.tolist(), ov.s_share_cnts.tolist()):
        share[v] = share.get(v, 0) + c
    for v, c in zip(ov.d_share_vals.tolist(), ov.d_share_cnts.tolist()):
        share[v] = share.get(v, 0) + c
    # minus S's static per-line contributions on the collision lines
    for rs in row_start:
        lo, hi = rs * R, rs * R + CS * R
        hist -= ov.s_hist_prefix[hi] - ov.s_hist_prefix[lo]
        for ln in range(lo, hi):
            for v, c in zip(ov.s_line_share_val[ln].tolist(),
                            ov.s_line_share_cnt[ln].tolist()):
                if c:
                    share[v] = share.get(v, 0) - c

    # arrival and D-head corrections
    cor = arrival_corrections(ov, cfg, w, t, cc)
    bump(cor["add_reuse"], cor["add_cold"], cor["add_share"], cor["add_w"])
    bump(cor["sub_reuse"], cor["sub_cold"], cor["sub_share"], -cor["sub_w"])

    # tails: S writes everywhere, collision lines get max(Dlast, q_last)
    tails = sh["tails"].copy()
    for i, rs in enumerate(row_start):
        tails[rs * R: rs * R + CS * R] = cor["new_tail"][i]
    share = {v: c for v, c in share.items() if c}
    return hist, share, tails


def np_window_brute(ov: OverlayPlan, cfg: SamplerConfig, sched, w: int,
                    t: int, carried: np.ndarray):
    """Ground truth for one window of the overlaid array: enumerate both
    refs for (thread t, window w), lexsort, and walk the merged per-line
    streams against ``carried`` (the semantics of the engine's ghost-merged
    sort window), in plain numpy."""
    lines, poss, spans = [], [], []
    for fr in (ov.d_ref, ov.s_ref):
        line, pos = _np_ref_positions(fr, ov.W, w, cfg, sched, t)
        lines.append(line)
        poss.append(pos)
        spans.append(np.full(line.shape, fr.ref.share_span or 0, np.int64))
    line, pos = np.concatenate(lines), np.concatenate(poss)
    span = np.concatenate(spans)
    order = np.lexsort((pos, line))
    line, pos, span = line[order], pos[order], span[order]
    same = np.concatenate([[False], line[1:] == line[:-1]])
    prev = np.concatenate([[0], pos[:-1]])
    head = ~same
    carr = carried[line]
    reuse = np.where(same, pos - prev, np.where(carr >= 0, pos - carr, 0))
    cold = head & (carr < 0)
    is_evt = same | (head & (carr >= 0))
    shr = is_evt & share_mask(reuse, span)
    evt = is_evt & ~shr
    hist = np.zeros(NBINS, np.int64)
    slots = np.frexp(np.maximum(reuse, 1).astype(np.float64))[1]
    np.add.at(hist, slots[evt], 1)
    hist[0] += int(cold.sum())
    share: dict[int, int] = {}
    for v in reuse[shr].tolist():
        share[v] = share.get(v, 0) + 1
    tails = carried.copy()
    tail = ~np.concatenate([line[1:] == line[:-1], [False]])
    tails[line[tail]] = pos[tail]
    return hist, share, tails


def verify_overlay(ov: OverlayPlan, cfg: SamplerConfig, sched,
                   n_windows: int, pairs=None) -> bool:
    """Replay the correction algebra (numpy) against brute-force windows.

    Each (t, w) pair is checked with a REAL carried state: the brute walk
    of windows 0..w-1 of that thread feeds window w, so the carried
    resolution, cold and substitution paths are all exercised.  Returns
    False on any mismatch (the caller then leaves the array on the sort
    path).
    """
    T = cfg.thread_num
    if pairs is None:
        w_hi = min(n_windows - 1, 2)
        pairs = {(0, 0), (T - 1, min(1, n_windows - 1)),
                 (min(1, T - 1), w_hi)}
    for t, w in sorted(pairs):
        carried = np.full(ov.n_lines, -1, np.int64)
        for wp in range(w):
            *_, carried = np_window_brute(ov, cfg, sched, wp, t, carried)
        bh, bs, bt = np_window_brute(ov, cfg, sched, w, t, carried)
        ph, ps, pt = np_window_prediction(ov, cfg, w, t, carried)
        if not ((bh == ph).all() and bs == ps and (bt == pt).all()):
            print(f"pluss_torch.overlay: verification FAILED for array "
                  f"{ov.array!r} at (t={t}, w={w}); using the sort path",
                  file=sys.stderr)
            return False
    return True


# --------------------------------------------------------------------------
# The same algebra in torch, on the device, batched over thread rows.
# --------------------------------------------------------------------------


class DeviceOverlay:
    """An :class:`OverlayPlan`'s tables as device tensors (int64)."""

    def __init__(self, ov: OverlayPlan, device):
        as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                         dtype=torch.int64, device=device)
        self.ov = ov
        self.static_hist = as_t(ov.s_local_hist + ov.d_local_hist)
        self.prefix = as_t(ov.s_hist_prefix)
        self.first0 = as_t(ov.s_first0)
        self.last0 = as_t(ov.s_last0)


def _floor_div(a, b: int):
    return torch.div(a, b, rounding_mode="floor")


def _bump(reuse, cold, share, wgt) -> torch.Tensor:
    """``[Tb, NBINS]`` events of flat ``[Tb, n]`` rows weighed by ``wgt``:
    no-share events in their log2 slot, cold in slot 0."""
    evt = (wgt != 0) & ~cold & ~share
    bins = torch.where(evt, log2_bin(reuse), 0)
    return bin_histogram(bins, torch.where(evt | cold, wgt, 0))


def device_window(dov: DeviceOverlay, cfg: SamplerConfig, w: int,
                  tids: torch.Tensor, nb: torch.Tensor,
                  last_pos: torch.Tensor):
    """One overlay window for thread rows ``tids`` ([Tb] int64), in place:
    the arguments and results of :func:`device_window_plain`.

    Inputs are checked (``ops.overlay_window.check_inputs``).  CPU tensors
    take :func:`device_window_plain`; CUDA tensors launch the kernel
    (``ops.overlay_window.overlay_window``, one launch for all rows,
    counted in ``overlay_window.launches`` and the telemetry counter
    ``kernel.launches.overlay_window``).  Nothing falls back."""
    check_inputs(dov, tids, nb, last_pos)
    if last_pos.device.type == "cpu":
        return device_window_plain(dov, cfg, w, tids, nb, last_pos)
    if last_pos.device.type != "cuda":
        raise ValueError(f"no overlay-window kernel for device "
                         f"{last_pos.device}")
    return overlay_window(dov, cfg, w, tids, nb, last_pos)


def device_window_plain(dov: DeviceOverlay, cfg: SamplerConfig, w: int,
                        tids: torch.Tensor, nb: torch.Tensor,
                        last_pos: torch.Tensor):
    """One overlay window for thread rows ``tids`` ([Tb] int64), in place.

    ``nb``: the rows' [Tb] nest bases; ``last_pos``: their [Tb, lines]
    rows of the GLOBAL carried table (positions absolute, -1 untouched),
    whose overlaid-array slice this call rewrites.  Returns ``(hist
    [Tb, NBINS] int64, plus, minus)``: ``plus`` and ``minus`` are
    ``(reuse, share)`` pairs of ``[Tb, n]`` rows, the share events to add
    and the substituted template events to subtract.  The arithmetic is
    int64 whatever the position dtype (positions are within int32 when
    the table is, so the values are the numpy algebra's).
    """
    ov = dov.ov
    dev = last_pos.device
    T, CS = cfg.thread_num, cfg.chunk_size
    R, lpe, J, SL, W = ov.R, ov.lpe, ov.J, ov.SL, ov.W
    CSR = CS * R
    Tb = tids.shape[0]
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)
    nb = nb.to(torch.int64)

    # collision rows and the carried state before any tail write
    row_start = ((w * W + ar(W))[None, :] * T + tids[:, None]) * CS  # [Tb,W]
    coll = ov.line_base + (row_start * R)[:, :, None] + ar(CSR)       # [Tb,W,CSR]
    cc = last_pos.gather(1, coll.view(Tb, -1)).to(torch.int64) \
        .view(Tb, W, CSR)
    base = ov.line_base
    carried_all = last_pos[:, base:base + ov.n_lines].to(torch.int64)
    coll_local = (coll - base).view(Tb, -1)
    cm = torch.zeros((Tb, ov.n_lines), dtype=torch.bool, device=dev)
    cm.scatter_(1, coll_local, True)

    # S-template heads on the non-collision lines
    dpos = (w - ov.w0) * ov.pos_shift + nb[:, None]                  # [Tb,1]
    act = ~cm
    sh_cold = act & (carried_all < 0)
    sh_evt = act & (carried_all >= 0)
    sh_reuse = torch.where(sh_evt, dov.first0 + dpos - carried_all, 0)
    sh_share = sh_evt & share_mask(sh_reuse, ov.s_span)

    # arrival lattice [Tb, slot s, row slot m, k]
    s_ = ar(SL).view(1, SL, 1, 1)
    m_ = ar(SL).view(1, 1, SL, 1)
    k_ = ar(ov.s_ref.trips[-1]).view(1, 1, 1, -1)
    nb4 = nb.view(Tb, 1, 1, 1)
    rank = (w * W + _floor_div(s_, CS)) * CS + s_ % CS
    u_g = ((w * W + _floor_div(m_, CS)) * T + tids.view(Tb, 1, 1, 1)) * CS \
        + m_ % CS
    q = rank * ov.s_s0 + u_g * ov.s_su + k_ * ov.s_sk + ov.s_off + nb4
    L = u_g * R + _floor_div(k_, lpe)
    k0 = (L % R) * lpe
    g_d = _floor_div(L, R)
    rank_d = _floor_div(g_d, T * CS) * CS + g_d % CS
    c_l = rank_d * ov.d_s0 + ov.d_off + nb4
    dfirst = c_l + k0 * ov.d_sk
    qp = q - c_l
    has_dpred = qp >= k0 * ov.d_sk
    jq = torch.clamp(_floor_div(qp - k0 * ov.d_sk, ov.d_sj), 0, J - 1)
    kq = torch.minimum(k0 + lpe - 1, _floor_div(qp - jq * ov.d_sj, ov.d_sk))
    dpred = torch.where(has_dpred, c_l + jq * ov.d_sj + kq * ov.d_sk, -1)
    k_wrap = kq >= k0 + lpe - 1
    jn = torch.where(k_wrap, jq + 1, jq)
    kn = torch.where(k_wrap, k0, kq + 1)
    has_dsucc = torch.where(has_dpred, jn < J, True)
    dsucc = torch.where(has_dpred, c_l + jn * ov.d_sj + kn * ov.d_sk, dfirst)
    in_oct = k_ % lpe
    has_aprev = (in_oct > 0) | (s_ > 0)
    aprev = torch.where(in_oct > 0, q - ov.s_sk,
                        q - ov.s_s0 + (lpe - 1) * ov.s_sk)
    aprev = torch.where(has_aprev, aprev, -1)
    has_anext = (in_oct < lpe - 1) | (s_ < SL - 1)
    anext = torch.where(in_oct < lpe - 1, q + ov.s_sk,
                        q + ov.s_s0 - (lpe - 1) * ov.s_sk)
    anext = torch.where(has_anext, anext, -1)
    # carried value of each arrival's line: run m//CS, offset within it
    cidx = (_floor_div(m_, CS) * CSR + (m_ % CS) * R
            + _floor_div(k_, lpe)).view(1, -1).expand(Tb, -1)
    carried = cc.view(Tb, -1).gather(1, cidx).view(Tb, 1, SL, -1)
    pred = torch.maximum(torch.maximum(dpred, aprev), carried)
    a_cold = pred < 0
    a_reuse = torch.where(a_cold, 0, q - pred)
    a_share = ~a_cold & share_mask(a_reuse, ov.s_span)
    last_in_gap = has_dsucc & (~has_anext | (anext > dsucc))
    g_reuse = torch.where(last_in_gap, dsucc - q, 0)
    g_share = last_in_gap & share_mask(g_reuse, ov.d_span)
    sub_gap = last_in_gap & has_dpred
    s_reuse = torch.where(sub_gap, dsucc - dpred, 0)
    s_share = sub_gap & share_mask(s_reuse, ov.d_span)

    # per-collision-line corrections [Tb, W, CSR]
    off_l = ar(CSR).view(1, 1, CSR)
    nb3 = nb.view(Tb, 1, 1)
    g_l = row_start[:, :, None] + _floor_div(off_l, R)
    rank_l = _floor_div(g_l, T * CS) * CS + g_l % CS
    k0_l = (off_l % R) * lpe
    c_ll = rank_l * ov.d_s0 + ov.d_off + nb3
    dfirst_l = c_ll + k0_l * ov.d_sk
    dlast_l = c_ll + (J - 1) * ov.d_sj + (k0_l + lpe - 1) * ov.d_sk
    rank0 = w * W * CS
    rankz = (w * W + (SL - 1) // CS) * CS + (SL - 1) % CS
    qfirst_l = rank0 * ov.s_s0 + g_l * ov.s_su + k0_l * ov.s_sk \
        + ov.s_off + nb3
    qlast_l = rankz * ov.s_s0 + g_l * ov.s_su \
        + (k0_l + lpe - 1) * ov.s_sk + ov.s_off + nb3
    new_tail = torch.maximum(dlast_l, qlast_l)
    dh_cold = cc < 0
    dh_reuse = torch.where(dh_cold, 0, dfirst_l - cc)
    dh_share = ~dh_cold & share_mask(dh_reuse, ov.d_span)
    head_broken = qfirst_l < dfirst_l
    hb_cold = head_broken & dh_cold
    hb_evt = head_broken & ~dh_cold
    hb_reuse = torch.where(hb_evt, dh_reuse, 0)
    hb_share = hb_evt & dh_share

    flat = lambda *xs: torch.cat([x.expand(Tb, *x.shape[1:]).reshape(Tb, -1)
                                  for x in xs], dim=1)
    one = torch.ones((Tb, 1, 1, 1), dtype=torch.int64, device=dev)
    add_reuse = flat(a_reuse, g_reuse, dh_reuse)
    add_cold = flat(a_cold, torch.zeros_like(g_reuse, dtype=torch.bool),
                    dh_cold)
    add_share = flat(a_share, g_share, dh_share)
    add_w = flat(one.expand_as(a_reuse), last_in_gap.to(torch.int64),
                 torch.ones_like(dh_reuse))
    sub_reuse = flat(s_reuse, hb_reuse)
    sub_cold = flat(torch.zeros_like(s_reuse, dtype=torch.bool), hb_cold)
    sub_share = flat(s_share, hb_share)
    sub_w = flat(sub_gap.to(torch.int64), (hb_evt | hb_cold).to(torch.int64))

    # static histograms, minus S's per-line part on the collision runs
    lo = row_start * R                                                # [Tb,W]
    hist = dov.static_hist - (dov.prefix[lo + CSR]
                              - dov.prefix[lo]).sum(dim=1)
    hist = hist + _bump(sh_reuse, sh_cold, sh_share,
                        (sh_evt | sh_cold).to(torch.int64))
    hist = hist + _bump(add_reuse, add_cold, add_share, add_w)
    hist = hist + _bump(sub_reuse, sub_cold, sub_share, -sub_w)

    # tails: the S template everywhere, then max(D last, last arrival) on
    # the collision runs
    upd = (dov.last0 + dpos).scatter(1, coll_local, new_tail.view(Tb, -1))
    last_pos[:, base:base + ov.n_lines] = upd.to(last_pos.dtype)

    plus = (torch.cat([add_reuse, sh_reuse], dim=1),
            torch.cat([add_share & (add_w != 0), sh_share], dim=1))
    minus = (sub_reuse, sub_share & (sub_w != 0))
    return hist, plus, minus
