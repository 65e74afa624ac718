"""Row-private groups: closed-form histograms for per-iteration-private
arrays in triangular nests (the port's copy of ``pluss/rowpriv.py``).

Triangular nests have no static-window template, so every array of theirs
would run the device sort path.  But arrays like syrk_tri's ``C`` are
**row-private**: every ref carries the parallel coefficient, so parallel
iteration ``g`` touches only its own row slice ``[g*c0, (g+1)*c0)`` and no
other iteration (of any thread) ever revisits those lines.  All their reuse
events are within one iteration of one thread, and with the restricted
shapes below every per-line gap has a closed form affine in ``(g, line)``.
The whole array's contribution to a window is then a host-precomputed
``[T, NW, NBINS]`` histogram table: the device adds one row per window
instead of sorting the array's stream.

Eligible group shape (mechanically checked; ineligible arrays stay on the
sort path):

- every ref of the array (in this nest; the array must appear in no other
  nest) has parallel address coefficient ``c0 != 0`` (same for all), and
  exactly one other addressed level — its innermost — with coefficient 1,
  start 0, step 1 (a dense row walk);
- row containment and alignment: the in-iteration address span is smaller
  than ``c0*step0`` and rows start cache-line-aligned;
- no share span on any ref;
- mid levels are pure position multipliers: unbounded, no address term;
- the addressed level's bound (or static trip) is identical across refs.

Gap classes per (g, line): intra-offset, j-step, mid-rollover, inter-block
bridge, and one cold per line.  Exactness is checked, not argued: block
time-disjointness and gap positivity are asserted over the full
``(g, line)`` grid, and :func:`build_rowpriv` replays sampled iterations
through a brute lexsort oracle; any mismatch leaves the group on the sort
path.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pluss_torch.config import NBINS, SamplerConfig
from pluss_torch.spec import FlatRef, LoopNestSpec, flatten_nest


@dataclasses.dataclass(frozen=True)
class _Block:
    """Refs identical up to position offset, sorted by offset."""

    refs: tuple[FlatRef, ...]
    j_lvl: int                      # the addressed (innermost) level
    mids: tuple[int, ...]           # mid levels, outer -> inner

    def offs(self, g):
        """[n_r, G] per-ref position offsets at parallel index g."""
        return np.stack([fr.offset + fr.offset_k * g for fr in self.refs])

    def stride(self, fr: FlatRef, lvl: int, g):
        sk = fr.pos_strides_k[lvl] if fr.pos_strides_k else 0
        return fr.pos_strides[lvl] + sk * g


def _group_blocks(frs: list[FlatRef]) -> list[_Block] | None:
    """Partition an array's refs into offset-only blocks, or None."""
    keyed: dict = {}
    for fr in frs:
        key = (fr.trips, fr.starts, fr.steps, fr.pos_strides,
               fr.pos_strides_k, fr.bounds, fr.starts_k, fr.addr_coefs)
        keyed.setdefault(key, []).append(fr)
    blocks = []
    for key, refs in keyed.items():
        refs = sorted(refs, key=lambda fr: fr.offset)
        fr0 = refs[0]
        d = len(fr0.trips)
        j_lvl = d - 1
        blocks.append(_Block(tuple(refs), j_lvl, tuple(range(1, d - 1))))
    return blocks


def eligible(spec: LoopNestSpec, ni: int, frs: list[FlatRef]) -> str | None:
    """None if the array group qualifies, else a reason string."""
    arr = frs[0].ref.array
    for oi, nest in enumerate(spec.nests):
        if oi == ni:
            continue
        if any(fr.ref.array == arr for fr in flatten_nest(nest)):
            return f"array {arr} is touched by nest {oi} too"
    c0s = {fr.addr_coefs[0] for fr in frs}
    if len(c0s) != 1 or 0 in c0s:
        return "parallel coefficient missing or mixed"
    jkey = None
    for fr in frs:
        d = len(fr.trips)
        addressed = [l for l in range(1, d) if fr.addr_coefs[l]]
        if addressed != [d - 1]:
            return "addressed level is not exactly the innermost"
        j = d - 1
        if fr.addr_coefs[j] != 1 or fr.steps[j] != 1 or fr.starts[j] != 0 \
                or (fr.starts_k and fr.starts_k[j]):
            return "inner walk is not a dense 0-based unit row walk"
        for l in range(1, d - 1):
            if fr.bounds and fr.bounds[l] is not None:
                return "bounded mid level"
        jb = (fr.bounds[j] if fr.bounds else None, fr.trips[j])
        if jkey is None:
            jkey = jb
        elif jkey != jb:
            return "inner bounds differ across refs"
        if fr.ref.share_span:
            return "ref carries a share span"
    if len({fr.ref.addr_base for fr in frs}) != 1:
        return "refs disagree on the row base address"
    return None


def _m_of(frs: list[FlatRef], g: np.ndarray) -> np.ndarray:
    """[G] effective inner trip at each parallel index."""
    fr = frs[0]
    j = len(fr.trips) - 1
    mt = fr.trips[j]
    if fr.bounds and fr.bounds[j] is not None:
        a, b = fr.bounds[j]
        return np.clip(a + b * g, 0, mt)
    return np.full(g.shape, mt, np.int64)


def group_hist(frs: list[FlatRef], cfg: SamplerConfig, sched,
               G: int) -> np.ndarray | None:
    """[G, NBINS] per-parallel-iteration event histogram of one eligible
    array group, or None when any structural/positivity check fails."""
    ds, cls = cfg.ds, cfg.cls
    if cls % ds:
        return None
    lpe = cls // ds
    fr0 = frs[0]
    c0 = fr0.addr_coefs[0]
    # row containment + alignment: iterations' line sets must be disjoint
    mt = fr0.trips[len(fr0.trips) - 1]
    if mt - 1 >= c0 * sched.step:
        return None
    if (c0 * sched.step * ds) % cls or \
            any(((fr.ref.addr_base + fr.addr_coefs[0] * sched.start) * ds)
                % cls for fr in frs):
        return None
    blocks = _group_blocks(frs)
    g = np.arange(G, dtype=np.int64)
    m = _m_of(frs, g)                       # [G]
    Lg = -(-m // lpe)                       # [G] lines touched
    Lmax = int(Lg.max(initial=0))
    if Lmax == 0:
        return np.zeros((G, NBINS), np.int64)
    l = np.arange(Lmax, dtype=np.int64)[None, :]        # [1, Lmax]
    lmask = l < Lg[:, None]                             # [G, Lmax]
    width = np.where(lmask, np.minimum((l + 1) * lpe, m[:, None]) - l * lpe,
                     0)                                  # [G, Lmax]

    hist = np.zeros((G, NBINS), np.int64)

    def add(vals, counts):
        """Accumulate a gap class, [G] or [G, Lmax] shaped; the g index is
        the first axis of the live mask either way.  Returns False (model
        invalid) on any non-positive gap — the positivity check IS the
        proof that the assumed per-line time order holds."""
        vals = np.asarray(vals, np.int64)
        counts = np.asarray(counts, np.int64)
        live = counts > 0
        if not live.any():
            return True
        if (vals[live] < 1).any():
            return False
        bins = np.frexp(vals[live].astype(np.float64))[1].astype(np.int64)
        np.add.at(hist, (np.nonzero(live)[0], bins), counts[live])
        return True

    # per-block geometry: first/last touch position of line l (relative to
    # the iteration start; the common clock base cancels in every gap)
    firsts, lasts = [], []
    per_block = []
    for b in blocks:
        fr = b.refs[0]
        offs = b.offs(g)                                 # [n_r, G]
        if (np.diff(offs, axis=0) <= 0).any():
            return None
        S_j = b.stride(fr, b.j_lvl, g)                   # [G]
        if (S_j[m > 0] <= 0).any():
            return None
        S_mids = [b.stride(fr, lvl, g) for lvl in b.mids]
        Ks = [fr.trips[lvl] for lvl in b.mids]
        K_tot = int(np.prod(Ks, dtype=np.int64)) if Ks else 1
        span_off = offs[-1] - offs[0]                    # [G]
        sum_wrap = sum((K - 1) * S for K, S in zip(Ks, S_mids)) \
            if Ks else np.zeros(G, np.int64)
        first = offs[0][:, None] + l * lpe * S_j[:, None]          # [G, L]
        last = (offs[-1] + sum_wrap)[:, None] \
            + (np.minimum((l + 1) * lpe, m[:, None]) - 1) * S_j[:, None]
        firsts.append(np.where(lmask, first, 0))
        lasts.append(np.where(lmask, last, 0))
        per_block.append((offs, S_j, S_mids, Ks, K_tot, span_off))

    # fixed block order by first touch; time-disjointness per (g, line)
    order = sorted(range(len(blocks)),
                   key=lambda i: int(firsts[i][lmask].min(initial=0)))
    for a, c in zip(order, order[1:]):
        if (lasts[a][lmask] >= firsts[c][lmask]).any():
            return None

    for bi, b in enumerate(blocks):
        offs, S_j, S_mids, Ks, K_tot, span_off = per_block[bi]
        # intra-offset gaps: per (mids, j) occurrence
        for i in range(len(b.refs) - 1):
            if not add(offs[i + 1] - offs[i], m * K_tot):
                return None
        # j-step gaps: within a segment
        if not add(S_j - span_off, (m - Lg) * K_tot):
            return None
        # mid rollovers: level i increments, deeper levels wrap.  Width
        # enters the value, so full lines and the partial last line are
        # separate classes.
        for i in range(len(Ks)):
            wrap_deeper = sum((K - 1) * S
                              for K, S in zip(Ks[i + 1:], S_mids[i + 1:])) \
                if Ks[i + 1:] else 0
            n_roll = (Ks[i] - 1) * int(np.prod(Ks[:i], dtype=np.int64))
            base_val = S_mids[i] - wrap_deeper - span_off
            # value per line: base - (width-1)*S_j
            v = base_val[:, None] - (width - 1) * S_j[:, None]
            if not add(v, np.where(lmask, n_roll, 0)):
                return None
        # inter-block bridge to the next block in time order
        pos = order.index(bi)
        if pos + 1 < len(order):
            nb = order[pos + 1]
            v = firsts[nb] - lasts[bi]
            if not add(v, lmask.astype(np.int64)):
                return None
    # cold: one first-touch per line
    np.add.at(hist, (g, np.zeros(G, np.int64)), Lg)
    return hist


def brute_iteration_hist(frs: list[FlatRef], cfg: SamplerConfig,
                         g: int, start: int = 0,
                         step: int = 1) -> np.ndarray:
    """[NBINS] oracle histogram of one parallel iteration's group stream:
    full enumeration + lexsort (the verification twin of
    :func:`group_hist`'s closed forms).  ``start``/``step`` are the
    parallel loop's value-space parameters (engine convention: bounds use
    the iteration INDEX ``g``, addresses use the VALUE ``start + g*step``,
    engine._ref_window)."""
    ds, cls = cfg.ds, cfg.cls
    pos_all, line_all = [], []
    for fr in frs:
        d = len(fr.trips)
        shape = fr.trips[1:]
        idx = np.indices(shape, dtype=np.int64) if shape else \
            np.zeros((0, 1), np.int64)
        pos = np.full(shape or (1,), fr.offset + fr.offset_k * g, np.int64)
        addr = np.full(shape or (1,), fr.ref.addr_base
                       + fr.addr_coefs[0] * (start + g * step), np.int64)
        valid = np.ones(shape or (1,), bool)
        for l in range(1, d):
            il = idx[l - 1]
            sk = fr.pos_strides_k[l] if fr.pos_strides_k else 0
            pos = pos + il * (fr.pos_strides[l] + sk * g)
            if fr.bounds and fr.bounds[l] is not None:
                a, b = fr.bounds[l]
                valid = valid & (il < a + b * g)
            if fr.addr_coefs[l]:
                st = fr.starts[l] + (fr.starts_k[l] * g if fr.starts_k
                                     else 0)
                addr = addr + fr.addr_coefs[l] * (st + il * fr.steps[l])
        pos_all.append(pos[valid])
        line_all.append((addr[valid] * ds) // cls)
    pos = np.concatenate(pos_all)
    line = np.concatenate(line_all)
    order = np.lexsort((pos, line))
    line_s, pos_s = line[order], pos[order]
    same = np.concatenate([[False], line_s[1:] == line_s[:-1]])
    hist = np.zeros(NBINS, np.int64)
    gaps = pos_s[1:][same[1:]] - pos_s[:-1][same[1:]]
    if gaps.size:
        np.add.at(hist, np.frexp(gaps.astype(np.float64))[1].astype(
            np.int64), 1)
    hist[0] = int((~same).sum())
    return hist


def build_rowpriv(spec: LoopNestSpec, ni: int, refs, cfg: SamplerConfig,
                  sched, owned: np.ndarray, W: int, NW: int):
    """(sort_refs, hist_w) for one triangular nest.

    ``hist_w``: ``[T, NW, NBINS]`` int64 — the summed per-window event
    histogram of every row-private array, built from the owned-chunk
    matrix (so dynamic assignments and resume skips are already encoded);
    ``None`` when no array qualifies.  ``sort_refs``: the refs the device
    sort path still owns.
    """
    T = owned.shape[0]
    CS = cfg.chunk_size
    G = sched.trip
    by_arr: dict[str, list] = {}
    for fr in refs:
        by_arr.setdefault(fr.ref.array, []).append(fr)
    hist_g_total = None
    done = set()
    for arr, frs in by_arr.items():
        if eligible(spec, ni, frs) is not None:
            continue
        hg = group_hist(frs, cfg, sched, G)
        if hg is None:
            continue
        # verification: brute-replay sampled iterations (cheap: one
        # iteration each) — a formula bug disables the group, it cannot
        # ship a wrong histogram
        lpe = max(1, cfg.cls // cfg.ds)
        samples = sorted({0, 1, lpe - 1, lpe, 2 * lpe + 1, G // 2, G - 1}
                         & set(range(G)))
        ok = all((hg[s] == brute_iteration_hist(
            frs, cfg, s, sched.start, sched.step)).all() for s in samples)
        if not ok:
            continue
        hist_g_total = hg if hist_g_total is None else hist_g_total + hg
        done.add(arr)
    if not done:
        return tuple(refs), None
    # fold per-iteration histograms into per-(thread, window) tables via
    # the owned matrix: window w of thread t covers parallel indices
    # g = cid*CS + p for its W rounds' owned chunks
    slots = owned[:, :, None].astype(np.int64) * CS + np.arange(CS)  # [T,R,CS]
    valid = (owned[:, :, None] >= 0) & (slots < G)
    gsafe = np.where(valid, slots, 0)
    per_slot = np.where(valid[..., None], hist_g_total[gsafe], 0)
    hist_w = per_slot.reshape(T, NW, W * CS, NBINS).sum(axis=2)
    sort_refs = tuple(fr for fr in refs if fr.ref.array not in done)
    return sort_refs, hist_w.astype(np.int64)
