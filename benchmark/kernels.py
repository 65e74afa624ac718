"""Operations and bytes of the program's kernels, and the card's peaks.

The yardstick for every ``<kernel>_roofline`` metric: the least time the
card could take for a kernel's launches is the bytes the launches must move
(each input read once, each output written once) over the card's peak
bandwidth.  The shapes come from the plan's windows (a trace's: from its
ref count), never from anything the kernel reports, so the count stays the
same whatever implements the kernel.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import stream

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, bytes/s (at 700 W)
PEAK_HBM_BPS = 3.35e12

#: histogram slots of kernel 1's output row (int64 each)
NBINS = 49


def event_hist_bytes(rows: int, length: int, pos_bytes: int) -> int:
    """Kernel 1 (``carried_event_hist``) over one ``[rows, length]``
    sorted window: ``key_s`` int32, ``pos_s`` (``pos_bytes``), ``span_s``
    int32 and ``valid_s`` bool read once, the ``[rows, 49]`` int64
    histogram written once."""
    return rows * length * (4 + pos_bytes + 4 + 1) + rows * NBINS * 8


def event_hist_need_bytes(rows: int, length: int, ghosts: int, real: int,
                         pos_bytes: int) -> int:
    """What kernel 1's inputs over one ``[rows, length]`` window need: the
    valid flag of every entry, the position of every valid entry (the
    ``real`` accesses and the ``ghosts`` carried lines of each row, all
    valid), the key and the span of every real access, and the histogram
    written once.  The padding a bounded window's static shape adds, and
    the ghosts' keys and spans, decide nothing.  Never above
    :func:`event_hist_bytes`."""
    return rows * length + (real + rows * ghosts) * pos_bytes \
        + real * (4 + 4) + rows * NBINS * 8


#: bool masks kernel 2 reads per entry: ``is_evt``, ``share``, ``cold``
MASKS = 3


def masked_hist_need_bytes(n: int, pos_bytes: int) -> int:
    """Kernel 2 (``masked_hist``) over one batch of ``n`` entries: each
    entry's reuse (``pos_bytes``) and its three mask bytes read once, the
    ``[49]`` int64 histogram written once."""
    return n * (pos_bytes + MASKS) + NBINS * 8


def masked_hist_replay_bytes(refs: int) -> int:
    """Kernel 2's need over one replay of a ``refs``-ref trace: each ref's
    reuse and three masks read once (int32 reuses while every position
    fits), one histogram written.  The padding of the last batch decides
    nothing, and the histogram each further batch writes (392 bytes) is
    left out, so the count needs no batch geometry of the program's."""
    return masked_hist_need_bytes(refs, 4 if refs < 2**31 - 2 else 8)


def least_ms(nbytes: int) -> float:
    return nbytes / PEAK_HBM_BPS * 1e3


def _only(item: dict, names: set):
    """The spec document's loop ``item`` with only the refs ``names``."""
    if "body" not in item:
        return item if item["name"] in names else None
    body = [b for b in (_only(x, names) for x in item["body"])
            if b is not None]
    return dict(item, body=body) if body else None


def _real_per_window(doc_nest: dict, refs, np_, cfg) -> np.ndarray:
    """Accesses of ``refs`` in each window, all threads together (static
    round-robin chunks: window ``w`` holds chunks ``[w*W*T, (w+1)*W*T)``)."""
    nest = _only(doc_nest, {fr.ref.name for fr in refs})
    if nest is None:
        return np.zeros(np_.n_windows, np.int64)
    sizes = stream.iteration_sizes(nest)
    per_chunk = np.add.reduceat(sizes, np.arange(0, len(sizes),
                                                 cfg.chunk_size))
    per = np.add.reduceat(per_chunk, np.arange(
        0, len(per_chunk), np_.window_rounds * cfg.thread_num))
    return np.pad(per, (0, np_.n_windows - len(per)))


def sort_windows(pl, mix: dict, doc: dict, preds) -> list[tuple]:
    """``(rows, length, ghosts, real, pos_bytes)`` of each kernel-1 window
    that the predictions ``preds`` of ``mix`` ran on plan ``pl``: a full
    run's sort windows (the non-template windows, and inside template
    windows the arrays no template or overlay covers), or a sampled run's
    counted windows (drawn again from each prediction's sampling seed).
    ``length`` is the window's static shape per row, ``ghosts`` its carried
    lines per row, ``real`` its accesses over all rows."""
    cfg, spec = pl.cfg, pl.spec
    T = cfg.thread_num
    pb = np.dtype(pl.pos_dtype).itemsize
    counts = spec.line_counts(cfg)

    def window(np_, refs, ghost_refs, real: int):
        arrays = {spec.array_index(fr.ref.array) for fr in ghost_refs}
        G = sum(counts[a] for a in arrays)
        per_round = sum(int(np.prod(fr.trips[1:], dtype=np.int64))
                        for fr in refs)
        return (T, np_.window_rounds * cfg.chunk_size * per_round + G, G,
                int(real), pb)

    if mix["run"] == "sampled":
        out = []
        for p in preds:
            rng = np.random.default_rng(p.sample_seed)
            for ni, np_ in enumerate(pl.nests):
                sel = stream.drawn_windows(rng, np_.n_windows,
                                           float(mix["rate"]))
                if np_.refs:
                    real = _real_per_window(doc["nests"][ni], np_.refs,
                                            np_, cfg)
                    out += [window(np_, np_.refs, np_.refs, real[w])
                            for w in sel.tolist()]
        return out
    one = []
    for ni, np_ in enumerate(pl.nests):
        if not np_.refs:
            continue
        real = _real_per_window(doc["nests"][ni], np_.refs, np_, cfg)
        if np_.tri_buckets is not None:
            for ws, brefs in np_.tri_buckets:
                one += [window(np_, brefs or np_.refs, np_.refs, real[w])
                        for w in ws]
            continue
        ultra = np_.ultra_windows()
        var = np_.var_refs_novl
        vreal = _real_per_window(doc["nests"][ni], var, np_, cfg) \
            if var else None
        for w in range(np_.n_windows):
            if not ultra[w]:
                one.append(window(np_, np_.refs, np_.refs, real[w]))
            elif var:
                one.append(window(np_, var, var, vreal[w]))
    return one * len(preds)
