"""Reuse-interval extraction as sorting, on ``[T, n]`` batches of windows.

The reuse interval of an access is the gap to the previous position of the
same cache line.  Sorting a window of the stream by ``(line, position)``
places every line's accesses consecutively in position order, so one
vectorized subtraction yields every reuse at once.  The window is sorted
together with one *ghost* entry per covered line that carries the line's
carried ``last_pos`` value (-1 if never touched), so every real access finds
its predecessor — carried or in-window — as its left neighbour.

The engine's functions work on a leading batch dimension of simulated
threads (the JAX package's ``vmap`` axis, written out): rows are
independent windows.  The trace replay's (:func:`window_events`,
:func:`batch_events`, :func:`event_histogram`) work on one 1-D stream
slice resolved against a carried ``last_pos`` table.  Counterparts of
``pluss/ops/reuse.py``, equal to them on the same inputs.
"""

from __future__ import annotations

import torch

from pluss_torch.config import NBINS

#: line id that sorts after every real line (invalid entries).
LINE_SENTINEL = 2**31 - 1

#: share keys pack (thread, reuse) as ``thread << SHARE_SHIFT | reuse``;
#: share reuses are positive and below 2**47 (the NBINS range), so the pack
#: is exact for up to 2**15 threads.
SHARE_SHIFT = 48

_INT32_MIN = -(2**31)


def share_mask(reuse, span):
    """Cross-thread classification ``2*reuse > span`` written division-sided
    (``reuse > span//2``, equal for integers of either parity) so a reuse
    near the int32 ceiling cannot overflow.  Works on tensors and numpy
    arrays alike."""
    return (span > 0) & (reuse > span // 2)


def log2_bin(reuse: torch.Tensor) -> torch.Tensor:
    """Slot of the reference's log2 binning: reuse in [2^e, 2^{e+1}) -> 1+e
    (slot 0 is the cold key).  ``frexp``'s exponent of ``max(reuse, 1)`` is
    exactly 1+e for every integer below 2**53."""
    return torch.frexp(torch.clamp(reuse, min=1).to(torch.float64)).exponent


def sort_stream(line, pos, span, valid):
    """Sort each row by (line, position); invalid entries sort last.

    int32 positions pack with the line into one int64 key (line in the high
    word, ``pos + 2**31`` in the low word), so one sort realizes the two-key
    order.  int64 positions take two stable sorts, position then line.
    Returns ``(key_s int32, pos_s, span_s int32, valid_s bool)``.
    """
    return sort_columns([line, pos, span, valid])


def sort_columns(cols: list):
    """:func:`sort_stream` of ``cols = [line, pos, span, valid]``, which it
    empties: each input is dropped as soon as it is consumed, so a caller
    that keeps no other reference to them does not hold them through the
    sort (its buffers and workspace set the sort window's peak memory)."""
    line, pos, span, valid = cols
    cols.clear()
    key = torch.where(valid, line, LINE_SENTINEL)
    del line, valid
    if pos.dtype == torch.int32:
        packed = key.to(torch.int64).bitwise_left_shift_(32)
        del key
        packed.bitwise_or_(pos.to(torch.int64) - _INT32_MIN)
        del pos
        packed, order = torch.sort(packed, dim=-1)
        key_s = (packed >> 32).to(torch.int32)
        pos_s = ((packed & 0xFFFFFFFF) + _INT32_MIN).to(torch.int32)
        del packed
    else:
        # the sorted values are not kept: only the permutation is needed
        order = torch.sort(pos, dim=-1, stable=True)[1]
        key = key.gather(-1, order)
        key_s, by_key = torch.sort(key, dim=-1, stable=True)
        del key
        order = order.gather(-1, by_key)
        del by_key
        pos_s = pos.gather(-1, order)
        del pos
    return key_s, pos_s, span.gather(-1, order), key_s != LINE_SENTINEL


def ghost_entries(last_pos: torch.Tensor, line0: int):
    """(line, pos, span, valid) ghost block for lines [line0, line0+c) of a
    ``[T, c]`` slice of the carried table: ``pos`` is the slice itself,
    ``span`` 0 (ghosts never classify events), ``valid`` all True."""
    T, c = last_pos.shape
    line = torch.arange(line0, line0 + c, dtype=torch.int32,
                        device=last_pos.device).expand(T, c)
    return (line, last_pos,
            torch.zeros((T, c), dtype=torch.int32, device=last_pos.device),
            torch.ones((T, c), dtype=torch.bool, device=last_pos.device))


def carried_events(key_s, pos_s, span_s, valid_s, win_start):
    """Reuse events of ghost-merged sorted windows.

    ``win_start`` (``[T]`` or a scalar) is each row's smallest stream
    position; entries below it are ghosts.  A real entry whose same-line
    left neighbour has ``pos >= 0`` is an event with ``reuse = pos - prev``;
    one whose same-line left neighbour is a ``pos < 0`` ghost is cold.
    """
    ws = torch.as_tensor(win_start, device=pos_s.device)
    if ws.ndim:
        ws = ws[..., None]
    real = valid_s & (pos_s >= ws)
    same = torch.cat([torch.zeros_like(valid_s[..., :1]),
                      key_s[..., 1:] == key_s[..., :-1]], dim=-1)
    prev_pos = torch.cat([pos_s[..., :1], pos_s[..., :-1]], dim=-1)
    is_evt = real & same & (prev_pos >= 0)
    cold = real & same & (prev_pos < 0)
    reuse = torch.where(is_evt, pos_s - prev_pos, 0).to(pos_s.dtype)
    return {
        "reuse": reuse,
        "is_evt": is_evt,
        "share": is_evt & share_mask(reuse, span_s),
        "cold": cold,
    }


def extract_tails(key_s, pos_s, valid_s, n_lines: int) -> torch.Tensor:
    """New ``last_pos`` values of ghost-merged sorted windows, in line order.

    The last entry of each line's segment holds the line's latest position
    (a real access, or the ghost itself when the window left the line
    untouched).  With ghosts covering ``n_lines`` lines, each row has
    exactly that many segment-last valid entries, already in ascending line
    order: they are compacted into ``[T, n_lines]`` by their running count.
    """
    seg_last = torch.cat([key_s[..., 1:] != key_s[..., :-1],
                          torch.ones_like(valid_s[..., :1])], dim=-1)
    keep = seg_last & valid_s
    # one scan over the flattened batch, rebased per row: a scan along the
    # last dim of a few long rows runs far slower on CUDA (measured on the
    # H100, PERF.md)
    run = torch.cumsum(keep.reshape(-1), 0).view(keep.shape)
    slot = run - (run[..., -1:] - keep.sum(-1, keepdim=True)) - 1
    slot = torch.where(keep & (slot < n_lines), slot, n_lines)
    out = torch.zeros(key_s.shape[:-1] + (n_lines + 1,), dtype=pos_s.dtype,
                      device=pos_s.device)
    # non-tail entries all land in the dump column, sliced off below
    out.scatter_(-1, slot, pos_s)
    return out[..., :n_lines]


def bin_histogram(bins: torch.Tensor, wgt: torch.Tensor,
                  num_segments: int = NBINS) -> torch.Tensor:
    """``[..., num_segments]`` int64 histogram of integer weights over the
    last dim.  Bins outside ``[0, num_segments)`` weigh nothing (as in the
    JAX one-hot form); integer adds keep it exact in any order."""
    ok = (bins >= 0) & (bins < num_segments)
    idx = torch.where(ok, bins, num_segments).to(torch.int64)
    out = torch.zeros(bins.shape[:-1] + (num_segments + 1,),
                      dtype=torch.int64, device=bins.device)
    out.scatter_add_(-1, idx, wgt.to(torch.int64))
    return out[..., :num_segments]


def share_keys(reuse: torch.Tensor, share: torch.Tensor,
               tids: torch.Tensor | None = None) -> torch.Tensor:
    """Packed ``thread << SHARE_SHIFT | reuse`` keys of the share events of a
    ``[T, n]`` batch, as a 1-D int64 tensor.  Row ``i`` is simulated thread
    ``tids[i]`` (default: the row index)."""
    if tids is None:
        tids = torch.arange(reuse.shape[0], device=reuse.device)
    # select first: the packing then touches only the share events
    tid = tids.to(torch.int64)[:, None].expand(reuse.shape)[share]
    return (tid << SHARE_SHIFT) | reuse[share].to(torch.int64)


def share_unique(keys: torch.Tensor, counts: torch.Tensor | None = None):
    """Exact ``(unique keys, counts)`` of packed share keys; ``counts``
    weighs each key (default 1).  The reference keeps share reuses raw until
    the racetrack post-pass, so values must be exact — no capacity, so no
    overflow and no retry.

    Both results are compact copies: on CUDA ``torch.unique`` shrinks its
    outputs with ``resize_``, which keeps a buffer the size of ``keys``,
    and a run holds every window's uniques until it merges them."""
    if counts is None:
        uniq, cnt = torch.unique(keys, return_counts=True)
        return uniq.clone(), cnt.clone()
    uniq, inv = torch.unique(keys, return_inverse=True)
    tot = torch.zeros(uniq.shape, dtype=torch.int64, device=keys.device)
    return uniq.clone(), tot.scatter_add_(0, inv, counts.to(torch.int64))


def window_events(key_s, pos_s, valid_s, last_pos, span_s=None):
    """Reuse events of one sorted 1-D stream slice, resolved against the
    carried table, which this call advances IN PLACE.

    ``last_pos`` holds each line's latest stream position before the slice
    (-1 if never touched) in ``last_pos[:-1]``; its last slot is a dump
    slot.  A segment head (first in-slice touch of a line) reads its
    carried value with one gather: an event when it is >= 0, cold
    otherwise.  Other valid entries are in-slice reuses of their left
    neighbour.  Segment tails (last in-slice touch) then write their
    positions with one scatter, and every other entry writes into the dump
    slot, so the scatter needs no compaction and no host sync; only the
    dump slot ever sees more than one write.

    Returns the event dict ``{reuse (pos dtype), is_evt, share, cold}``
    plus the sorted ``key``, ``pos`` and ``span`` it was computed from
    (the sharded window's head capture reads them).  ``span_s`` is each
    entry's share span: an event is ``share`` when ``reuse > span // 2``.
    A trace stream has none (``span_s`` None), so ``share`` is all False.
    """
    dump = last_pos.shape[0] - 1
    same = key_s[1:] == key_s[:-1]
    prev_same = torch.cat([same.new_zeros(1), same])
    next_same = torch.cat([same, same.new_zeros(1)])
    local_evt = prev_same & valid_s
    head = valid_s & ~prev_same
    tail = valid_s & ~next_same
    carried = last_pos.gather(0, torch.where(head, key_s, dump).long())
    head_evt = head & (carried >= 0)
    prev_pos = torch.cat([pos_s[:1], pos_s[:-1]])
    reuse = torch.where(local_evt, pos_s - prev_pos,
                        torch.where(head_evt, pos_s - carried, 0))
    last_pos.scatter_(0, torch.where(tail, key_s, dump).long(), pos_s)
    is_evt = local_evt | head_evt
    reuse = reuse.to(pos_s.dtype)
    share = torch.zeros_like(is_evt) if span_s is None \
        else is_evt & share_mask(reuse, span_s)
    return {"reuse": reuse, "is_evt": is_evt, "share": share,
            "cold": head & (carried < 0), "key": key_s, "pos": pos_s,
            "span": span_s}


def batch_events(line, pos, valid, last_pos, span=None,
                 pos_sorted: bool = True):
    """Whole-slice segmented reuse extraction: one sort, one carried
    gather and one tail scatter (``last_pos`` advances in place, see
    :func:`window_events`).

    ``pos_sorted`` (a replayed trace, whose positions are the stream order
    itself): one stable sort on the line key (invalid entries last) keeps
    the position order within each line.  ``pos_sorted=False`` admits a
    stream that is not in position order (a sharded window concatenates
    its refs' enumerations in program order): it takes the full (line,
    pos) order of :func:`sort_columns`, one packed sort for int32
    positions and two stable passes for int64.  ``span`` carries each
    access's share span (None for a trace)."""
    if pos_sorted:
        key_s, order = torch.sort(torch.where(valid, line, LINE_SENTINEL),
                                  stable=True)
        pos_s = pos.gather(0, order)
        span_s = None if span is None else span.gather(0, order)
        valid_s = key_s != LINE_SENTINEL
    else:
        key_s, pos_s, span_s, valid_s = sort_columns(
            [line, pos, torch.zeros_like(line) if span is None else span,
             valid])
        if span is None:
            span_s = None
    return window_events(key_s, pos_s, valid_s, last_pos, span_s)


def event_histogram(ev: dict, include_cold: bool = True,
                    hist_fn=None) -> torch.Tensor:
    """``[NBINS]`` int64 histogram of one event dict: slot 0 = cold, slot
    1+e = no-share reuses in [2^e, 2^{e+1}).  ``hist_fn`` is the masked
    histogram: the kernel wrapper by default, or its plain version."""
    if hist_fn is None:
        from pluss_torch.ops.event_hist import masked_histogram as hist_fn
    return hist_fn(ev["reuse"], ev["is_evt"], ev["share"], ev["cold"],
                   include_cold)
