"""Per-thread reuse histograms of a loop-nest document, in plain torch.

The benchmark's own reading of what a PLUSS prediction counts, written
from the semantics alone.  It imports nothing of the program: it reads the
configuration's spec document (plain JSON dicts) and the schedule numbers.

- Each nest's outermost loop is the parallel one.  Its iterations are cut
  into chunks of ``chunk_size``; chunk ``c`` runs on thread ``c % T``, and
  every thread runs its chunks in increasing order, nest after nest.
- A loop runs ``trip`` iterations with values ``start + start_coef*k +
  i*step`` (``k`` the parallel iteration's index), or ``a + b*idx`` of them
  when it has ``bound_coef = [a, b]`` (``idx`` the index of the loop at
  depth ``bound_level``; depth 0 is the parallel loop).  A loop's body runs
  in the order written.
- Each thread has one clock, advanced by one at every access it makes.
- An access touches cache line ``addr*ds // cls`` of its array (``addr =
  addr_base + sum(coef * value[depth])``); the arrays' lines follow one
  another in declaration order, ``ceil(elements*ds/cls)`` each.
- An access whose thread touched the same line before has a reuse: the
  difference of the two clocks.  It is a share reuse, counted at its raw
  value, when its ref has a ``share_span`` and ``2*reuse > share_span``;
  otherwise it is counted in the bin ``2**floor(log2(reuse))``.  An access
  with no earlier access to its line by its thread is cold (key -1).

The accesses are enumerated on the device in blocks of whole chunks, in
each thread's clock order; a stable sort by line puts each access beside
its predecessor, and a table of each line's last clock carries the
predecessors from one block to the next.
"""

from __future__ import annotations

import numpy as np
import torch

#: histogram slots: slot 0 the cold count, slot 1+e the bin 2**e
NBINS = 49

#: most accesses one enumerated block holds (whole chunks; a chunk larger
#: than this is one block)
BLOCK_ACCESSES = 1 << 27

#: accesses per window per thread, whole chunk rounds (the sampler's
#: published window size)
WINDOW_ACCESSES = 1 << 23


class Schedule:
    """The schedule and machine numbers a prediction depends on."""

    def __init__(self, thread_num: int, chunk_size: int, ds: int, cls: int):
        self.T, self.CS, self.ds, self.cls = thread_num, chunk_size, ds, cls


def _is_loop(item: dict) -> bool:
    return "body" in item


def _refs(item: dict):
    if not _is_loop(item):
        yield item
        return
    for b in item["body"]:
        yield from _refs(b)


def line_bases(doc: dict, sch: Schedule) -> dict:
    """First global line id of each array."""
    out, acc = {}, 0
    for name, n in doc["arrays"]:
        out[name] = acc
        acc += -(-n * sch.ds // sch.cls)
    return out


def total_lines(doc: dict, sch: Schedule) -> int:
    return sum(-(-n * sch.ds // sch.cls) for _, n in doc["arrays"])


class _Ctx:
    def __init__(self, doc, sch, device, spans, byte_bases=None):
        self.sch, self.device = sch, device
        self.bases = line_bases(doc, sch)
        self.spans = spans   # share span -> one-byte code
        # array -> first byte address: the accesses' int64 byte addresses
        # (``byte_base + addr*ds``) take the place of their lines
        self.byte_bases = byte_bases


def _excl(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0) - x


def _trips(loop: dict, idxs: list, n: int, device) -> torch.Tensor:
    bc = loop.get("bound_coef")
    if bc is None:
        return torch.full((n,), loop["trip"], dtype=torch.int64,
                          device=device)
    a, b = bc
    return (a + b * idxs[loop.get("bound_level", 0)]).clamp_(min=0)


def _emit(item: dict, vals: list, idxs: list, ctx: _Ctx):
    """``(line, code, counts)`` of every access ``item`` makes for each of
    the ``n`` rows (one row per iteration of the enclosing loops): the
    accesses grouped by row, each row's in program order."""
    n = vals[0].shape[0]
    dev = ctx.device
    if not _is_loop(item):
        addr = torch.full((n,), item.get("addr_base", 0), dtype=torch.int64,
                          device=dev)
        for depth, coef in item["addr_terms"]:
            addr += coef * vals[depth]
        if ctx.byte_bases is not None:
            addr.mul_(ctx.sch.ds).add_(ctx.byte_bases[item["array"]])
            return addr, None, None
        line = (addr * ctx.sch.ds).div_(ctx.sch.cls, rounding_mode="floor")
        line += ctx.bases[item["array"]]
        code = torch.full((n,), ctx.spans[item.get("share_span") or 0],
                          dtype=torch.uint8, device=dev)
        return line.to(torch.int32), code, None
    trips = _trips(item, idxs, n, dev)
    parent = torch.repeat_interleave(torch.arange(n, device=dev), trips)
    i = torch.arange(parent.shape[0], device=dev) - _excl(trips)[parent]
    start = item.get("start", 0) + item.get("start_coef", 0) * idxs[0][parent]
    cvals = [v[parent] for v in vals] + [start + i * item.get("step", 1)]
    cidxs = [x[parent] for x in idxs] + [i]
    del i, start
    line, code, cnt = _body(item["body"], cvals, cidxs, ctx)
    del cvals, cidxs
    if cnt is None:
        cnt = torch.ones(parent.shape[0], dtype=torch.int64, device=dev)
    counts = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, parent, cnt)
    return line, code, counts


def _body(body: list, vals: list, idxs: list, ctx: _Ctx):
    """The accesses of one run of ``body`` per row, interleaved in program
    order.  ``counts`` is None when every row makes exactly one access."""
    outs = [_emit(item, vals, idxs, ctx) for item in body]
    if len(outs) == 1:
        return outs[0]
    n = vals[0].shape[0]
    dev = ctx.device
    one = torch.ones(n, dtype=torch.int64, device=dev)
    cnts = [one if c is None else c for _, _, c in outs]
    cnt = torch.stack(cnts).sum(0)
    off = _excl(cnt)
    total = int(cnt.sum())
    line = torch.empty(total, dtype=outs[0][0].dtype, device=dev)
    code = None if outs[0][1] is None else \
        torch.empty(total, dtype=torch.uint8, device=dev)
    prefix = torch.zeros(n, dtype=torch.int64, device=dev)
    for (l, c, k), kk in zip(outs, cnts):
        if k is None:
            dest = off + prefix
        else:
            row = torch.repeat_interleave(torch.arange(n, device=dev), k)
            dest = torch.arange(row.shape[0], device=dev) \
                - _excl(k)[row] + (off + prefix)[row]
        line[dest] = l
        if code is not None:
            code[dest] = c
        prefix += kk
    return line, code, cnt


def enumerate_iterations(nest: dict, ks: torch.Tensor, ctx: _Ctx):
    """``(line int32, code uint8, sizes)`` of the parallel iterations
    ``ks`` in that order: their accesses in clock order, and each
    iteration's access count."""
    vals = [nest.get("start", 0) + ks * nest.get("step", 1)]
    line, code, cnt = _body(nest["body"], vals, [ks], ctx)
    if cnt is None:
        cnt = torch.ones(ks.shape[0], dtype=torch.int64, device=ks.device)
    return line, code, cnt


def iteration_sizes(nest: dict) -> np.ndarray:
    """Exact accesses of each parallel iteration, on the host: a loop
    whose index bounds a loop inside it is expanded, any other multiplies
    its body's size by its trip."""
    ks = np.arange(nest["trip"], dtype=np.int64)

    def bounded_on(item, level) -> bool:
        if not _is_loop(item):
            return False
        if item.get("bound_coef") is not None and \
                item.get("bound_level", 0) == level:
            return True
        return any(bounded_on(b, level) for b in item["body"])

    def size(item, idxs: list, level: int):
        # idxs: per enclosing level, an index array (or scalar) per row
        if not _is_loop(item):
            return 1
        bc = item.get("bound_coef")
        trips = item["trip"] if bc is None else \
            np.maximum(bc[0] + bc[1] * idxs[item.get("bound_level", 0)], 0)
        if not any(bounded_on(b, level) for b in item["body"]):
            return trips * sum(size(b, idxs + [0], level + 1)
                               for b in item["body"])
        total = 0
        for t in range(int(np.max(trips))):
            body = sum(size(b, idxs + [t], level + 1) for b in item["body"])
            total = total + np.where(t < trips, body, 0)
        return total

    s = sum(size(b, [ks], 1) for b in nest["body"])
    return np.broadcast_to(np.asarray(s, np.int64), ks.shape).copy()


class _Counts:
    """One thread's counted events: the dense noshare bins and the share
    reuses' raw values with their counts."""

    def __init__(self, device):
        self.bins = torch.zeros(NBINS, dtype=torch.int64, device=device)
        self.share: dict[int, int] = {}

    def add_share(self, vals: torch.Tensor) -> None:
        if vals.numel() == 0:
            return
        u, c = torch.unique(vals, return_counts=True)
        for v, n in zip(u.tolist(), c.tolist()):
            self.share[v] = self.share.get(v, 0) + n


def walk_block(line: torch.Tensor, code: torch.Tensor, pos0: int,
               table: torch.Tensor, span_of: torch.Tensor,
               counts: _Counts | None) -> None:
    """Advance ``table`` (each line's last clock, -1 for never) over one
    block of accesses at clocks ``pos0, pos0+1, ...``; with ``counts``,
    count each access's event there."""
    m = line.shape[0]
    if m == 0:
        return
    sl, perm = torch.sort(line, stable=True)
    sl = sl.long()
    change = sl[1:] != sl[:-1]
    first = torch.cat([change.new_ones(1), change])
    last = torch.cat([change, change.new_ones(1)])
    pos = perm + pos0
    if counts is not None:
        prev = torch.cat([pos.new_full((1,), -1), pos[:-1]])
        prev = torch.where(first, table[sl], prev)
        cold = prev < 0
        reuse = pos - prev
        span = span_of[code[perm].long()]
        share = ~cold & (span > 0) & (2 * reuse > span)
        evt = ~cold & ~share
        _, e = torch.frexp(reuse[evt].double())
        counts.bins[0] += cold.sum()
        counts.bins[1:] += torch.bincount(e.long() - 1, minlength=NBINS - 1)
        counts.add_share(reuse[share])
    table[sl[last]] = pos[last]


def serial_addresses(doc: dict, ds: int, byte_bases: dict, device):
    """The byte address of every access of the loop nests run by one
    thread in program order (each array at its ``byte_bases`` entry, an
    element ``ds`` bytes), in blocks of whole parallel iterations."""
    sch = Schedule(1, 1, ds, 1)
    ctx = _Ctx(doc, sch, device, {}, byte_bases)
    for nest in doc["nests"]:
        sizes = iteration_sizes(nest)
        for run in _blocks(range(nest["trip"]), sizes, nest, 1):
            addr, _, _ = enumerate_iterations(
                nest, _iters_of(run, nest, 1, device), ctx)
            yield addr


def _chunk_iters(c: int, nest: dict, CS: int) -> tuple[int, int]:
    return c * CS, min((c + 1) * CS, nest["trip"])


def _blocks(chunks: list, sizes: np.ndarray, nest: dict, CS: int):
    """Runs of consecutive chunks of at most BLOCK_ACCESSES accesses (one
    chunk at the least)."""
    run, acc = [], 0
    for c in chunks:
        lo, hi = _chunk_iters(c, nest, CS)
        s = int(sizes[lo:hi].sum())
        if run and acc + s > BLOCK_ACCESSES:
            yield run
            run, acc = [], 0
        run.append(c)
        acc += s
    if run:
        yield run


def _iters_of(chunks: list, nest: dict, CS: int, device) -> torch.Tensor:
    ks = [np.arange(*_chunk_iters(c, nest, CS)) for c in chunks]
    return torch.as_tensor(np.concatenate(ks), dtype=torch.int64,
                           device=device)


def _span_table(doc: dict, device):
    spans = sorted({0} | {r.get("share_span") or 0 for n in doc["nests"]
                          for r in _refs(n)})
    return ({s: i for i, s in enumerate(spans)},
            torch.tensor(spans, dtype=torch.int64, device=device))


class Histograms:
    """What the sampler reports: per thread the noshare histogram
    ``{-1: cold, 2**e: count}`` and the share histogram ``{reuse:
    count}``, and the number of accesses."""

    def __init__(self, noshare: list, share: list, accesses: int):
        self.noshare, self.share, self.accesses = noshare, share, accesses


def _noshare_dict(bins: np.ndarray, scale=None) -> dict:
    f = (lambda c: float(c)) if scale is None else (lambda c: c * scale)
    out = {-1: f(bins[0])}
    for e in range(NBINS - 1):
        if bins[1 + e]:
            out[1 << e] = f(bins[1 + e])
    return out


def full(doc: dict, sch: Schedule, device) -> Histograms:
    """Every access of every thread, counted."""
    spans, span_of = _span_table(doc, device)
    ctx = _Ctx(doc, sch, device, spans)
    T, CS = sch.T, sch.CS
    noshare, share, accesses = [], [], 0
    sizes = [iteration_sizes(n) for n in doc["nests"]]
    for t in range(T):
        table = torch.full((total_lines(doc, sch),), -1, dtype=torch.int64,
                           device=device)
        counts = _Counts(device)
        clock = 0
        for nest, sz in zip(doc["nests"], sizes):
            n_chunks = -(-nest["trip"] // CS)
            for run in _blocks(range(t, n_chunks, T), sz, nest, CS):
                line, code, _ = enumerate_iterations(
                    nest, _iters_of(run, nest, CS, device), ctx)
                walk_block(line, code, clock, table, span_of, counts)
                clock += line.shape[0]
                del line, code
        accesses += clock
        noshare.append(_noshare_dict(counts.bins.cpu().numpy()))
        share.append({v: float(c) for v, c in counts.share.items()})
    return Histograms(noshare, share, accesses)


def window_geometry(nest: dict, sch: Schedule, sizes: np.ndarray):
    """``(W, NW, body)``: chunk rounds per window, windows, and the most
    accesses of one parallel iteration.  A window holds whole rounds (one
    chunk per thread each) and about WINDOW_ACCESSES accesses per thread."""
    n_chunks = -(-nest["trip"] // sch.CS)
    R = -(-n_chunks // sch.T)
    body = int(sizes.max())
    W = max(1, min(R, -(-WINDOW_ACCESSES // (sch.CS * body))))
    return W, -(-R // W), body


def drawn_windows(rng: np.random.Generator, NW: int,
                  rate: float) -> np.ndarray:
    """The windows a uniform subset estimate counts in one nest:
    ``max(1, round(rate * NW))`` of them, drawn without replacement, in
    increasing order."""
    return np.sort(rng.choice(NW, max(1, round(rate * NW)), replace=False))


def sampled(doc: dict, sch: Schedule, device, rate: float,
            seed: int) -> Histograms:
    """The uniform subset estimate: in each nest, ``max(1, round(rate *
    NW))`` windows drawn without replacement by
    ``numpy.random.default_rng(seed).choice`` (nests in order, one
    generator), each counted from empty tables after its ``k`` preceding
    windows are walked uncounted (``k`` covers the nest's largest share
    span, at least 1, at most NW-1); counts scale by ``NW / drawn``."""
    spans, span_of = _span_table(doc, device)
    ctx = _Ctx(doc, sch, device, spans)
    T, CS = sch.T, sch.CS
    rng = np.random.default_rng(seed)
    bins = np.zeros((T, NBINS), np.float64)
    share: list[dict] = [dict() for _ in range(T)]
    base = np.zeros(T, np.int64)   # each thread's clock at the nest's start
    for nest in doc["nests"]:
        sizes = iteration_sizes(nest)
        W, NW, body = window_geometry(nest, sch, sizes)
        span = max((r.get("share_span") or 0 for r in _refs(nest)),
                   default=0)
        k = min(max(1, -(-span // (W * CS * body))), NW - 1)
        sel = drawn_windows(rng, NW, rate)
        nsel = len(sel)
        scale = NW / nsel
        n_chunks = -(-nest["trip"] // CS)
        counted = np.zeros((T, NBINS), np.int64)
        shared: list[dict] = [dict() for _ in range(T)]
        for t in range(T):
            chunks = list(range(t, n_chunks, T))
            csz = np.array([sizes[slice(*_chunk_iters(c, nest, CS))].sum()
                            for c in chunks], np.int64)
            cstart = base[t] + np.concatenate([[0], np.cumsum(csz)[:-1]])
            for w in sel.tolist():
                table = torch.full((total_lines(doc, sch),), -1,
                                   dtype=torch.int64, device=device)
                counts = _Counts(device)
                for wc in range(max(0, w - k), w + 1):
                    run = chunks[wc * W:(wc + 1) * W]
                    if not run:
                        continue
                    line, code, _ = enumerate_iterations(
                        nest, _iters_of(run, nest, CS, device), ctx)
                    walk_block(line, code, int(cstart[wc * W]), table,
                               span_of, counts if wc == w else None)
                    del line, code
                counted[t] += counts.bins.cpu().numpy()
                for v, c in counts.share.items():
                    shared[t][v] = shared[t].get(v, 0) + c
            base[t] += int(csz.sum())
        bins += counted * scale
        for t in range(T):
            for v, c in shared[t].items():
                share[t][v] = share[t].get(v, 0.0) + c * scale
    noshare = [_noshare_dict(b, 1.0) for b in bins]
    return Histograms(noshare, share, int(base.sum()))
