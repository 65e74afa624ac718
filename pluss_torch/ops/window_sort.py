"""The sort window's (line, pos) order as one keys-only sort of a packed,
window-relative key.

A sort window (``engine._sort_window``) orders each thread row's entries,
its refs' accesses and one ghost per covered line, by (line, position).
:func:`pluss_torch.ops.reuse.sort_columns` does it on the full-width
columns: int64 positions in two stable passes carrying int64 indices and
four gathers.  Here every field that decides the order, and the span code
that rides along, is packed into one 64-bit key whose widths
(:class:`KeyLayout`) the engine reckons per window from the plan, on the
host:

    row | line - line_lo | rel | code

``rel`` is 0 for a ghost and ``pos - win_start + 1`` for a real entry; an
invalid entry's line field is all ones, so it sorts last in its row.  One
sort of the keys alone then gives the order, and one pass over the
sorted keys the four columns the window's consumers read: ``key_s``
(int32, ``LINE_SENTINEL`` where invalid), ``pos_s`` (a ghost's from the
carried ``last_pos``), ``span_s`` (int32, through the span table) and
``valid_s``.  On every valid entry they equal :func:`sort_columns`' output;
an invalid entry gets the fill ``(LINE_SENTINEL, -1, 0, False)``, and its
consumers (kernel 1, ``carried_events``, ``extract_tails``, the sharded
window's head capture) read only its ``valid_s``.

:func:`window_sort` takes :func:`window_sort_plain` (the same packing,
``torch.sort`` of the key) for CPU tensors, where it also asserts the
width's promise on every entry, and for CUDA tensors launches
``pluss_torch/csrc/window_sort.cu``: a pack kernel per block of the
window, CUB's keys-only radix sort over the key's bits, an unpack kernel.
Nothing falls back: a kernel that fails to build or launch raises.  The
JAX package has no counterpart (its sort is ``lax.sort``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from pluss_torch.ops import build
from pluss_torch.ops.reuse import LINE_SENTINEL

#: the widest key: 63 bits keeps it a non-negative int64, so the plain
#: version's signed ``torch.sort`` and the kernel's unsigned radix sort
#: give one order
MAX_KEY_BITS = 63

#: the most entries one sort takes (CUB's item count is an ``int``)
MAX_ENTRIES = 2**31 - 1

_POS_DTYPES = (torch.int32, torch.int64)


@dataclasses.dataclass(frozen=True)
class KeyLayout:
    """Bit widths of the packed key's fields, high to low: ``row_bits``,
    ``line_bits`` (the line against ``line_lo``), ``pos_bits`` (``rel``),
    ``code_bits`` (the span code)."""

    line_lo: int
    line_bits: int
    pos_bits: int
    code_bits: int
    row_bits: int

    @property
    def width(self) -> int:
        return self.row_bits + self.line_bits + self.pos_bits \
            + self.code_bits

    @property
    def s_rel(self) -> int:
        return self.code_bits

    @property
    def s_line(self) -> int:
        return self.code_bits + self.pos_bits

    @property
    def s_row(self) -> int:
        return self.s_line + self.line_bits

    @property
    def line_ones(self) -> int:
        """The line field's all-ones value, an invalid entry's."""
        return (1 << self.line_bits) - 1


def key_layout(ranges, pos_span: int, n_codes: int, n_rows: int,
               n_entries: int) -> KeyLayout | None:
    """The key of a window of ``n_rows`` rows of ``n_entries`` entries
    each, whose ghosts cover the ``(line_base, count)`` ``ranges``, whose
    real positions lie in ``[win_start, win_start + pos_span)`` in each
    row, and whose span codes are below ``n_codes``; None when it takes
    more than :data:`MAX_KEY_BITS` bits or the sort more than
    :data:`MAX_ENTRIES` entries."""
    lo = min(b for b, _ in ranges)
    hi = max(b + c for b, c in ranges)
    lay = KeyLayout(line_lo=lo, line_bits=(hi - lo).bit_length(),
                    pos_bits=int(pos_span).bit_length(),
                    code_bits=(n_codes - 1).bit_length(),
                    row_bits=(n_rows - 1).bit_length())
    if lay.width > MAX_KEY_BITS or n_rows * n_entries > MAX_ENTRIES:
        return None
    return lay


def check_inputs(n: int, ranges, lay: KeyLayout, win_start, last_pos,
                 spans) -> None:
    """Refuse what neither version takes: ``last_pos`` a ``[R, lines]``
    int32|int64 table with unit stride along its lines that holds the
    covered ranges; ``win_start`` a contiguous ``[R]`` tensor of its dtype;
    ``spans`` a contiguous 1-D int32 table of a value a code, every code
    within the key's code bits;
    all on one device; a key of at most :data:`MAX_KEY_BITS` bits."""
    if last_pos.ndim != 2 or last_pos.stride(1) != 1:
        raise ValueError("last_pos must be [R, lines] with unit stride "
                         "along its lines")
    if last_pos.dtype not in _POS_DTYPES:
        raise ValueError(f"last_pos must be int32 or int64, got "
                         f"{last_pos.dtype}")
    if last_pos.shape[1] < max(b + c for b, c in ranges):
        raise ValueError(f"last_pos has {last_pos.shape[1]} lines; the "
                         f"ranges end at {max(b + c for b, c in ranges)}")
    R = last_pos.shape[0]
    want = {"win_start": (win_start, last_pos.dtype, (R,)),
            "spans": (spans, torch.int32, (spans.shape[0],))}
    for name, (t, dt, shape) in want.items():
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != last_pos.device:
            raise ValueError(f"{name} is on {t.device}, last_pos on "
                             f"{last_pos.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous of shape {shape}, "
                             f"got {tuple(t.shape)}")
    if not 0 < spans.shape[0] <= 1 << lay.code_bits:
        raise ValueError(f"spans has {spans.shape[0]} values; "
                         f"{lay.code_bits} code bits take 1 to "
                         f"{1 << lay.code_bits}")
    if lay.width > MAX_KEY_BITS:
        raise ValueError(f"a {lay.width}-bit key is past {MAX_KEY_BITS}")
    if n < 0 or R * (n + sum(c for _, c in ranges)) > MAX_ENTRIES:
        raise ValueError(f"{R} rows of {n} entries and the ghosts are past "
                         f"{MAX_ENTRIES} entries")


def _check_part(part, R: int, pdt, dev) -> tuple:
    """A ref's block, ``[R, n]`` line int32, pos of the table's dtype, code
    uint8 and valid bool on the table's device, made contiguous (a block
    broadcast along a loop level is a view with a zero stride)."""
    n = part[0].shape[-1]
    for name, t, dt in zip(("line", "pos", "code", "valid"), part,
                           (torch.int32, pdt, torch.uint8, torch.bool)):
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, last_pos on {dev}")
        if tuple(t.shape) != (R, n):
            raise ValueError(f"{name} must have shape {(R, n)}, got "
                             f"{tuple(t.shape)}")
    return tuple(t.contiguous() for t in part)


def window_sort(parts, n: int, ranges, lay: KeyLayout, win_start, last_pos,
                spans):
    """The ghost-merged window of ``parts`` sorted by (line, pos):
    ``(key_s int32, pos_s, span_s int32, valid_s bool)``, each ``[R, N]``
    with ``N = n + ghosts``, as :func:`pluss_torch.ops.reuse.sort_columns`
    gives them on every valid entry.

    ``parts`` yields each ref's ``[R, n_i]`` (line, pos, code, valid)
    block in program order (``n`` entries a row in all); each is dropped
    once packed, so a generator holds one at a time.  ``ranges`` are the
    ghosts' ascending ``(line_base, count)``: their positions are
    ``last_pos[:, line]``, read before the caller rewrites it.
    ``win_start [R]`` is each row's smallest real position; ``spans[code]``
    a code's share span.

    CPU tensors take :func:`window_sort_plain`; CUDA tensors launch the
    kernels on the current stream (each launch inside the profiler range
    ``pluss::window_sort``), counted once a window in
    ``window_sort.launches``."""
    check_inputs(n, ranges, lay, win_start, last_pos, spans)
    if last_pos.device.type == "cpu":
        return window_sort_plain(parts, n, ranges, lay, win_start, last_pos,
                                 spans)
    if last_pos.device.type != "cuda":
        raise ValueError(f"no window-sort kernel for device "
                         f"{last_pos.device}")
    return _launch(parts, n, ranges, lay, win_start, last_pos, spans)


window_sort.launches = 0


def _promise(line, rel, code, valid, lay: KeyLayout, n_codes: int) -> None:
    """Raise unless every valid entry's fields fit their widths and its
    code has a span: the engine's host reckoning of the layout, held on
    every CPU window."""
    field = line.to(torch.int64) - lay.line_lo
    bad = valid & ((field < 0) | (field >= lay.line_ones)
                   | (rel < 1) | (rel >= 1 << lay.pos_bits)
                   | (code.to(torch.int64) >= n_codes))
    if bool(bad.any()):
        i = bad.nonzero()[0].tolist()
        raise AssertionError(
            f"window key layout {lay} does not hold entry {i}: line "
            f"{int(line[tuple(i)])}, rel {int(rel[tuple(i)])}, code "
            f"{int(code[tuple(i)])}")


def window_sort_plain(parts, n: int, ranges, lay: KeyLayout, win_start,
                      last_pos, spans):
    """:func:`window_sort` in plain torch ops: the same key, one
    ``torch.sort`` of it, the same unpacking.  Asserts the layout's
    promise on every real entry (:func:`_promise`)."""
    R = last_pos.shape[0]
    N = n + sum(c for _, c in ranges)
    dev = last_pos.device
    key = torch.empty((R, N), dtype=torch.int64, device=dev)
    top = torch.arange(R, dtype=torch.int64, device=dev)[:, None] \
        << lay.s_row
    ws = win_start.to(torch.int64)[:, None]
    off = 0
    for part in parts:
        line, pos, code, valid = _check_part(part, R, last_pos.dtype, dev)
        del part
        k = line.shape[1]
        rel = pos.to(torch.int64) - ws + 1
        _promise(line, rel, code, valid, lay, spans.shape[0])
        f = ((line.to(torch.int64) - lay.line_lo) << lay.s_line) \
            | (rel << lay.s_rel) | code.to(torch.int64)
        key[:, off:off + k] = torch.where(
            valid, f, lay.line_ones << lay.s_line) | top
        off += k
    if off != n:
        raise ValueError(f"the parts hold {off} entries a row, not {n}")
    for b, c in ranges:
        field = torch.arange(b - lay.line_lo, b - lay.line_lo + c,
                             dtype=torch.int64, device=dev)
        key[:, off:off + c] = (field << lay.s_line)[None] | top
        off += c
    key = torch.sort(key.view(-1)).values.view(R, N)
    field = (key >> lay.s_line) & lay.line_ones
    valid_s = field != lay.line_ones
    line = torch.where(valid_s, field + lay.line_lo, 0)
    rel = (key >> lay.s_rel) & ((1 << lay.pos_bits) - 1)
    code = key & ((1 << lay.code_bits) - 1)
    del key
    pos_s = torch.where(rel == 0, last_pos.gather(1, line),
                        win_start[:, None] + (rel - 1))
    return (torch.where(valid_s, line, LINE_SENTINEL).to(torch.int32),
            torch.where(valid_s, pos_s, -1).to(last_pos.dtype),
            torch.where(valid_s, spans[code], 0), valid_s)


class _Layout(ctypes.Structure):
    """The key's fields, field for field ``Layout`` of the CUDA source."""

    _fields_ = [(name, ctypes.c_longlong) for name in (
        "line_lo", "line_ones", "rel_mask", "code_mask", "s_rel", "s_line",
        "s_row")]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("window_sort")
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    for fn in (lib.pluss_window_pack_i32, lib.pluss_window_pack_i64):
        fn.argtypes = [vp] * 4 + [ll, ll, vp, vp, vp, ll, ll, vp]
    lib.pluss_window_pack_ghosts.argtypes = [ll, ll, ll, vp, vp, ll, ll, vp]
    lib.pluss_window_sort_bytes.argtypes = [
        ll, ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong)]
    lib.pluss_window_sort.argtypes = [
        vp, vp, ll, ctypes.c_int, vp, ctypes.c_ulonglong, vp,
        ctypes.POINTER(ctypes.c_int)]
    for fn in (lib.pluss_window_unpack_i32, lib.pluss_window_unpack_i64):
        fn.argtypes = [vp, ll, ll, vp, vp, ll, vp, vp, vp, vp, vp, vp, vp]
    for fn in (lib.pluss_window_pack_i32, lib.pluss_window_pack_i64,
               lib.pluss_window_pack_ghosts, lib.pluss_window_sort_bytes,
               lib.pluss_window_sort, lib.pluss_window_unpack_i32,
               lib.pluss_window_unpack_i64):
        fn.restype = ctypes.c_int
    return lib


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"window_sort {what} failed: CUDA error {err}")


def _launch(parts, n: int, ranges, lay: KeyLayout, win_start, last_pos,
            spans):
    """Pack each block, sort the keys, unpack them (every launch on the
    current stream, inside a function-scope profiler range
    ``pluss::window_sort``, which ties the kernels to the host ranges
    around the call); count the window once."""
    R = last_pos.shape[0]
    N = n + sum(c for _, c in ranges)
    dev, pdt = last_pos.device, last_pos.dtype
    i64 = pdt == torch.int64
    geom = _Layout(line_lo=lay.line_lo, line_ones=lay.line_ones,
                   rel_mask=(1 << lay.pos_bits) - 1,
                   code_mask=(1 << lay.code_bits) - 1, s_rel=lay.s_rel,
                   s_line=lay.s_line, s_row=lay.s_row)
    g = ctypes.addressof(geom)
    lib = _library()
    rng = lambda: torch._C._profiler._RecordFunctionFast("pluss::window_sort")
    with build.launch_context(dev):
        stream = torch.cuda.current_stream().cuda_stream
        key = torch.empty((R, N), dtype=torch.int64, device=dev)
        pack = lib.pluss_window_pack_i64 if i64 else lib.pluss_window_pack_i32
        off = 0
        for part in parts:
            part = _check_part(part, R, pdt, dev)
            k = part[0].shape[1]
            with rng():
                err = pack(part[0].data_ptr(), part[1].data_ptr(),
                           part[2].data_ptr(), part[3].data_ptr(), R, k,
                           win_start.data_ptr(), g, key.data_ptr(), N, off,
                           stream)
            del part
            _raise_on(err, "pack")
            off += k
        if off != n:
            raise ValueError(f"the parts hold {off} entries a row, not {n}")
        for b, c in ranges:
            with rng():
                err = lib.pluss_window_pack_ghosts(
                    R, c, b - lay.line_lo, g, key.data_ptr(), N, off, stream)
            _raise_on(err, "ghost pack")
            off += c
        need = ctypes.c_ulonglong()
        _raise_on(lib.pluss_window_sort_bytes(R * N, lay.width,
                                              ctypes.byref(need)),
                  "sort size query")
        alt = torch.empty_like(key)
        temp = torch.empty(max(1, need.value), dtype=torch.uint8, device=dev)
        sel = ctypes.c_int()
        with rng():
            err = lib.pluss_window_sort(key.data_ptr(), alt.data_ptr(),
                                        R * N, lay.width, temp.data_ptr(),
                                        need.value, stream, ctypes.byref(sel))
        _raise_on(err, "sort")
        if sel.value:
            key = alt
        del alt, temp
        key_s = torch.empty((R, N), dtype=torch.int32, device=dev)
        pos_s = torch.empty((R, N), dtype=pdt, device=dev)
        span_s = torch.empty((R, N), dtype=torch.int32, device=dev)
        valid_s = torch.empty((R, N), dtype=torch.bool, device=dev)
        unpack = lib.pluss_window_unpack_i64 if i64 \
            else lib.pluss_window_unpack_i32
        with rng():
            err = unpack(key.data_ptr(), R, N, win_start.data_ptr(),
                         last_pos.data_ptr(), last_pos.stride(0),
                         spans.data_ptr(), g, key_s.data_ptr(),
                         pos_s.data_ptr(), span_s.data_ptr(),
                         valid_s.data_ptr(), stream)
        _raise_on(err, "unpack")
    build.count_launch(window_sort)
    return key_s, pos_s, span_s, valid_s
