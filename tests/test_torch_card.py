"""The port's CUDA kernels and trace replay on the card, against their
plain versions and the CPU.

Every test here carries the ``cuda`` marker and takes the ``cuda_device``
fixture, which skips it with a reason where there is no card; whether
there is one is decided when the test runs, never at import.  The file
imports neither jax nor ``pluss``, so it runs on a machine with the card
and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py

Inputs come from numpy seeds; everything is integer, so every comparison
is exact.
"""

import numpy as np
import pytest
import torch

from pluss_torch import trace
from pluss_torch.config import NBINS
from pluss_torch.ops import decode as decode_mod
from pluss_torch.ops import wirecodec
from pluss_torch.ops.decode import decode_d24v
from pluss_torch.ops.event_hist import (event_histogram,
                                        event_histogram_plain,
                                        masked_histogram,
                                        masked_histogram_plain)
from pluss_torch.ops.reuse import sort_stream
from pluss_torch.ops.window_sort import window_sort

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The CUDA card, or a skip when there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def wires():
    """Encoder outputs of raw, delta, ragged and reset-heavy streams, and
    a random wire no encoder writes (widths 0-7, sums that wrap)."""
    rng = np.random.default_rng(0)
    B = wirecodec.BLOCK
    streams = [
        rng.integers(0, 1 << 24, 5 * B + 3),
        np.arange(3 * B) + (1 << 22),
        ((1 << 24) - 1 - 3 * np.arange(2 * B)),
        np.concatenate([rng.integers(0, 1 << 23, B) if i % 2 else
                        np.arange(B) + (1 << 20) for i in range(8)]),
    ]
    out = [wirecodec.encode_d24v(s.astype(np.int32)) for s in streams]
    k = rng.integers(0, 8, 64)
    wm = (k | np.where(rng.random(64) < 0.3, wirecodec.RAW_MODE, 0)) \
        .astype(np.uint8)
    payload = rng.integers(0, 256, wirecodec.pad_len(
        wirecodec.used_bytes(wm)), dtype=np.uint8)
    return out + [(payload, wm)]


@pytest.mark.parametrize("i", range(5))
def test_decode_kernel_matches_plain(cuda_device, i):
    payload, wm = (torch.from_numpy(a) for a in wires()[i])
    before = decode_d24v.launches
    got = decode_d24v(payload.to(cuda_device), wm.to(cuda_device))
    assert decode_d24v.launches == before + 1
    assert torch.equal(got.cpu(), wirecodec.decode_d24v_plain(payload, wm))


def random_events(seed, n, wide):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, 52 if wide else 31, n)
    reuse = (np.int64(1) << e) + rng.integers(-3, 1000, n)
    reuse = np.where(rng.random(n) < 0.02, -reuse, reuse)
    is_evt = rng.random(n) < 0.8
    return [torch.from_numpy(a) for a in (
        reuse.astype(np.int64 if wide else np.int32), is_evt,
        rng.random(n) < 0.1, ~is_evt & (rng.random(n) < 0.5))]


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("include_cold", [True, False])
def test_masked_hist_kernel_matches_plain(cuda_device, wide, include_cold):
    args = random_events(1, 300_001, wide)
    before = masked_histogram.launches
    got = masked_histogram(*(a.to(cuda_device) for a in args),
                           include_cold=include_cold)
    assert masked_histogram.launches == before + 1
    assert torch.equal(got.cpu(), masked_histogram_plain(
        *args, include_cold=include_cold))


def test_masked_hist_refuses_an_empty_stream(cuda_device):
    args = [a[:0].to(cuda_device) for a in random_events(1, 8, False)]
    before = masked_histogram.launches
    with pytest.raises(ValueError, match="empty event stream"):
        masked_histogram(*args)
    assert masked_histogram.launches == before


@pytest.mark.parametrize("pdt", [torch.int32, torch.int64])
def test_event_hist_kernel_matches_plain(cuda_device, pdt):
    rng = np.random.default_rng(2)
    T, n, n_lines, ws = 3, 20_000, 2_000, 100_000
    line = rng.integers(0, n_lines, (T, n))
    pos = ws + np.stack([rng.permutation(3 * n)[:n] for _ in range(T)])
    gpos = np.where(rng.random((T, n_lines)) < 0.3, -1,
                    rng.integers(0, ws, (T, n_lines)))
    line = np.concatenate([line, np.tile(np.arange(n_lines), (T, 1))], 1)
    pos = np.concatenate([pos, gpos], 1)
    span = np.where(rng.random(line.shape) < 0.3, 5000, 0)
    valid = rng.random(line.shape) < 0.97
    sorted_ = sort_stream(torch.from_numpy(line.astype(np.int32)),
                          torch.from_numpy(pos).to(pdt),
                          torch.from_numpy(span.astype(np.int32)),
                          torch.from_numpy(valid))
    args = (*sorted_, torch.full((T,), ws, dtype=pdt))
    got = event_histogram(*(a.to(cuda_device) for a in args))
    assert torch.equal(got.cpu(), event_histogram_plain(*args))


def window_blocks(seed, pdt, ranges):
    """A random ghost-merged window on the CPU: three ``[3, n]`` ref
    blocks (line, pos, code, valid) at distinct positions from each row's
    ``win_start`` over the covered ``ranges`` (a tenth invalid, with any
    line and position), and rows 1-3 of a six-row carried table with a
    dump column (a third of the covered lines -1, the rest earlier
    positions).  Returns ``(parts, n, win_start, last_pos, pos_span)``."""
    rng = np.random.default_rng(seed)
    lines = np.concatenate([np.arange(b, b + c) for b, c in ranges])
    T, L, n = 3, 3000, 30_000
    base = 10 * n + (5 << 31 if pdt == torch.int64 else 0)
    ws = base + rng.integers(0, 100, T)
    pos = np.stack([ws[t] + rng.permutation(2 * n)[:n] for t in range(T)])
    valid = rng.random((T, n)) < 0.9
    line = np.where(valid, rng.choice(lines, (T, n)),
                    rng.integers(0, 1 << 24, (T, n)))
    pos = np.where(valid, pos, rng.integers(-3, base, (T, n)))
    code = rng.integers(0, 3, (T, n))
    table = np.full((6, L + 1), -1, np.int64)
    table[:, lines] = np.where(rng.random((6, len(lines))) < 1 / 3, -1,
                               rng.integers(0, base, (6, len(lines))))
    cut = [0, n // 5, n // 2, n]
    parts = [(torch.from_numpy(line[:, a:b].astype(np.int32)),
              torch.from_numpy(pos[:, a:b]).to(pdt),
              torch.from_numpy(code[:, a:b].astype(np.uint8)),
              torch.from_numpy(valid[:, a:b].copy()))
             for a, b in zip(cut, cut[1:])]
    return (parts, n, torch.from_numpy(ws).to(pdt),
            torch.from_numpy(table).to(pdt)[1:4, :L], 2 * n)


@pytest.mark.parametrize("pdt", [torch.int32, torch.int64])
@pytest.mark.parametrize("ranges", [((0, 2500),),
                                    ((40, 1000), (1800, 1100))])
def test_window_sort_kernels_match_plain(cuda_device, pdt, ranges):
    from pluss_torch.ops.window_sort import (key_layout, window_sort,
                                             window_sort_plain)

    parts, n, ws, last_pos, span = window_blocks(5, pdt, ranges)
    n_lines = sum(c for _, c in ranges)
    lay = key_layout(ranges, span, 3, 3, n + n_lines)
    spans = torch.tensor([0, 9, 4000], dtype=torch.int32)
    want = window_sort_plain(iter(parts), n, ranges, lay, ws, last_pos,
                             spans)
    before = window_sort.launches
    on = lambda t: t.to(cuda_device)
    got = window_sort(iter([tuple(map(on, p)) for p in parts]), n, ranges,
                      lay, on(ws), on(last_pos), on(spans))
    assert window_sort.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    assert not want[3].all() and want[3].any()


@pytest.mark.parametrize("model,n,sampled", [("cholesky", 48, False),
                                             ("gemm", 64, True)])
def test_sort_windows_pack_on_the_card(cuda_device, model, n, sampled):
    """Every sort window of a cholesky run and a sampled GEMM runs the
    window sort's kernels once, and the results equal the CPU's."""
    from pluss_torch import engine, sampling
    from pluss_torch.models import REGISTRY

    spec = REGISTRY[model](n)
    run = (lambda dev: sampling.sampled_run(
        spec, rate=0.5, window_accesses=1 << 12, seed=3, device=dev)) \
        if sampled else (lambda dev: engine.run(spec, device=dev,
                                                window_accesses=1 << 12))
    window_sort.launches = event_histogram.launches = 0
    got = run(cuda_device)
    assert window_sort.launches >= event_histogram.launches > 0
    want = run("cpu")
    np.testing.assert_array_equal(got.noshare_dense, want.noshare_dense)
    assert got.share_raw == want.share_raw


@pytest.mark.parametrize("wire", ["d24v", "pack"])
def test_replay_on_the_card_matches_the_cpu(tmp_path, cuda_device, wire):
    rng = np.random.default_rng(3)
    n = 5 * 4096 + 99
    lines = np.where(rng.random(n) < 0.5, rng.integers(0, 1 << 8, n),
                     rng.integers(0, 1 << 13, n))
    lines = np.where((np.arange(n) // 700) % 3 == 2,
                     (1 << 30) + (np.arange(n) // 8) % 3000, lines)
    path = str(tmp_path / "t.bin")
    (lines.astype(np.uint64) << np.uint64(6)).astype("<u8").tofile(path)
    kw = dict(window=1024, batch_windows=4, wire=wire,
              initial_capacity=1 << 8)
    card = trace.replay_file(path, device=cuda_device, **kw)
    cpu = trace.replay_file(path, device="cpu", **kw)
    np.testing.assert_array_equal(card.hist, cpu.hist)
    assert (card.total_count, card.n_lines) == (cpu.total_count,
                                                cpu.n_lines)


def _two_region_trace(path, n, seed=4):
    rng = np.random.default_rng(seed)
    lines = np.where(rng.random(n) < 0.5, rng.integers(0, 1 << 8, n),
                     rng.integers(0, 1 << 13, n))
    lines = np.where((np.arange(n) // 5000) % 3 == 2,
                     (1 << 30) + (np.arange(n) // 8) % 4000, lines)
    (lines.astype(np.uint64) << np.uint64(6)).astype("<u8").tofile(path)
    return str(path)


@pytest.mark.parametrize("wire", ["d24v", "pack"])
def test_staging_on_the_card_matches_plain_staging(tmp_path, cuda_device,
                                                   wire):
    """A pack staged on the card (d24v records through kernel 3, one
    launch per record) holds the bytes the CPU staging (the plain decode)
    makes; the card's staged replay (kernel 2 once per batch) and its
    legacy scan (once per window) equal the streamed replay."""
    path = _two_region_trace(tmp_path / "t.bin", 7 * 4096 + 123)
    geo = dict(window=1024, batch_windows=4)
    packed = str(tmp_path / "t.pack")
    meta = trace.pack_file(path, packed, wire=wire, feed_workers=2, **geo)
    decode_d24v.launches = 0
    card, n_run, _ = trace.stage_resident(packed, meta, device=cuda_device,
                                          **geo)
    assert decode_d24v.launches == (8 if wire == "d24v" else 0)
    cpu, _, _ = trace.stage_resident(packed, meta, device="cpu", **geo)
    assert card.is_cuda and torch.equal(card.cpu(), cpu)
    want = trace.replay_file(path, device="cpu", **geo)
    for clock0, seg, launches in ((0, None, 8), (3, None, 8),
                                  (0, False, 32)):
        masked_histogram.launches = 0
        got = trace.replay_staged(card, meta["n_lines"], n_run, 1024,
                                  clock0=clock0, segmented=seg)
        assert masked_histogram.launches == launches
        np.testing.assert_array_equal(got.hist, want.hist)
        assert (got.total_count, got.n_lines) == (want.total_count,
                                                  want.n_lines)


def test_stage_through_on_the_card(tmp_path, cuda_device):
    """Cold replay_file(resident_cache=True) on the card publishes the
    bytes a direct staging makes; the warm hit launches no decode and
    equals the stream."""
    from pluss_torch import residency

    path = _two_region_trace(tmp_path / "t.bin", 6 * 4096 + 7)
    geo = dict(window=1024, batch_windows=4)
    residency.reset()
    try:
        cold = trace.replay_file(path, resident_cache=True, wire="d24v",
                                 device=cuda_device, **geo)
        assert cold.timing["resident"] == "stage_through"
        decode_d24v.launches = 0
        warm = trace.replay_file(path, resident_cache=True,
                                 device=cuda_device, **geo)
        assert warm.timing["resident"] == "hit"
        assert decode_d24v.launches == 0 and warm.timing["h2d_bytes"] == 0
        for rep in (cold, warm):
            np.testing.assert_array_equal(
                rep.hist, trace.replay_file(path, device="cpu", **geo).hist)
        key = trace._residency_key(path, cls=64, window=1024, bw=4,
                                   precompacted=False, device=cuda_device)
        ent = residency.store().lookup_pin(key)
        residency.store().unpin(key)
        packed = str(tmp_path / "t.pack")
        meta = trace.pack_file(path, packed, wire="d24v", **geo)
        direct, _, _ = trace.stage_resident(packed, meta, device=cuda_device,
                                            **geo)
        assert torch.equal(ent.value, direct)
    finally:
        residency.reset()


# ---------------------------------------------------------------- kernel 2
# edge cases of the redesigned masked histogram: runs of 16 with a scalar
# head and tail, 16-byte vector loads where a view allows them,
# privatised per-thread bins


def _masked_matches(dev, reuse, is_evt, share, cold):
    """Kernel on ``dev`` == plain version on the CPU, both ways of
    ``include_cold``."""
    for include_cold in (True, False):
        got = masked_histogram(reuse.to(dev), is_evt.to(dev), share.to(dev),
                               cold.to(dev), include_cold=include_cold)
        want = masked_histogram_plain(reuse, is_evt, share, cold,
                                      include_cold=include_cold)
        assert torch.equal(got.cpu(), want), (include_cold, got, want)


@pytest.mark.parametrize("n,wide", [
    *((n, w) for n in (1, 15, 16, 17, 4095) for w in (False, True)),
    ((1 << 24) + 7, False)])
def test_masked_hist_ragged_lengths(cuda_device, n, wide):
    _masked_matches(cuda_device, *random_events(10 + n % 97, n, wide))


@pytest.mark.parametrize("offsets", [
    (1, 1, 1, 1), (5, 5, 5, 1), (15, 15, 15, 3), (0, 0, 0, 1),
    (1, 2, 3, 2), (7, 0, 13, 3), (0, 9, 0, 0), (3, 3, 11, 1)])
@pytest.mark.parametrize("wide", [False, True])
def test_masked_hist_misaligned_views(cuda_device, offsets, wide):
    """Contiguous views that start 1-15 bytes into a mask and one or more
    elements (4-24 bytes) into the reuse, co-aligned or not."""
    oe, os_, oc, orr = offsets
    n = 10_007
    reuse, is_evt, share, cold = random_events(4, n + 16, wide)
    views = (reuse.to(cuda_device)[orr:orr + n],
             is_evt.to(cuda_device)[oe:oe + n],
             share.to(cuda_device)[os_:os_ + n],
             cold.to(cuda_device)[oc:oc + n])
    for include_cold in (True, False):
        got = masked_histogram(*views, include_cold=include_cold)
        want = masked_histogram_plain(*(v.cpu() for v in views),
                                      include_cold=include_cold)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("wide", [False, True])
def test_masked_hist_one_bin(cuda_device, wide):
    """Every entry in one bin: per-thread and per-block counts pass 2^16."""
    n = (1 << 22) + 3
    dt = torch.int64 if wide else torch.int32
    reuse = torch.full((n,), 5, dtype=dt)
    ones = torch.ones(n, dtype=torch.bool)
    zeros = torch.zeros(n, dtype=torch.bool)
    _masked_matches(cuda_device, reuse, ones, zeros, zeros)
    _masked_matches(cuda_device, reuse, zeros, zeros, ones)   # all cold
    got = masked_histogram(reuse.to(cuda_device), ones.to(cuda_device),
                           zeros.to(cuda_device), zeros.to(cuda_device))
    assert int(got[3]) == n


def test_masked_hist_int64_bins_past_nbins(cuda_device):
    """int64 reuses whose bins reach NBINS and beyond weigh nothing."""
    rng = np.random.default_rng(5)
    n = 70_001
    e = rng.integers(40, 63, n)
    reuse = torch.from_numpy((np.int64(1) << e) + rng.integers(0, 9, n))
    is_evt = torch.from_numpy(rng.random(n) < 0.9)
    share = torch.from_numpy(rng.random(n) < 0.1)
    cold = torch.from_numpy(rng.random(n) < 0.5) & ~is_evt
    _masked_matches(cuda_device, reuse, is_evt, share, cold)
    got = masked_histogram(reuse.to(cuda_device), is_evt.to(cuda_device),
                           share.to(cuda_device), cold.to(cuda_device))
    assert got.shape == (NBINS,)
    assert int(got.sum()) < int((is_evt & ~share | cold).sum())


# ---------------------------------------------------------------- kernel 3
# edge cases of the single-pass decode: tiles of TILE_BLOCKS wire blocks,
# decoupled look-back over the tiles, one write


def _random_wire(rng, nb, raw_share=0.3, widths=(0, 8)):
    k = rng.integers(widths[0], widths[1], nb)
    wm = (k | np.where(rng.random(nb) < raw_share, wirecodec.RAW_MODE, 0)) \
        .astype(np.uint8)
    payload = rng.integers(0, 256, wirecodec.pad_len(
        wirecodec.used_bytes(wm)), dtype=np.uint8)
    return payload, wm


def _decode_matches(dev, payload, wm):
    p = torch.as_tensor(payload).to(dev)
    w = torch.as_tensor(wm).to(dev)
    got = decode_d24v(p, w)
    assert torch.equal(got, wirecodec.decode_d24v_plain(p, w))
    return got


T = decode_mod.TILE_BLOCKS


@pytest.mark.parametrize("nb", [1, T - 1, T, T + 1, 16_384 + 5])
def test_decode_tile_edges(cuda_device, nb):
    rng = np.random.default_rng(nb)
    _decode_matches(cuda_device, *_random_wire(rng, nb))
    # an encoder stream: short steps (delta blocks) and noise (raw blocks)
    n = nb * wirecodec.BLOCK - 11
    ids = np.cumsum(rng.integers(0, 3, n)) % (1 << 24)
    noise = (np.arange(n) // wirecodec.BLOCK) % 3 == 1
    ids = np.where(noise, rng.integers(0, 1 << 24, n), ids).astype(np.int32)
    got = _decode_matches(cuda_device, *wirecodec.encode_d24v(ids))
    assert torch.equal(got[:n].cpu(), torch.from_numpy(ids))


def test_decode_all_raw(cuda_device):
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 1 << 24, 77 * wirecodec.BLOCK).astype(np.int32)
    payload, wm = wirecodec.encode_d24v(ids)
    assert (wm & wirecodec.RAW_MODE).all()
    got = _decode_matches(cuda_device, payload, wm)
    assert torch.equal(got.cpu(), torch.from_numpy(ids))


def test_decode_one_delta_chain_that_wraps(cuda_device):
    """No raw block at all: one delta chain through every tile boundary,
    7-nibble zigzag deltas whose sums wrap 2^32 many times."""
    rng = np.random.default_rng(7)
    payload, wm = _random_wire(rng, 40 * T + 3, raw_share=0.0, widths=(7, 8))
    got = _decode_matches(cuda_device, payload, wm)
    sums = got.view(-1, wirecodec.BLOCK)[:, -1].cpu().numpy()
    assert len(set(sums.tolist())) > 1


def test_decode_zero_width_delta_blocks(cuda_device):
    """Zero-width delta blocks repeat the chain's last id; zero-width raw
    blocks are all 0."""
    rng = np.random.default_rng(8)
    nb = 5 * T + 2
    wm = np.zeros(nb, np.uint8)
    wm[::7] = 3
    wm[3::11] = wirecodec.RAW_MODE | 4
    wm[5::13] = wirecodec.RAW_MODE
    payload = rng.integers(0, 256, wirecodec.pad_len(
        wirecodec.used_bytes(wm)), dtype=np.uint8)
    _decode_matches(cuda_device, payload, wm)


@pytest.mark.parametrize("seed", range(3))
def test_decode_random_wire_widths(cuda_device, seed):
    """``chip_smoke.random_wire``'s shape: widths 0-7, raw or delta."""
    rng = np.random.default_rng(100 + seed)
    _decode_matches(cuda_device, *_random_wire(rng, 3 * T * 37 + seed))


def test_decode_twice_on_one_scratch(cuda_device):
    """Two decodes in a row on one scratch, the first over a scratch full
    of stale flags: the entry point's memset resets the look-back state."""
    rng = np.random.default_rng(9)
    nb = 20 * T + 1
    fn = decode_mod._library().pluss_d24v_decode
    scratch = torch.full((decode_mod.scratch_bytes(nb),), 0xFF,
                         dtype=torch.uint8, device=cuda_device)
    for _ in range(2):
        payload, wm = (torch.from_numpy(a).to(cuda_device)
                       for a in _random_wire(rng, nb))
        out = torch.empty(nb * wirecodec.BLOCK, dtype=torch.int32,
                          device=cuda_device)
        err = fn(payload.data_ptr(), payload.numel() // 4, wm.data_ptr(), nb,
                 out.data_ptr(), scratch.data_ptr(), scratch.numel(),
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0
        assert torch.equal(out, wirecodec.decode_d24v_plain(payload, wm))


def test_decode_payload_not_16_byte_aligned(cuda_device):
    """A payload view 4 bytes into its buffer takes the scalar staging."""
    rng = np.random.default_rng(11)
    payload, wm = _random_wire(rng, 3 * T + 5)
    buf = torch.zeros(payload.shape[0] + 4, dtype=torch.uint8)
    buf[4:] = torch.from_numpy(payload)
    p = buf.to(cuda_device)[4:]
    assert p.data_ptr() % 16
    w = torch.from_numpy(wm).to(cuda_device)
    assert torch.equal(decode_d24v(p, w), wirecodec.decode_d24v_plain(p, w))


def test_decode_refuses_short_scratch(cuda_device):
    rng = np.random.default_rng(12)
    nb = 3 * T
    payload, wm = (torch.from_numpy(a).to(cuda_device)
                   for a in _random_wire(rng, nb))
    fn = decode_mod._library().pluss_d24v_decode
    scratch = torch.zeros(decode_mod.scratch_bytes(nb) - 16,
                          dtype=torch.uint8, device=cuda_device)
    out = torch.empty(nb * wirecodec.BLOCK, dtype=torch.int32,
                      device=cuda_device)
    assert fn(payload.data_ptr(), payload.numel() // 4, wm.data_ptr(), nb,
              out.data_ptr(), scratch.data_ptr(), scratch.numel(),
              torch.cuda.current_stream().cuda_stream) != 0


@pytest.mark.parametrize("model,n,win,asg", [
    ("cholesky", 48, 1, False),       # quad refs in size buckets
    ("trmm", 40, 1, True),            # varying starts, custom assignment
    ("syrk_tri", 40, 1, False),       # closed-form tables, no sort
    ("durbin", 40, 64, False),        # negative addresses
])
def test_bounded_nests_on_the_card_match_the_cpu(cuda_device, model, n, win,
                                                 asg):
    from pluss_torch import engine
    from pluss_torch.models import REGISTRY
    from pluss_torch.sched import ChunkSchedule

    spec = REGISTRY[model](n)
    assignment = None
    if asg:   # thread (c+1)%T takes chunk c
        assignment = tuple(tuple((c + 1) % 4 for c in range(ChunkSchedule(
            4, nest.trip, nest.start, nest.step).n_chunks))
            for nest in spec.nests)
    kw = dict(window_accesses=win, assignment=assignment)
    event_histogram.launches = 0
    got = engine.run(spec, device=cuda_device, **kw)
    want = engine.run(spec, device="cpu", **kw)
    assert got.max_iteration_count == want.max_iteration_count
    np.testing.assert_array_equal(got.noshare_dense, want.noshare_dense)
    assert got.share_raw == want.share_raw
    pl = engine.plan(spec, assignment=assignment, window_accesses=win)
    assert event_histogram.launches == sum(
        np_.n_windows for np_ in pl.nests if np_.refs)


def sort_launches(pl, thread_batches: int = 1) -> int:
    """Kernel-1 launches of a plan: one per window that sorts something
    (every non-ultra window with refs; an ultra window only for arrays
    left without a template or overlay), per thread batch."""
    n = 0
    for np_ in pl.nests:
        ultra = np_.ultra_windows()
        n += int((~ultra).sum()) * bool(np_.refs) \
            + int(ultra.sum()) * bool(np_.var_refs_novl)
    return n * thread_batches


@pytest.mark.parametrize("model,n,cls", [("syrk", 32, 64), ("syrk", 48, 8),
                                         ("syr2k", 32, 64)])
def test_overlays_on_the_card_match_the_cpu(cuda_device, model, n, cls):
    from pluss_torch import engine
    from pluss_torch.config import SamplerConfig
    from pluss_torch.models import REGISTRY

    spec, cfg = REGISTRY[model](n), SamplerConfig(cls=cls)
    pl = engine.plan(spec, cfg, window_accesses=1)
    assert pl.nests[0].overlays
    event_histogram.launches = 0
    got = engine._execute(pl, cuda_device)
    assert event_histogram.launches == sort_launches(pl)
    want = engine._execute(pl, torch.device("cpu"))
    np.testing.assert_array_equal(got.noshare_dense, want.noshare_dense)
    assert got.share_raw == want.share_raw
    off = engine._execute(engine.plan(spec, cfg, window_accesses=1,
                                      build_overlays=False), cuda_device)
    np.testing.assert_array_equal(off.noshare_dense, want.noshare_dense)
    assert off.share_raw == want.share_raw


#: tests/test_torch_overlay.py's overlay grid: (n, threads, chunk, line size)
OVERLAY_GRID = [(16, 4, 4, 8), (24, 3, 4, 8), (32, 2, 8, 16), (48, 4, 2, 8),
                (64, 8, 2, 64), (40, 5, 4, 8)]


def overlay_windows(pl, thread_batches: int = 1) -> int:
    """Overlay-kernel launches of a plan: one per overlaid array and ultra
    window, per thread batch."""
    return thread_batches * sum(len(np_.overlays) * int(
        np_.ultra_windows().sum()) for np_ in pl.nests)


def compared_overlay_run(monkeypatch, run):
    """``run()`` with every overlay window taken by the kernel and by the
    plain version on a copy of its inputs, held element for element: the
    histogram, both ``plus`` and both ``minus`` tensors, and the rewritten
    carried table.  Returns the run's result and a tally of the windows
    and of what their carried states held (cold lines, carried lines, and
    head-broken substitutions of carried lines)."""
    from pluss_torch import engine, overlay
    from pluss_torch.ops.overlay_window import overlay_window

    seen = {"windows": 0, "cold": 0, "carried": 0, "broken": 0}

    def both(dov, cfg, w, tids, nb, last_pos):
        ov = dov.ov
        mine = last_pos[:, ov.line_base:ov.line_base + ov.n_lines]
        seen["cold"] += int((mine < 0).sum())
        seen["carried"] += int((mine >= 0).sum())
        lp = last_pos.clone()
        want = overlay.device_window_plain(dov, cfg, w, tids, nb, lp)
        before = overlay_window.launches
        got = overlay.device_window(dov, cfg, w, tids, nb, last_pos)
        assert overlay_window.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0])
        for pair, want_pair in zip(got[1:], want[1:]):
            for x, y in zip(pair, want_pair):
                assert x.dtype == y.dtype and x.shape == y.shape
                assert torch.equal(x, y)
        assert torch.equal(last_pos, lp)
        na = ov.SL * ov.SL * ov.s_ref.trips[-1]
        seen["broken"] += int((want[2][0][:, na:] != 0).sum())
        seen["windows"] += 1
        return got

    monkeypatch.setattr(engine, "device_window", both)
    res = run()
    monkeypatch.undo()
    return res, seen


def same_run(got, want) -> None:
    assert got.max_iteration_count == want.max_iteration_count
    np.testing.assert_array_equal(got.noshare_dense, want.noshare_dense)
    assert got.share_raw == want.share_raw


@pytest.mark.parametrize("wa", [1, None])
@pytest.mark.parametrize("pdt", [np.int32, np.int64])
@pytest.mark.parametrize("n,T,CS,cls", OVERLAY_GRID)
def test_overlay_kernel_matches_plain_on_the_grid(cuda_device, monkeypatch,
                                                  n, T, CS, cls, pdt, wa):
    """Single-round windows (``wa`` 1), so every window after the first
    reads the carried state the earlier ones left, and the default
    windows, of 1 to 6 rounds (W) each."""
    import dataclasses

    from pluss_torch import engine
    from pluss_torch.config import SamplerConfig
    from pluss_torch.models import REGISTRY

    cfg = SamplerConfig(thread_num=T, chunk_size=CS, cls=cls)
    pl = dataclasses.replace(
        engine.plan(REGISTRY["syrk"](n), cfg, window_accesses=wa),
        pos_dtype=np.dtype(pdt))
    if wa is None:
        assert max(ov.W for ov in pl.nests[0].overlays) > 1 or n == 16
    got, seen = compared_overlay_run(
        monkeypatch, lambda: engine._execute(pl, cuda_device))
    assert seen["windows"] == overlay_windows(pl) > 0 and seen["cold"] > 0
    if seen["windows"] > 1:
        assert seen["carried"] > 0 and seen["broken"] > 0
    same_run(got, engine._execute(pl, torch.device("cpu")))


@pytest.mark.parametrize("model,n,kw,tb", [
    ("syrk", 48, {"cls": 8}, 1),
    ("syrk", 64, {"chunk_size": 2}, 2),
    ("syr2k", 32, {}, None),
    ("syr2k", 32, {"cls": 8}, 2),
])
def test_overlay_kernel_matches_plain_on_row_slices_and_syr2k(
        cuda_device, monkeypatch, model, n, kw, tb):
    """Rows of 1 or 2 threads (``run_sliced``), and syr2k's two overlays."""
    from pluss_torch import engine
    from pluss_torch.config import SamplerConfig
    from pluss_torch.models import REGISTRY

    spec, cfg = REGISTRY[model](n), SamplerConfig(**kw)
    pl = engine.plan(spec, cfg, window_accesses=1)
    got, seen = compared_overlay_run(monkeypatch, lambda: engine.run_sliced(
        spec, cfg, device=cuda_device, window_accesses=1, thread_batch=tb))
    batches = 1 if tb is None else -(-cfg.thread_num // tb)
    assert seen["windows"] == overlay_windows(pl, batches)
    assert seen["carried"] > 0 and seen["broken"] > 0
    same_run(got, engine.run(spec, cfg, device="cpu", window_accesses=1))


#: windows of several rounds (W > 1), several windows a run, so both the
#: rounds inside a launch and the state carried between launches are
#: read: (model, n, config, window accesses, thread batch)
MULTI_ROUND = [
    ("syrk", 48, {"thread_num": 4, "chunk_size": 2, "cls": 8}, 1 << 15,
     None),
    ("syrk", 64, {"thread_num": 2, "chunk_size": 2, "cls": 8}, 1 << 16,
     None),
    ("syrk", 64, {"thread_num": 2, "chunk_size": 2, "cls": 8}, 1 << 17,
     None),
    ("syrk", 64, {"thread_num": 2, "chunk_size": 2, "cls": 8}, 1 << 18,
     1),
    ("syrk", 96, {}, 1 << 18, 2),
    ("syrk", 256, {}, None, None),
    ("syr2k", 96, {}, 1 << 18, None),
    ("syr2k", 64, {"cls": 8}, 1 << 17, 2),
]


@pytest.mark.parametrize("model,n,kw,wa,tb,pdt", [
    (*case, pdt) for case in MULTI_ROUND
    # a sliced run plans its own positions; a whole plan takes either
    for pdt in ((np.int32, np.int64) if case[-1] is None else (np.int32,))])
def test_overlay_kernel_matches_plain_on_multi_round_windows(
        cuda_device, monkeypatch, model, n, kw, wa, tb, pdt):
    import dataclasses

    from pluss_torch import engine
    from pluss_torch.config import SamplerConfig
    from pluss_torch.models import REGISTRY

    spec, cfg = REGISTRY[model](n), SamplerConfig(**kw)
    pl = dataclasses.replace(engine.plan(spec, cfg, window_accesses=wa),
                             pos_dtype=np.dtype(pdt))
    assert min(ov.W for np_ in pl.nests for ov in np_.overlays) > 1
    assert overlay_windows(pl) > len(pl.nests[0].overlays)
    if tb is None:
        got, seen = compared_overlay_run(
            monkeypatch, lambda: engine._execute(pl, cuda_device))
        batches = 1
    else:
        got, seen = compared_overlay_run(
            monkeypatch, lambda: engine.run_sliced(
                spec, cfg, device=cuda_device, window_accesses=wa,
                thread_batch=tb))
        batches = -(-cfg.thread_num // tb)
    assert seen["windows"] == overlay_windows(pl, batches)
    assert seen["cold"] > 0 and seen["carried"] > 0 and seen["broken"] > 0
    same_run(got, engine._execute(pl, torch.device("cpu")))


def two_nest_spec(n: int):
    """tests/test_torch_overlay.py's two-nest carry, in the port's own
    types: two nests over ``A``, the second re-touching the lines the
    first left, so its windows read carried positions through the nest
    base ``nb``."""
    from pluss_torch.spec import Loop, LoopNestSpec, Ref, share_span_formula

    span = share_span_formula(n)

    def a_nest():
        inner = Loop(trip=n, body=(
            Ref("A0", "A", addr_terms=((0, n), (2, 1))),
            Ref("A1", "A", addr_terms=((1, n), (2, 1)), share_span=span),
        ))
        return Loop(trip=n, body=(Loop(trip=n, body=(inner,)),))

    return LoopNestSpec(name="twice", arrays=(("A", n * n),),
                        nests=(a_nest(), a_nest()))


@pytest.mark.parametrize("n,kw,wa", [
    (16, {"cls": 8}, None),
    (32, {"cls": 8}, 1),
    (32, {"thread_num": 2, "chunk_size": 2, "cls": 8}, 1 << 14),
    (48, {"thread_num": 2, "chunk_size": 2, "cls": 8}, 1 << 14),
    (64, {"cls": 8}, 1 << 16),
    (32, {"thread_num": 2, "chunk_size": 2, "cls": 8}, None),
])
def test_overlay_kernel_matches_plain_on_the_two_nest_carry(
        cuda_device, monkeypatch, n, kw, wa):
    from pluss_torch import engine
    from pluss_torch.config import SamplerConfig

    cfg = SamplerConfig(**kw)
    pl = engine.plan(two_nest_spec(n), cfg, window_accesses=wa)
    assert [len(np_.overlays) for np_ in pl.nests] == [1, 1]
    assert (np.asarray(pl.nest_base[1]) > 0).all()
    got, seen = compared_overlay_run(
        monkeypatch, lambda: engine._execute(pl, cuda_device))
    assert seen["windows"] == overlay_windows(pl)
    assert seen["cold"] > 0 and seen["carried"] > 0
    same_run(got, engine._execute(pl, torch.device("cpu")))


def test_overlay_kernel_on_syrk_1024(cuda_device, monkeypatch, tmp_path):
    """The benchmark's syrk-1024: every one of its 64 windows equal to the
    plain version's, then a run under telemetry whose kernel launches
    equal its overlay windows, 64."""
    from pluss_torch import engine, obs
    from pluss_torch.models import REGISTRY

    spec = REGISTRY["syrk"](1024)
    pl = engine.plan(spec)
    assert overlay_windows(pl) == 64
    got, seen = compared_overlay_run(
        monkeypatch, lambda: engine._execute(pl, cuda_device))
    assert seen["windows"] == 64 and seen["carried"] > 0
    obs.configure(str(tmp_path / "t.jsonl"))
    try:
        res = engine.run(spec, device=cuda_device)
        counters = obs.counters()
    finally:
        obs.shutdown()
    assert counters["kernel.launches.overlay_window"] \
        == counters["engine.overlay_windows"] == 64
    same_run(res, got)


@pytest.mark.parametrize("tb", [1, 2, 3])
def test_sliced_runs_on_the_card_match_the_full_run(cuda_device, tb):
    from pluss_torch import engine
    from pluss_torch.models import REGISTRY

    spec = REGISTRY["cholesky"](48)
    want = engine.run(spec, device=cuda_device, window_accesses=1)
    event_histogram.launches = 0
    got = engine.run_sliced(spec, device=cuda_device, window_accesses=1,
                            thread_batch=tb, max_dispatch_entries=1)
    pl = engine.plan(spec, window_accesses=1)
    assert event_histogram.launches == sort_launches(pl, -(-4 // tb))
    np.testing.assert_array_equal(got.noshare_dense, want.noshare_dense)
    assert got.share_raw == want.share_raw


@pytest.mark.parametrize("mode", ["uniform", "prefix"])
def test_sampling_on_the_card_matches_the_cpu(cuda_device, mode):
    from pluss_torch import sampling
    from pluss_torch.models import REGISTRY

    spec = REGISTRY["gemm"](64)
    kw = dict(rate=0.5, window_accesses=1, seed=1, mode=mode)
    event_histogram.launches = 0
    got = sampling.sampled_run(spec, device=cuda_device, **kw)
    assert event_histogram.launches == 2
    want = sampling.sampled_run(spec, device="cpu", **kw)
    np.testing.assert_array_equal(got.noshare_dense, want.noshare_dense)
    assert got.share_raw == want.share_raw
    assert got.sampled_fraction == want.sampled_fraction


# ---------------------------------------------------------------------------
# resilience and telemetry on the card


def test_real_card_oom_classifies_as_resource_exhausted(cuda_device):
    from pluss_torch.resilience import ResourceExhausted, classify

    free, total = torch.cuda.mem_get_info(cuda_device)
    with pytest.raises(torch.OutOfMemoryError) as ei:
        torch.empty(2 * total, dtype=torch.uint8, device=cuda_device)
    err = classify(ei.value, site="engine.run")
    assert isinstance(err, ResourceExhausted) and err.degradable
    assert torch.cuda.OutOfMemoryError is torch.OutOfMemoryError


def test_run_resilient_recovers_an_injected_oom(cuda_device):
    from pluss_torch import engine
    from pluss_torch.models import REGISTRY
    from pluss_torch.resilience import FaultPlan, Retry, faults, \
        run_resilient

    spec = REGISTRY["cholesky"](48)   # the sort path: kernel 1 launches
    clean = engine.run(spec, device=cuda_device)
    faults.install(FaultPlan.parse("oom@1"))
    try:
        res = run_resilient(spec, device=cuda_device,
                            retry=Retry(backoff_s=0.0))
    finally:
        faults.install(None)
    assert res.degradations == ("shrink_window",)
    np.testing.assert_array_equal(res.noshare_dense, clean.noshare_dense)
    assert res.share_raw == clean.share_raw
    assert engine.run(spec, device=cuda_device).degradations == ()


def test_telemetry_on_off_is_bit_identical_on_the_card(tmp_path,
                                                       cuda_device):
    from pluss_torch import engine, obs
    from pluss_torch.models import REGISTRY

    spec = REGISTRY["mvt"](250)
    path = str(tmp_path / "t.bin")
    rng = np.random.default_rng(7)
    (rng.integers(0, 1 << 14, 1 << 16, dtype=np.int64) << 6).astype(
        "<u8").tofile(path)
    kw = dict(window=4096, batch_windows=4, device=cuda_device)
    counts = {}
    out = {}
    for on in (False, True):
        if on:
            obs.configure(str(tmp_path / "ev.jsonl"))
        event_histogram.launches = masked_histogram.launches = 0
        decode_d24v.launches = 0
        try:
            out[on] = (engine.run(spec, device=cuda_device,
                                  window_accesses=1 << 14),
                       trace.replay_file(path, wire="d24v", **kw))
        finally:
            obs.shutdown()
        counts[on] = (event_histogram.launches, masked_histogram.launches,
                      decode_d24v.launches)
    (r0, t0), (r1, t1) = out[False], out[True]
    np.testing.assert_array_equal(r0.noshare_dense, r1.noshare_dense)
    assert r0.share_raw == r1.share_raw
    np.testing.assert_array_equal(t0.hist, t1.hist)
    assert counts[False] == counts[True] and min(counts[True]) > 0


def cli_run(argv):
    import contextlib
    import io

    from pluss_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [
    ["predict", "mvt", "--n", "64", "--check", "--json"],
    ["tune", "gemm", "--n", "32", "--check", "--json"],
])
def test_analysis_check_on_the_card_matches_the_cpu(cuda_device, argv):
    """``predict --check`` and ``tune --check`` run the engine on the card
    (kernel 1 in mvt's sort windows) and print the document the same
    command prints with ``--cpu``."""
    from pluss_torch import engine

    event_histogram.launches = 0
    d0 = engine.DEVICE_DISPATCHES
    rc, card, err = cli_run(argv)
    launches = event_histogram.launches
    assert rc == 0, err
    assert engine.DEVICE_DISPATCHES == d0 + 1
    assert "bit-identical" in err
    rc, cpu, _ = cli_run(argv + ["--cpu"])
    assert rc == 0 and card == cpu
    if argv[1] == "mvt":
        assert launches > 0


def authored(what):
    """A spec from the authoring frontend or the transform prover."""
    from pluss_torch import frontend
    from pluss_torch.analysis import transform as tf
    from pluss_torch.frontend import polybench
    from pluss_torch.models import REGISTRY

    if what == "c":
        with open(polybench.gemm_source_path()) as f:
            src = f.read().replace("#define N 128", "#define N 48")
        return frontend.from_c(src, "gemm48")
    if what == "dsl":
        (spec,) = frontend.from_py(frontend.emit_dsl(REGISTRY["cholesky"](40)))
        return spec
    if what == "corpus":
        return polybench.import_polybench(families=["deriche"])["deriche"]
    rep = {"interchange": lambda: tf.interchange(REGISTRY["gemm"](32), 0, 2),
           "tile": lambda: tf.tile(REGISTRY["gemm"](32),
                                   [(0, 8), (1, 8), (2, 8)]),
           "fuse": lambda: tf.fuse(REGISTRY["2mm"](24), 0, 1)}[what]()
    assert rep.code == "PL951"
    return rep.spec


@pytest.mark.parametrize("what", ["c", "dsl", "corpus", "interchange",
                                  "tile", "fuse"])
def test_authored_and_transformed_specs_on_the_card_match_the_cpu(
        cuda_device, what):
    """Frontend-derived and transformed specs run on the card exactly as
    on the CPU, conserving every access."""
    from pluss_torch import engine

    spec = authored(what)
    on_card = engine.run(spec, device=cuda_device)
    on_cpu = engine.run(spec, device="cpu")
    assert np.array_equal(on_card.noshare_dense, on_cpu.noshare_dense)
    assert on_card.share_raw == on_cpu.share_raw
    assert on_card.max_iteration_count == on_cpu.max_iteration_count
    assert int(on_card.noshare_dense.sum()) + sum(
        sum(d.values()) for d in on_card.share_raw) \
        == on_card.max_iteration_count


@pytest.mark.parametrize("argv", [
    ["transform", "gemm", "--n", "32", "--interchange", "0,2", "--check",
     "--json"],
    ["transform", "mvt", "--n", "64", "--fuse", "0+1", "--check", "--json"],
])
def test_transform_check_on_the_card_matches_the_cpu(cuda_device, argv):
    """``transform --check`` runs the transformed spec on the card and
    prints the document the same command prints with ``--cpu``."""
    from pluss_torch import engine

    d0 = engine.DEVICE_DISPATCHES
    rc, card, err = cli_run(argv)
    assert rc == 0, err
    assert engine.DEVICE_DISPATCHES == d0 + 1
    assert "verified against engine.run" in err
    rc, cpu, _ = cli_run(argv + ["--cpu"])
    assert rc == 0 and card == cpu


@pytest.mark.parametrize("model,n", [("gemm", 16), ("cholesky", 16),
                                     ("syrk", 32), ("trmm", 16)])
@pytest.mark.parametrize("dispatch,segmented", [("steal", True),
                                                ("static", True),
                                                ("static", False)])
def test_shard_run_on_the_card_matches_the_cpu(cuda_device, model, n,
                                               dispatch, segmented):
    """``shard_run`` with one and with four workers on the card equals
    the CPU's sharded run, both window kernels launching on the card."""
    from pluss_torch.config import SamplerConfig
    from pluss_torch.models import REGISTRY
    from pluss_torch.parallel.shard import shard_run

    spec, cfg = REGISTRY[model](n), SamplerConfig(cls=8)
    want = shard_run(spec, cfg, devices=["cpu"] * 2, dispatch=dispatch,
                     segmented=segmented, window_accesses=1)
    for workers in (1, 4):
        got = shard_run(spec, cfg, devices=[cuda_device] * workers,
                        dispatch=dispatch, segmented=segmented,
                        window_accesses=1)
        np.testing.assert_array_equal(got.noshare_dense, want.noshare_dense)
        assert got.share_raw == want.share_raw
        assert got.max_iteration_count == want.max_iteration_count


def test_shard_replay_file_on_the_card_matches_the_cpu(cuda_device,
                                                       tmp_path):
    rng = np.random.default_rng(21)
    path = str(tmp_path / "t.bin")
    lines = np.concatenate([rng.integers(0, 4096, 30_000),
                            (1 << 40) + rng.integers(0, 4096, 9_000)])
    (lines.astype(np.uint64) << np.uint64(6)).astype("<u8").tofile(path)
    want = trace.replay_file(path, window=1 << 10, batch_windows=2,
                             device="cpu")
    for devices, dispatch in (([cuda_device] * 3, "steal"),
                              ([cuda_device], "static")):
        got = trace.shard_replay_file(path, window=1 << 10, batch_windows=2,
                                      devices=devices, dispatch=dispatch)
        np.testing.assert_array_equal(got.hist, want.hist)
