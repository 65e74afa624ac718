"""The port's trace replay vs the JAX package's, exactly.

``pluss_torch.trace.replay_file`` / ``replay`` on the CPU must give
``pluss.trace``'s histogram, ``total_count`` and ``n_lines`` over u64 and
text files, both wires, one and several windows per batch, ragged last
batches, table growth from a small capacity, two memory regions more than
2^24 lines apart (the compactor's cluster probing), ``limit_refs``, and
checkpoint/resume splits — including a checkpoint written by one package
and resumed by the other.  One case runs the JAX side through its Pallas
kernels (interpret mode, as tests/test_pallas_events.py runs them).
Streams come from numpy seeds at a few thousand refs.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pluss import trace as jt
from pluss.ops import pallas_decode, pallas_events
from pluss.ops import reuse as jr
from pluss.resilience import faults
from pluss.resilience.errors import DataLoss as JaxDataLoss
from pluss_torch import trace as tt
from pluss_torch import tracegen
from pluss_torch.resilience.errors import DataLoss
from pluss_torch.ops import reuse as tr

#: a line of the second region: more than 2^24 lines above the first
FAR = 1 << 30


def stream(seed, n, far=True):
    """Seeded line ids: a hot and a warm set, and (``far``) a sequential
    sweep in a second region FAR lines up, interleaved in phases."""
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, 1 << 8, n)
    warm = rng.integers(0, 1 << 13, n)
    lines = np.where(rng.random(n) < 0.5, hot, warm)
    if far:
        sweep = FAR + (np.arange(n) // 8) % 3000
        phase = (np.arange(n) // 700) % 3 == 2
        lines = np.where(phase, sweep, lines)
    return lines.astype(np.int64)


def write_u64(path, lines):
    (lines.astype(np.uint64) << np.uint64(6)).astype("<u8").tofile(path)
    return str(path)


def same(got, want):
    np.testing.assert_array_equal(got.hist, want.hist)
    assert got.total_count == want.total_count
    assert got.n_lines == want.n_lines


@pytest.mark.parametrize("case", [
    # wire, window, batch windows, refs, initial capacity, far region
    ("pack", 2048, 1, 5 * 2048 + 300, 1 << 10, True),
    ("d24v", 1024, 4, 3 * 4096 + 777, 1 << 8, True),
    ("d24v", 2048, 1, 4 * 2048, 1 << 20, False),
    ("pack", 1024, 4, 2 * 4096 + 1, 1 << 6, False),
], ids=["pack-bw1-growth-far", "d24v-bw4-growth-far", "d24v-bw1-exact",
        "pack-bw4-tiny-cap"])
def test_replay_file_matches_jax(tmp_path, case):
    wire, window, bw, n, cap, far = case
    path = write_u64(tmp_path / "t.bin", stream(1, n, far))
    kw = dict(window=window, batch_windows=bw, wire=wire,
              initial_capacity=cap)
    want = jt.replay_file(path, **kw)
    got = tt.replay_file(path, device="cpu", **kw)
    same(got, want)
    assert got.total_count == n and got.wire == wire
    assert got.hist[0] > 0 and got.hist[1:].sum() > 0
    if cap < want.n_lines:
        assert got.timing["growths"] > 0


@pytest.mark.parametrize("bw", [1, 4])
def test_text_trace_matches_jax(tmp_path, bw):
    lines = stream(2, 3000)
    path = tmp_path / "t.txt"
    path.write_text("\n".join(
        (hex(int(a)) if i % 2 else str(int(a)))
        for i, a in enumerate(lines << 6)) + "\n\n")
    want = jt.replay_file(str(path), fmt="text", window=512,
                          batch_windows=bw)
    got = tt.replay_file(str(path), fmt="text", window=512, batch_windows=bw,
                         device="cpu")
    same(got, want)


@pytest.mark.parametrize("limit", [1, 2500, 4096, 10**9])
def test_limit_refs_matches_jax(tmp_path, limit):
    path = write_u64(tmp_path / "t.bin", stream(3, 5000))
    kw = dict(window=1024, batch_windows=2, limit_refs=limit)
    got = tt.replay_file(path, device="cpu", **kw)
    same(got, jt.replay_file(path, **kw))
    assert got.total_count == min(limit, 5000)


def test_replay_in_memory_matches_jax():
    addrs = stream(4, 6000) << 6
    for kw in (dict(window=1024), dict(window=512, batch_windows=3)):
        same(tt.replay(addrs, device="cpu", **kw), jt.replay(addrs, **kw))
    lines = stream(5, 3000, far=False)
    same(tt.replay(lines, precompacted=True, window=1024, device="cpu"),
         jt.replay(lines, precompacted=True, window=1024))


def test_pallas_kernels_path_matches(tmp_path, monkeypatch):
    """The JAX side through both Pallas kernels (events and decode,
    interpret mode) on the d24v wire, the segmented batch and a ragged
    tail, as tests/test_pallas_events.py runs them."""
    monkeypatch.setenv("PLUSS_PALLAS_EVENTS", "1")
    monkeypatch.setenv("PLUSS_PALLAS_DECODE", "1")
    pallas_events.reset_probe()
    pallas_decode.reset_probe()
    try:
        path = write_u64(tmp_path / "t.bin", stream(6, 3 * 2 * 4096 + 1500))
        kw = dict(window=4096, batch_windows=2, wire="d24v")
        want = jt.replay_file(path, segmented=True, **kw)
    finally:
        pallas_events.reset_probe()
        pallas_decode.reset_probe()
    same(tt.replay_file(path, device="cpu", **kw), want)


def test_batch_events_match_jax():
    """The segmented extraction itself: events and the advanced table."""
    rng = np.random.default_rng(7)
    n, n_lines, base = 5000, 300, 40_000
    line = rng.integers(0, n_lines, n).astype(np.int32)
    pos = (base + np.arange(n)).astype(np.int32)
    valid = pos < base + n - 77
    last = np.where(rng.random(n_lines) < 0.4, -1,
                    rng.integers(0, base, n_lines)).astype(np.int32)
    want, want_last = jr.batch_events(jnp.asarray(line), jnp.asarray(pos),
                                      jnp.asarray(valid), jnp.asarray(last))
    table = torch.from_numpy(np.append(last, np.int32(-7)))  # + dump slot
    got = tr.batch_events(torch.from_numpy(line), torch.from_numpy(pos),
                          torch.from_numpy(valid), table)
    for k in ("reuse", "is_evt", "share", "cold"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(table[:-1].numpy(), np.asarray(want_last))


def test_int64_positions_past_2_31_match_jax():
    """Traces of 2^31 - 2 refs or more take int64 positions: one batch far
    past the int32 range, resolved against a carried table, equals the JAX
    package's segmented batch at the same positions (both epilogues bin
    the int64 reuse with 64-bit widths)."""
    rng = np.random.default_rng(14)
    n, n_lines, base = 6000, 500, (5 << 31) + 123
    ids = rng.integers(0, n_lines, n).astype(np.int32)
    last = np.where(rng.random(n_lines) < 0.5, -1,
                    rng.integers(base - (1 << 33), base, n_lines))
    n_valid = base + n - 250
    table = torch.from_numpy(np.append(last, -1))
    hist = torch.zeros(49, dtype=torch.int64)
    tt._segmented_batch(table, hist, base, torch.from_numpy(ids), n_valid,
                        torch.int64, tt.KERNELS.histogram)
    want_last, want_hist = jt._segmented_batch(
        jnp.asarray(last), jnp.zeros(49, jnp.int64), np.int64(base),
        jnp.asarray(ids)[None], np.int64(n_valid), jnp.int64)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(want_hist))
    np.testing.assert_array_equal(table[:-1].numpy(), np.asarray(want_last))
    assert hist[25:].sum() > 0    # reuses past 2^31 were binned


def test_feed_variants_agree(tmp_path):
    """The single reader thread and the worker pool give one histogram;
    stage depth and queue depth change nothing."""
    path = write_u64(tmp_path / "t.bin", stream(8, 7 * 1024 + 5))
    kw = dict(window=1024, batch_windows=1, device="cpu")
    ref = tt.replay_file(path, feed_workers=1, **kw)
    for extra in (dict(feed_workers=1, stage_depth=1, queue_depth=1),
                  dict(feed_workers=3, queue_depth=1),
                  dict(feed_workers=4, stage_depth=3, wire="d24v")):
        got = tt.replay_file(path, **kw, **extra)
        same(got, ref)
        assert got.timing["batches"] == 8


def test_deadline_stops_after_the_batch_in_flight(tmp_path):
    path = write_u64(tmp_path / "t.bin", stream(9, 4 * 1024))
    kw = dict(window=1024, batch_windows=1, device="cpu")
    got = tt.replay_file(path, deadline_s=0.0, **kw)
    assert got.total_count == 1024
    same(got, tt.replay_file(path, limit_refs=1024, **kw))


def test_generated_trace_matches_its_golden(tmp_path):
    """tracegen's two-part layout at a small size: the replay equals the
    hot/warm part replayed alone plus the sweeps' hand-worked histogram,
    and the JAX package."""
    path = str(tmp_path / "g.bin")
    part_a = 3000
    with open(path, "wb") as f:
        tracegen.hot_warm(f, part_a, np.random.default_rng(0))
        tracegen.sweeps(f, 3, 512, tracegen.SWEEP_BASE_LINE)
    kw = dict(window=2048, batch_windows=2)
    full = tt.replay_file(path, device="cpu", **kw)
    alone = tt.replay_file(path, device="cpu", limit_refs=part_a, **kw)
    np.testing.assert_array_equal(
        full.hist, alone.hist + tracegen.sweep_histogram(3, 512))
    assert full.total_count == part_a + 3 * 512 * 8
    same(full, jt.replay_file(path, **kw))


# --- checkpoint / resume ---------------------------------------------------

GEO = dict(window=1024, batch_windows=2, wire="pack")
N_CKPT = 6 * 2048 + 333


def _port_fault_at(monkeypatch, batch):
    """Make the port's reader raise at stream batch ``batch``."""
    real = tt._extent_reader

    def reader(path, batch_, n):
        read = real(path, batch_, n)

        def read_or_fail(b):
            if b == batch:
                raise DataLoss(f"injected read fault at batch {b}")
            return read(b)
        return read_or_fail

    monkeypatch.setattr(tt, "_extent_reader", reader)


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"),
                                           ("port", "jax")])
def test_checkpoint_resume_split(tmp_path, monkeypatch, writer, reader):
    path = write_u64(tmp_path / "t.bin", stream(10, N_CKPT))
    ckpt = str(tmp_path / "t.ckpt.npz")
    want = jt.replay_file(path, **GEO)
    kw = dict(checkpoint_path=ckpt, checkpoint_every=2,
              initial_capacity=1 << 10, **GEO)
    if writer == "port":
        with monkeypatch.context() as m:
            _port_fault_at(m, 5)
            with pytest.raises(DataLoss):
                tt.replay_file(path, device="cpu", **kw)
    else:
        faults.install(faults.FaultPlan.parse("trace_loss@5"))
        try:
            with pytest.raises(JaxDataLoss):
                jt.replay_file(path, **kw)
        finally:
            faults.install(None)
    with np.load(ckpt) as z:
        assert int(z["b_next"]) == 4
    if reader == "port":
        got = tt.replay_file(path, device="cpu", resume=True, **kw)
    else:
        got = jt.replay_file(path, resume=True, **kw)
    same(got, want)
    assert not os.path.exists(ckpt)   # a finished run retires it


def test_checkpoint_of_another_run_or_corrupt_starts_fresh(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    path = write_u64(tmp_path / "t.bin", stream(11, N_CKPT))
    ckpt = str(tmp_path / "t.ckpt.npz")
    kw = dict(checkpoint_path=ckpt, checkpoint_every=1, **GEO)
    with monkeypatch.context() as m:
        _port_fault_at(m, 3)
        with pytest.raises(DataLoss):
            tt.replay_file(path, device="cpu", **kw)
    want = jt.replay_file(path, **GEO)
    # another batch width is another run: ignored with a notice
    other = dict(kw, batch_windows=3)
    same(tt.replay_file(path, device="cpu", resume=True, **other),
         jt.replay_file(path, window=1024, batch_windows=3, wire="pack"))
    assert "different run" in capsys.readouterr().err
    with open(ckpt, "wb") as f:
        f.write(b"not a checkpoint")
    same(tt.replay_file(path, device="cpu", resume=True, **kw), want)
    assert os.path.exists(ckpt + ".corrupt")


def test_bad_inputs_raise(tmp_path, monkeypatch):
    path = tmp_path / "t.bin"
    path.write_bytes(b"\0" * 20)                 # not whole u64 records
    with pytest.raises(DataLoss, match="byte offset 16"):
        tt.replay_file(str(path), device="cpu")
    txt = tmp_path / "t.txt"
    txt.write_text("0x40\n12\nbanana\n")
    with pytest.raises(DataLoss, match="line 3"):
        tt.replay_file(str(txt), fmt="text", device="cpu")
    good = write_u64(tmp_path / "g.bin", stream(12, 100))
    for kw in (dict(wire="zip"), dict(batch_windows=0), dict(window=0),
               dict(feed_workers=0), dict(stage_depth=0), dict(fmt="csv"),
               dict(cls=48)):
        with pytest.raises(ValueError):
            tt.replay_file(good, device="cpu", **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.replay_file(good)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.replay(stream(12, 100) << 6)
