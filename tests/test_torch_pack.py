"""The port's packed traces vs the JAX package's, byte for byte.

``pluss_torch.trace.pack_file`` must write the pack and the sidecar that
``pluss.trace.pack_file`` writes for the same trace: u24, the i32 restart
once the table reaches 2^24 lines, and d24v records; a pack interrupted
in one package resumes from its journal in the other to the same bytes;
``pack_cached`` keys staleness on the source and the batch grid and
probes without packing; each package stages and replays the other's packs
to the streamed histogram.  Traces come from numpy seeds at about 1e5
refs; every comparison is exact.
"""

import filecmp
import json
import os

import numpy as np
import pytest

from pluss import trace as jt
from pluss.resilience import faults
from pluss.resilience.errors import DataLoss as JaxDataLoss
from pluss_torch import trace as tt
from pluss_torch.errors import DataLoss

GEO = dict(window=4096, batch_windows=2)
N = 100_000


def write_trace(path, n=N, seed=0, far=True):
    """Seeded byte addresses: hot and warm lines and, with ``far``, a
    sequential sweep 2^30 lines up (a second cluster)."""
    rng = np.random.default_rng(seed)
    lines = np.where(rng.random(n) < 0.5, rng.integers(0, 1 << 8, n),
                     rng.integers(0, 1 << 13, n))
    if far:
        phase = (np.arange(n) // 5000) % 3 == 2
        lines = np.where(phase, (1 << 30) + (np.arange(n) // 8) % 4000,
                         lines)
    (lines.astype(np.uint64) << np.uint64(6)).astype("<u8").tofile(path)
    return str(path)


def same_pack(a, b):
    assert filecmp.cmp(a, b, shallow=False), f"{a} != {b}"
    with open(a + ".json", "rb") as fa, open(b + ".json", "rb") as fb:
        assert fa.read() == fb.read(), "sidecars differ"


def same(got, want):
    np.testing.assert_array_equal(got.hist, want.hist)
    assert got.total_count == want.total_count
    assert got.n_lines == want.n_lines


@pytest.mark.parametrize("wire,workers,limit", [
    ("pack", 1, None), ("pack", 3, 77_777), ("d24v", 1, None),
    ("d24v", 4, 77_777), (None, 2, None)])
def test_pack_is_byte_identical_to_jax(tmp_path, wire, workers, limit):
    path = write_trace(tmp_path / "t.bin")
    kw = dict(wire=wire, limit_refs=limit, **GEO)
    want = jt.pack_file(path, str(tmp_path / "j.pack"), **kw)
    got = tt.pack_file(path, str(tmp_path / "t.pack"), feed_workers=workers,
                       **kw)
    assert got == want
    assert got["fmt"] == ("d24v" if wire == "d24v" else "u24")
    assert got["n"] == (limit or N) and got["wire"] == tt.WIRE_VERSION
    same_pack(str(tmp_path / "t.pack"), str(tmp_path / "j.pack"))
    assert not os.path.exists(str(tmp_path / "t.pack.journal"))
    # the sidecar's counts are the streamed replay's
    rep = tt.replay_file(path, device="cpu", limit_refs=limit, **GEO)
    assert (got["n"], got["n_lines"]) == (rep.total_count, rep.n_lines)


def clustered_trace(path, n_clusters):
    """One ref in each of ``n_clusters`` far-apart clusters: each
    reserves 1024 id slots, so 16,448 of them pass 2^24 lines."""
    lines = np.arange(n_clusters, dtype=np.int64) * 4096
    (lines * 64).astype("<u8").tofile(path)
    return str(path)


def test_i32_restart_past_2_24_lines_matches_jax(tmp_path):
    n = (1 << 24) // 1024 + 64
    path = clustered_trace(tmp_path / "t.bin", n)
    kw = dict(window=512, batch_windows=8)
    want = jt.pack_file(path, str(tmp_path / "j.pack"), **kw)
    got = tt.pack_file(path, str(tmp_path / "t.pack"), feed_workers=2, **kw)
    assert got == want and got["fmt"] == "i32"
    assert got["n_lines"] >= 1 << 24 and got["n"] == n
    same_pack(str(tmp_path / "t.pack"), str(tmp_path / "j.pack"))
    assert os.path.getsize(str(tmp_path / "t.pack")) == 4 * n
    # the i32 pack stages (4 bytes per ref) and replays as the stream
    rep = tt.replay_resident(str(tmp_path / "t.pack"), got, device="cpu",
                             **kw)
    same(rep, tt.replay_file(path, device="cpu", **kw))
    assert rep.hist[0] == n


def test_u24_just_under_2_24_stays_narrow(tmp_path):
    path = clustered_trace(tmp_path / "t.bin", 1000)
    meta = tt.pack_file(path, str(tmp_path / "t.pack"), window=512)
    assert meta["fmt"] == "u24" and meta["n_lines"] < 1 << 24
    assert meta == jt.pack_file(path, str(tmp_path / "j.pack"), window=512)


def test_d24v_batch_cap(tmp_path):
    path = write_trace(tmp_path / "t.bin", n=100)
    with pytest.raises(ValueError, match="d24v records cap"):
        tt.pack_file(path, str(tmp_path / "t.pack"), window=1 << 24,
                     batch_windows=8, wire="d24v")
    with pytest.raises(ValueError, match="unknown wire"):
        tt.pack_file(path, str(tmp_path / "t.pack"), wire="zip")


# --- resume across packages ------------------------------------------------

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


def interrupted_pack(writer, monkeypatch, path, out, **kw):
    """Run a pack that a read fault stops after a few batches; leaves the
    ``.tmp`` and the journal behind."""
    if writer == "port":
        with monkeypatch.context() as m:
            _port_fault_at(m, 5)
            with pytest.raises(DataLoss):
                tt.pack_file(path, out, feed_workers=2, **kw)
    else:
        faults.install(faults.FaultPlan.parse("trace_loss@6"))
        try:
            with pytest.raises(JaxDataLoss):
                jt.pack_file(path, out, **kw)
        finally:
            faults.install(None)
    assert os.path.exists(out + ".tmp") and os.path.exists(out + ".journal")


@pytest.mark.parametrize("wire", ["pack", "d24v"])
@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"),
                                           ("port", "jax")])
def test_resume_across_packages_is_byte_identical(tmp_path, monkeypatch,
                                                  capsys, wire, writer,
                                                  reader):
    path = write_trace(tmp_path / "t.bin")
    kw = dict(window=2048, batch_windows=2, wire=wire)
    whole = str(tmp_path / "whole.pack")
    jt.pack_file(path, whole, **kw)
    out = str(tmp_path / "t.pack")
    interrupted_pack(writer, monkeypatch, path, out, **kw)
    # the resume keeps the format even without wire= (d24v stays d24v)
    rkw = dict(kw, wire=None) if wire == "d24v" else kw
    if reader == "port":
        meta = tt.pack_file(path, out, resume=True, feed_workers=3, **rkw)
    else:
        meta = jt.pack_file(path, out, resume=True, **rkw)
    assert "resuming pack at batch 5/" in capsys.readouterr().err
    same_pack(out, whole)
    assert meta["fmt"] == ("d24v" if wire == "d24v" else "u24")
    assert not os.path.exists(out + ".journal")


def test_resume_of_an_i32_pack_stays_i32(tmp_path, monkeypatch):
    n = (1 << 24) // 1024 + 3000
    path = clustered_trace(tmp_path / "t.bin", n)
    kw = dict(window=512, batch_windows=2)
    whole = str(tmp_path / "whole.pack")
    assert jt.pack_file(path, whole, **kw)["fmt"] == "i32"
    out = str(tmp_path / "t.pack")
    real = tt._extent_reader
    legs = []

    def reader(path_, batch_, n_):
        read = real(path_, batch_, n_)
        legs.append(batch_)

        def read_or_fail(b):
            # the i32 restart is the second leg: stop it at batch 10
            if len(legs) == 2 and b == 10:
                raise DataLoss("injected read fault")
            return read(b)
        return read_or_fail

    with monkeypatch.context() as m:
        m.setattr(tt, "_extent_reader", reader)
        with pytest.raises(DataLoss):
            tt.pack_file(path, out, feed_workers=1, **kw)
    meta = tt.pack_file(path, out, resume=True, **kw)
    assert meta["fmt"] == "i32"
    same_pack(out, whole)


def test_stale_or_foreign_journal_starts_fresh(tmp_path, monkeypatch):
    path = write_trace(tmp_path / "t.bin")
    out = str(tmp_path / "t.pack")
    interrupted_pack("port", monkeypatch, path, out, **GEO)
    whole = str(tmp_path / "whole.pack")
    tt.pack_file(path, whole, window=4096, batch_windows=3)
    # another batch grid is another pack: the journal is ignored
    tt.pack_file(path, out, resume=True, window=4096, batch_windows=3)
    same_pack(out, whole)


# --- the disk pack cache ---------------------------------------------------

def test_pack_cached_staleness_and_probe(tmp_path):
    p = str(tmp_path / "t.bin")
    write_trace(p, n=30_000, seed=5)
    packed = str(tmp_path / "t.pack")
    kw = dict(window=1 << 10, batch_windows=4, wire="d24v")
    meta0, cached, pk = tt.pack_cached(p, packed, **kw)
    assert not cached and pk == packed
    meta1, cached, _ = tt.pack_cached(p, packed, **kw)
    assert cached and meta1 == meta0
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    meta2, cached, _ = tt.pack_cached(p, packed, allow_pack=False, **kw)
    assert cached and meta2 == meta0
    # JAX's cache takes the port's pack as its own
    assert jt.pack_cached(p, packed, allow_pack=False, **kw)[1]
    # a regenerated source (same size, new content) is stale
    write_trace(p, n=30_000, seed=6)
    assert tt.pack_cached(p, packed, allow_pack=False, **kw) \
        == (None, False, packed)
    meta4, cached, _ = tt.pack_cached(p, packed, **kw)
    assert not cached and meta4["src_fp"] != meta0["src_fp"]
    # a d24v pack stages only at its own grid: another grid repacks
    assert not tt.pack_cached(p, packed, window=1 << 10, batch_windows=8,
                              wire="d24v")[1]
    # a wire-version bump and a torn sidecar are stale too
    with open(packed + ".json") as f:
        meta = json.load(f)
    with open(packed + ".json", "w") as f:
        json.dump(dict(meta, wire=tt.WIRE_VERSION + 1), f)
    assert tt.pack_cached(p, packed, window=1 << 10, batch_windows=8,
                          wire="d24v", allow_pack=False)[0] is None
    with open(packed + ".json", "w") as f:
        f.write("{not json")
    assert tt.pack_cached(p, packed, allow_pack=False)[0] is None
    # the default path is next to the trace, and fixed-width packs stage
    # at any grid
    meta5, cached, pk = tt.pack_cached(p, wire="pack", window=1 << 10)
    assert pk == p + ".pack" and meta5["fmt"] == "u24" and not cached
    assert tt.pack_cached(p, window=1 << 10, batch_windows=3,
                          allow_pack=False)[1]


# --- cross staging ---------------------------------------------------------

@pytest.mark.parametrize("wire", ["pack", "d24v"])
def test_each_package_stages_the_others_pack(tmp_path, wire):
    path = write_trace(tmp_path / "t.bin", seed=3)
    jpack, tpack = str(tmp_path / "j.pack"), str(tmp_path / "t.pack")
    jmeta = jt.pack_file(path, jpack, wire=wire, **GEO)
    tmeta = tt.pack_file(path, tpack, wire=wire, feed_workers=2, **GEO)
    want = jt.replay_file(path, **GEO)
    same(tt.replay_file(path, device="cpu", **GEO), want)
    same(tt.replay_resident(jpack, jmeta, device="cpu", **GEO), want)
    same(jt.replay_resident(tpack, tmeta, **GEO), want)
    stats = {}
    same(tt.replay_resident(tpack, tmeta, device="cpu", stats=stats, **GEO),
         want)
    assert stats["refs"] == N and stats["upload_bytes"] > 0
    if wire == "d24v":   # the compressed records, not the u24 bytes
        assert stats["upload_bytes"] < os.path.getsize(tpack) + 1
        assert stats["upload_bytes"] < 3 * N


@pytest.mark.parametrize("wire", ["pack", "d24v"])
def test_truncated_pack_raises_data_loss(tmp_path, wire):
    path = write_trace(tmp_path / "t.bin", n=30_000)
    packed = str(tmp_path / "t.pack")
    meta = tt.pack_file(path, packed, wire=wire, window=1024,
                        batch_windows=4)
    size = os.path.getsize(packed)
    with open(packed, "r+b") as f:
        f.truncate(size - 5)
    with pytest.raises(DataLoss, match="record 7 .* cut short"):
        tt.stage_resident(packed, meta, 1024, batch_windows=4,
                          device="cpu")
    with pytest.raises(ValueError, match="unknown packed trace format"):
        tt.stage_resident(packed, dict(meta, fmt="u16"), 1024,
                          device="cpu")
    if wire == "d24v":
        with pytest.raises(ValueError, match="was cut at 4096"):
            tt.stage_resident(packed, meta, 1024, batch_windows=2,
                              device="cpu")


def test_journal_lines_torn_tail_and_corrupt_middle(tmp_path, capsys):
    """The port's journal writes JAX's lines byte for byte; a torn final
    line is dropped with a notice, a corrupt earlier line raises
    ``CacheCorrupt`` naming it, in both packages."""
    from pluss.resilience.errors import CacheCorrupt as JaxCacheCorrupt
    from pluss.resilience.journal import Journal as JaxJournal
    from pluss_torch.errors import CacheCorrupt
    from pluss_torch.journal import Journal

    mine, theirs = str(tmp_path / "t.journal"), str(tmp_path / "j.journal")
    for cls, path in ((Journal, mine), (JaxJournal, theirs)):
        j = cls(path)
        j.record({"batch": 0}, out_bytes=3, comp={"starts": [1, 2]}, fp="x")
        j.record({"batch": 1}, out_bytes=6, fmt="u24")
        j.record({"batch": 0}, out_bytes=4)      # a later record wins
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    with open(mine, "a") as f:
        f.write('{"key": {"batch": 2}, "out_')  # a crash mid-append
    j = Journal(mine)
    assert j.get({"batch": 0})["out_bytes"] == 4
    assert j.get({"batch": 1})["fmt"] == "u24" and j.get({"batch": 2}) is None
    assert "torn final line" in capsys.readouterr().err
    assert JaxJournal(mine).get({"batch": 1}) == j.get({"batch": 1})
    lines = open(mine).read().splitlines()
    with open(mine, "w") as f:
        f.write("\n".join([lines[0], "garbage", lines[1]]) + "\n")
    with pytest.raises(CacheCorrupt, match="corrupt journal line 2") as ei:
        Journal(mine)
    assert ei.value.retryable and ei.value.site == "journal.load"
    with pytest.raises(JaxCacheCorrupt, match="corrupt journal line 2"):
        JaxJournal(mine)
