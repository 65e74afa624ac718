"""The port's device-resident replay and residency store vs the JAX
package's, exactly.

The store's semantics mirror tests/test_residency.py (put, lookup and
unpin; LRU eviction that never evicts a pinned entry; an oversize entry
raises ``ResourceExhausted``; budget validation; a lenient
``PLUSS_HBM_BUDGET``; key invalidation).  Every replay below equals
``pluss.trace``'s result (``hist``, ``total_count``, ``n_lines``):
``replay_file(resident_cache=True)`` cold, warm and on a tiny budget,
``replay_resident``, ``replay_staged`` (``clock0``, int64 positions,
``limit_refs``, ``upload_budget_s``), ``ensure_resident`` and the legacy
per-window scan (``segmented=False``) across test_torch_trace.py's
matrix; a stage-through copy equals a direct staging of the pack byte for
byte; checkpointed, resumed and truncated runs never publish.  Runs on
the CPU (``device="cpu"``), with numpy-seeded traces of a few 1e4 refs.
"""

import numpy as np
import pytest
import torch

from pluss import cli as jax_cli
from pluss import residency as jres
from pluss import trace as jt
from pluss_torch import cli, residency
from pluss_torch import trace as tt
from pluss_torch.errors import DataLoss, ResourceExhausted

CPU = dict(device="cpu")
GEO = dict(window=1 << 10, batch_windows=4)
N = 20_000


@pytest.fixture(autouse=True)
def fresh_store():
    """Every test starts and ends with empty stores in both packages."""
    residency.reset()
    jres.reset()
    yield
    residency.reset()
    jres.reset()


def mk_trace(path, n=N, hi=1 << 11, seed=5, far=False):
    rng = np.random.default_rng(seed)
    lines = rng.integers(0, hi, n, dtype=np.int64)
    if far:
        phase = (np.arange(n) // 3000) % 2 == 1
        lines = np.where(phase, (1 << 30) + np.arange(n) // 8, lines)
    (lines << 6).astype("<u8").tofile(path)
    return str(path)


def same(got, want):
    np.testing.assert_array_equal(got.hist, want.hist)
    assert got.total_count == want.total_count
    assert got.n_lines == want.n_lines


def key_of(path, window=1 << 10, bw=4):
    return tt._residency_key(path, cls=64, window=window, bw=bw,
                             precompacted=False, **CPU)


# --- the store (no replay) -------------------------------------------------

def test_store_put_lookup_unpin_stats():
    st = residency.ResidencyStore(budget=1000)
    st.reserve(400)
    st.put("a", b"\0" * 400, n_lines=7, n_run=10, nbytes=400)
    assert len(st) == 1 and st.used_bytes() == 400
    ent = st.lookup_pin("a", n_run=10)
    assert ent is not None and ent.pins == 1 and ent.n_lines == 7
    # another replayed prefix misses: its n_lines differs
    assert st.lookup_pin("a", n_run=5) is None
    st.unpin("a")
    assert st.stats() == {"entries": 1, "bytes": 400, "budget": 1000,
                          "pinned": 0}
    st.discard("a")
    assert len(st) == 0
    st.discard("a")  # idempotent
    st.put("b", 1, n_lines=1, n_run=1, nbytes=1)
    st.clear()
    assert len(st) == 0


def test_store_lru_eviction_never_touches_pins():
    st = residency.ResidencyStore(budget=1000)
    for key in ("a", "b", "c"):
        st.reserve(300)
        st.put(key, key, n_lines=1, n_run=1, nbytes=300)
    assert st.lookup_pin("a") is not None   # a: most recent, pinned
    st.reserve(300)          # 900 + 300 > 1000: evicts b, the LRU unpinned
    st.put("d", "d", n_lines=1, n_run=1, nbytes=300)
    assert st.lookup_pin("b") is None
    assert st.lookup_pin("c") is not None and st.lookup_pin("d") is not None
    with pytest.raises(ResourceExhausted, match="pinned"):
        st.reserve(300)      # a, c and d are pinned
    st.unpin("a")
    st.reserve(200)          # a is unpinned now, and the LRU
    assert st.lookup_pin("a") is None
    assert st.stats()["entries"] == 2


def test_store_refuses_an_oversized_entry_degradably():
    st = residency.ResidencyStore(budget=1000)
    with pytest.raises(ResourceExhausted, match="device budget") as ei:
        st.reserve(2000)
    assert ei.value.degradable and not ei.value.fatal
    assert ei.value.site == "residency.stage"


def test_budget_kwarg_validated():
    for bad in (0, -5, True, "2G", 1.5):
        with pytest.raises(ValueError, match="budget"):
            residency.ResidencyStore(budget=bad)
    with pytest.raises(ValueError, match="budget"):
        residency.reset(budget=0)


def test_budget_env_knob_lenient(monkeypatch, capsys):
    assert residency.device_budget_default() == 2 << 30   # no card here
    monkeypatch.setenv("PLUSS_HBM_BUDGET", "12345")
    assert residency.budget_bytes() == 12345
    assert residency.store().budget() == 12345
    for bad in ("a-gigabyte-ish", "-3"):
        monkeypatch.setenv("PLUSS_HBM_BUDGET", bad)
        assert residency.budget_bytes() == residency.device_budget_default()
        assert "PLUSS_HBM_BUDGET" in capsys.readouterr().err
    monkeypatch.delenv("PLUSS_HBM_BUDGET")
    assert residency.budget_bytes() == residency.device_budget_default()
    assert residency.reset(budget=777).budget() == 777


def test_residency_key_invalidation(tmp_path, monkeypatch):
    p = str(tmp_path / "t.bin")
    mk_trace(p, seed=5)
    base = dict(cls=64, window=4096, bw=4, precompacted=False, device="cpu")
    k0 = tt._residency_key(p, **base)
    assert k0[-1] == ("cpu", None)
    mk_trace(p, seed=6)                      # same size, new content
    assert tt._residency_key(p, **base) != k0
    mk_trace(p, n=N + 1, seed=5)             # new size
    assert tt._residency_key(p, **base) != k0
    mk_trace(p, seed=5)                      # restored: the key is stable
    assert tt._residency_key(p, **base) == k0
    for change in (dict(cls=128), dict(window=8192), dict(bw=8),
                   dict(precompacted=True)):
        assert tt._residency_key(p, **{**base, **change}) != k0
    monkeypatch.setattr(tt, "WIRE_VERSION", "test-wire-bump")
    assert tt._residency_key(p, **base) != k0


# --- resident replays equal JAX --------------------------------------------

@pytest.mark.parametrize("wire", ["pack", "d24v"])
def test_cold_warm_hit_equals_jax(tmp_path, wire):
    p = mk_trace(tmp_path / "t.bin", far=True)
    want = jt.replay_file(p, **GEO)
    cold = tt.replay_file(p, resident_cache=True, wire=wire, **GEO, **CPU)
    assert cold.timing["resident"] == "stage_through"
    assert len(residency.store()) == 1
    warm = tt.replay_file(p, resident_cache=True, wire=wire, **GEO, **CPU)
    same(cold, want)
    same(warm, want)
    # a hit has no feed: no bytes copied, no feed stage ran
    tm = warm.timing
    assert tm["resident"] == "hit" and tm["h2d_bytes"] == 0
    assert tm["read_s"] == tm["compact_s"] == tm["encode_s"] == 0.0
    assert tm["batches"] == -(-N // (4 << 10)) and warm.wire == ""
    assert residency.store().stats()["pinned"] == 0
    # the JAX package's warm hit agrees
    jt.replay_file(p, resident_cache=True, **GEO)
    same(jt.replay_file(p, resident_cache=True, **GEO), warm)
    # off (None or False) keeps the store out of the path
    assert "resident" not in tt.replay_file(p, resident_cache=False, **GEO,
                                            **CPU).timing


@pytest.mark.parametrize("wire", ["pack", "d24v"])
def test_stage_through_equals_direct_staging(tmp_path, wire):
    p = mk_trace(tmp_path / "t.bin", n=N + 123)
    tt.replay_file(p, wire=wire, resident_cache=True, **GEO, **CPU)
    key = key_of(p)
    ent = residency.store().lookup_pin(key, n_run=N + 123)
    assert ent is not None, "stage-through did not publish"
    residency.store().unpin(key)
    packed = str(tmp_path / "direct.pack")
    meta = tt.pack_file(p, packed, wire=wire, feed_workers=2, **GEO)
    direct, n_run, _ = tt.stage_resident(packed, meta, 1 << 10,
                                         batch_windows=4, **CPU)
    assert n_run == N + 123 == ent.n_run and ent.n_lines == meta["n_lines"]
    assert torch.equal(ent.value, direct)
    assert ent.nbytes == direct.nbytes == ent.value.shape[0] * (4 << 10) * 3
    # and both equal the JAX package's staging of its own pack
    jpacked = str(tmp_path / "j.pack")
    jmeta = jt.pack_file(p, jpacked, wire=wire, **GEO)
    jdirect, _, _ = jt.stage_resident(jpacked, jmeta, 1 << 10,
                                      batch_windows=4)
    np.testing.assert_array_equal(direct.numpy(), np.asarray(jdirect))


def test_tiny_budget_streams_and_publishes_nothing(tmp_path):
    p = mk_trace(tmp_path / "t.bin")
    want = jt.replay_file(p, **GEO)
    residency.reset(budget=1024)
    small = tt.replay_file(p, resident_cache=True, **GEO, **CPU)
    same(small, want)
    assert small.timing["resident"] == "fallback"
    assert len(residency.store()) == 0


def test_table_past_2_24_lines_abandons_the_copy(tmp_path):
    n = (1 << 24) // 1024 + 64
    p = str(tmp_path / "t.bin")
    (np.arange(n, dtype=np.int64) * 4096 * 64).astype("<u8").tofile(p)
    kw = dict(window=512, batch_windows=8, wire="pack")
    rep = tt.replay_file(p, resident_cache=True, **kw, **CPU)
    assert rep.timing["resident"] == "abandoned"
    assert len(residency.store()) == 0
    same(rep, jt.replay_file(p, **kw))


def test_interrupted_resumed_and_truncated_runs_never_publish(tmp_path,
                                                              monkeypatch):
    window, bw = 1 << 8, 2
    p = mk_trace(tmp_path / "t.bin", n=bw * window * 8, hi=1 << 9, seed=59)
    kw = dict(window=window, batch_windows=bw, resident_cache=True, **CPU)
    ckpt = str(tmp_path / "t.ckpt.npz")
    real = tt._extent_reader

    def reader(path, batch_, n_):
        read = real(path, batch_, n_)

        def read_or_fail(b):
            if b == 5:
                raise DataLoss("injected read fault")
            return read(b)
        return read_or_fail

    with monkeypatch.context() as m:
        m.setattr(tt, "_extent_reader", reader)
        with pytest.raises(DataLoss):
            tt.replay_file(p, checkpoint_path=ckpt, checkpoint_every=1, **kw)
        with pytest.raises(DataLoss):   # a faulted stream publishes nothing
            tt.replay_file(p, **kw)
    resumed = tt.replay_file(p, checkpoint_path=ckpt, resume=True, **kw)
    assert len(residency.store()) == 0
    assert "resident" not in resumed.timing
    trunc = tt.replay_file(p, deadline_s=0.0, **kw)
    assert trunc.total_count == bw * window
    assert trunc.timing["resident"] == "truncated"
    assert len(residency.store()) == 0
    tt.replay_file(p, **kw)
    warm = tt.replay_file(p, **kw)
    assert warm.timing["resident"] == "hit"
    same(warm, resumed)
    same(warm, jt.replay_file(p, window=window, batch_windows=bw))


def test_limit_refs_is_part_of_the_identity(tmp_path):
    p = mk_trace(tmp_path / "t.bin", far=True)
    tt.replay_file(p, resident_cache=True, limit_refs=9000, **GEO, **CPU)
    full = tt.replay_file(p, resident_cache=True, **GEO, **CPU)
    assert full.timing["resident"] == "stage_through"   # a prefix missed
    same(full, jt.replay_file(p, **GEO))
    hit = tt.replay_file(p, resident_cache=True, limit_refs=9000, **GEO,
                         **CPU)
    same(hit, jt.replay_file(p, limit_refs=9000, **GEO))


def test_resident_cache_kwarg_typed(tmp_path):
    p = mk_trace(tmp_path / "t.bin", n=200)
    for bad in ("yes", 1):
        with pytest.raises(ValueError, match="resident_cache"):
            tt.replay_file(p, resident_cache=bad, **CPU)


def test_ensure_resident_publishes_then_hits(tmp_path):
    p = mk_trace(tmp_path / "t.bin")
    e1 = tt.ensure_resident(p, window=1 << 10, feed_workers=2, **CPU)
    assert e1.meta["published"] and len(residency.store()) == 1
    assert e1.meta["packed"] == p + ".pack" and e1.n_run == N
    e2 = tt.ensure_resident(p, window=1 << 10, **CPU)
    assert e2 is e1, "the second call staged again instead of hitting"
    # replay_file at the same geometry hits the published entry
    hit = tt.replay_file(p, window=1 << 10, resident_cache=True, **CPU)
    assert hit.timing["resident"] == "hit"
    same(hit, jt.replay_file(p, window=1 << 10))
    residency.reset(budget=128)
    with pytest.raises(ResourceExhausted, match="device budget") as ei:
        tt.ensure_resident(p, window=1 << 10, **CPU)
    assert ei.value.degradable


def test_upload_budget_keeps_a_staged_prefix(tmp_path):
    """A zero budget stops the upload at the first 16-batch mark: the
    replay covers 16 batches, as the JAX package's does, and
    ``ensure_resident`` returns that prefix unpublished."""
    window = 1 << 8
    p = mk_trace(tmp_path / "t.bin", n=20 * window + 17, hi=1 << 9)
    packed = str(tmp_path / "t.pack")
    kw = dict(window=window, batch_windows=1)
    meta = tt.pack_file(p, packed, **kw)
    stats = {}
    got = tt.replay_resident(packed, meta, upload_budget_s=0.0, stats=stats,
                             **kw, **CPU)
    want = jt.replay_resident(packed, meta, upload_budget_s=0.0, **kw)
    same(got, want)
    assert got.total_count == stats["refs"] == 16 * window
    assert stats["upload_bytes"] == 16 * window * 3
    np.testing.assert_array_equal(
        got.hist, tt.replay_file(p, limit_refs=16 * window, **kw,
                                 **CPU).hist)
    ent = tt.ensure_resident(p, upload_budget_s=0.0, packed_path=packed,
                             **kw, **CPU)
    assert not ent.meta["published"] and ent.n_run == 16 * window
    assert len(residency.store()) == 0


def test_replay_staged_clock0_and_int64_positions(tmp_path):
    """``clock0`` shifts every position and changes nothing; past 2^31 - 2
    the positions are int64 and still change nothing."""
    p = mk_trace(tmp_path / "t.bin", far=True)
    packed = str(tmp_path / "t.pack")
    meta = tt.pack_file(p, packed, wire="d24v", **GEO)
    resident, n_run, _ = tt.stage_resident(packed, meta, 1 << 10,
                                           batch_windows=4, **CPU)
    want = jt.replay_file(p, **GEO)
    for clock0 in (0, 1, 2, (1 << 31) - 3, 5 << 31):
        for seg in (None, False):
            stats = {}
            got = tt.replay_staged(resident, meta["n_lines"], n_run,
                                   1 << 10, clock0=clock0, stats=stats,
                                   segmented=seg)
            same(got, want)
            assert stats["refs"] == N and stats["replay_s"] > 0
    assert tt._pos_dtype(5, 4 << 10, (1 << 31) - 3) == torch.int64
    assert tt._pos_dtype(5, 4 << 10, 0) == torch.int32
    with pytest.raises(ValueError, match="windows of"):
        tt.replay_staged(resident, meta["n_lines"], n_run, 1 << 9)
    # an empty stage
    empty = tt.replay_resident(packed, meta, limit_refs=0, **GEO, **CPU)
    assert empty.total_count == 0 and not empty.hist.any()


# --- the legacy per-window scan ---------------------------------------------

@pytest.mark.parametrize("case", [
    # wire, window, batch windows, refs, initial capacity, far region
    ("pack", 2048, 1, 5 * 2048 + 300, 1 << 10, True),
    ("d24v", 1024, 4, 3 * 4096 + 777, 1 << 8, True),
    ("d24v", 2048, 1, 4 * 2048, 1 << 20, False),
    ("pack", 1024, 4, 2 * 4096 + 1, 1 << 6, False),
], ids=["pack-bw1-growth-far", "d24v-bw4-growth-far", "d24v-bw1-exact",
        "pack-bw4-tiny-cap"])
def test_legacy_scan_equals_segmented_and_jax(tmp_path, case):
    wire, window, bw, n, cap, far = case
    p = mk_trace(tmp_path / "t.bin", n=n, hi=1 << 13, seed=1, far=far)
    kw = dict(window=window, batch_windows=bw)
    want = jt.replay_file(p, wire=wire, initial_capacity=cap, **kw)
    seg = tt.replay_file(p, wire=wire, initial_capacity=cap, **kw, **CPU)
    scan = tt.replay_file(p, wire=wire, initial_capacity=cap,
                          segmented=False, **kw, **CPU)
    same(seg, want)
    same(scan, want)
    same(tt.replay_file(p, wire=wire, segmented=True, **kw, **CPU), want)
    addrs = np.fromfile(p, dtype="<u8").astype(np.int64)
    same(tt.replay(addrs, segmented=False, **kw, **CPU),
         jt.replay(addrs, segmented=False, **kw))
    packed = str(tmp_path / "t.pack")
    meta = tt.pack_file(p, packed, wire=wire, **kw)
    same(tt.replay_resident(packed, meta, segmented=False, **kw, **CPU),
         want)


def test_legacy_scan_bins_once_per_window(tmp_path):
    """The scan runs one histogram per window (padding windows included),
    the segmented batch one per batch."""
    p = mk_trace(tmp_path / "t.bin", n=3 * 4096 + 5)
    calls = []

    def hist(*args):
        calls.append(args[0].numel())
        return tt.KERNELS.histogram(*args)

    kernels = tt.TraceKernels(hist, tt.KERNELS.decode)
    tt.replay_file(p, segmented=False, _kernels=kernels, **GEO, **CPU)
    assert calls == [1 << 10] * 16
    calls.clear()
    tt.replay_file(p, _kernels=kernels, **GEO, **CPU)
    assert calls == [4 << 10] * 4


# --- the CLI ----------------------------------------------------------------

def test_cli_resident_cache_prints_the_jax_block(tmp_path, capsys):
    p = mk_trace(tmp_path / "t.bin", far=True)
    out = str(tmp_path / "mrc.csv")
    args = ["trace", "--cpu", "--file", p, "--out", out, "--window", "1024",
            "--batch-windows", "4"]
    jax_cli.main(args + ["--resident-cache"])
    want, want_csv = capsys.readouterr().out, open(out).read()
    for flag in ("--resident-cache", "--no-resident-cache"):
        assert cli.main(args + [flag]) == 0
        cap = capsys.readouterr()
        assert cap.out.startswith("TORCH CPU TRACE: ")
        assert cap.out.splitlines()[1:] == want.splitlines()[1:]
        assert open(out).read() == want_csv
    assert "resident cache off" in cap.err
    assert len(residency.store()) == 1
