"""The port's work-stealing dispatch against the JAX package's, on the CPU.

Mirrors tests/test_steal.py: the dispatchers' own semantics (every chunk
once, steals from stragglers, seeds permute the deal only, a worker's
error propagates, the queue dispatcher never deadlocks); steal seeds
permute the schedule of ``shard_run``, never its result; the steal
telemetry; the segmented ``batch_events`` on unsorted streams against
``pluss.ops.reuse.batch_events``; the sharded trace replay against
``pluss.trace``'s; sweep groups of several devices with the elastic
requeue; the thread-safe kernel launch counters.
"""

import threading
import time

import numpy as np
import pytest
import torch

from pluss import trace as jax_trace
from pluss.ops import reuse as jax_reuse
from pluss_torch import engine, obs, trace
from pluss_torch.config import SamplerConfig
from pluss_torch.ops import build
from pluss_torch.ops.reuse import batch_events
from pluss_torch.parallel.shard import shard_run
from pluss_torch.parallel.steal import QueueDispatcher, StealDispatcher
from tests.test_torch_engine import carried


def assert_same(a, b, what=""):
    assert a.max_iteration_count == b.max_iteration_count, what
    np.testing.assert_array_equal(a.noshare_dense, b.noshare_dense,
                                  err_msg=what)
    assert a.share_raw == b.share_raw, what


# ---------------------------------------------------------------------------
# the dispatchers (pure host)


@pytest.mark.parametrize("n_chunks,n_workers", [(13, 4), (3, 8), (1, 2),
                                                (0, 3), (8, 1)])
def test_steal_dispatcher_runs_every_chunk_once(n_chunks, n_workers):
    ran = []
    stats = StealDispatcher(n_chunks, n_workers,
                            lambda wi, ci: ran.append(ci), seed=0).run()
    assert sorted(ran) == list(range(n_chunks))
    assert stats["chunks"] == n_chunks
    assert sum(stats["chunks_per_worker"]) == n_chunks


def test_steal_dispatcher_steals_from_stragglers():
    def run_chunk(wi, ci):
        time.sleep(0.05 if ci < 8 else 0.001)

    stats = StealDispatcher(16, 2, run_chunk, seed=0).run()
    assert stats["steals"] >= 1
    assert sorted(stats["ran_by"]) == list(range(16))


def test_steal_dispatcher_deal_matches_jax():
    from pluss.parallel.steal import StealDispatcher as JaxDispatcher

    for seed in range(4):
        ours = StealDispatcher(12, 3, lambda wi, ci: None, seed=seed)
        theirs = JaxDispatcher(12, 3, lambda wi, ci: None, seed=seed)
        assert [list(d) for d in ours._deques] \
            == [list(d) for d in theirs._deques]


def test_steal_dispatcher_seed_permutes_schedule_only():
    deals = set()
    for seed in range(4):
        done = []
        disp = StealDispatcher(12, 3, lambda wi, ci: done.append(ci),
                               seed=seed)
        deals.add(tuple(tuple(d) for d in disp._deques))
        disp.run()
        assert sorted(done) == list(range(12))
    assert len(deals) >= 2


def test_steal_dispatcher_propagates_worker_error():
    def boom(wi, ci):
        if ci == 5:
            raise RuntimeError("chunk 5 died")

    with pytest.raises(RuntimeError, match="chunk 5"):
        StealDispatcher(8, 2, boom, seed=0).run()


def test_queue_dispatcher_pulls_and_counts_steals():
    done = []
    stats = QueueDispatcher(2, lambda wi, ci, p: done.append(ci),
                            depth=2).run(((i, None) for i in range(9)), 9)
    assert sorted(done) == list(range(9))
    assert stats["chunks"] == 9


def test_queue_dispatcher_error_does_not_deadlock():
    def boom(wi, ci, payload):
        if ci == 1:
            raise ValueError("chunk 1 died")
        time.sleep(0.01)

    with pytest.raises(ValueError, match="chunk 1"):
        QueueDispatcher(2, boom, depth=1).run(((i, None) for i in range(50)),
                                              50)


def test_queue_dispatcher_producer_error_propagates():
    def produce():
        yield 0, None
        raise OSError("feed died")

    with pytest.raises(OSError, match="feed died"):
        QueueDispatcher(2, lambda wi, ci, p: None, depth=2).run(produce(), 2)


# ---------------------------------------------------------------------------
# shard_run under stealing


@pytest.mark.parametrize("model,n,ckw", [("gemm", 16, {"cls": 8}),
                                         ("cholesky", 16, {"cls": 8}),
                                         ("syrk_tri", 16, {})])
def test_steal_seeds_permute_the_schedule_not_the_result(model, n, ckw):
    spec, cfg = carried(model, n), SamplerConfig(**ckw)
    want = engine.run(spec, cfg, device="cpu")
    maps = []
    for seed in range(4):
        got = shard_run(spec, cfg, devices=["cpu"] * 4, dispatch="steal",
                        steal_seed=seed, window_accesses=1)
        assert_same(want, got, f"seed {seed}")
        maps.append(got.dispatch_stats["ran_by"])
    assert len({tuple(sorted(m.items())) for m in maps}) >= 2


def test_steal_worker_error_propagates(monkeypatch):
    from pluss_torch.parallel import shard

    real = shard._nest_results
    calls = []

    def flaky(nd, w_ids, segmented):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("a worker's chunk died")
        return real(nd, w_ids, segmented)

    monkeypatch.setattr(shard, "_nest_results", flaky)
    with pytest.raises(RuntimeError, match="chunk died"):
        shard_run(carried("gemm", 16), SamplerConfig(cls=8),
                  devices=["cpu"] * 4, dispatch="steal", window_accesses=1)


def test_steal_counters_and_busy_gauges_land(tmp_path):
    obs.configure(str(tmp_path / "t.jsonl"))
    try:
        shard_run(carried("gemm", 16), SamplerConfig(cls=8),
                  devices=["cpu"] * 4, dispatch="steal")
        c, g = obs.counters(), obs.gauges()
        assert c.get("shard.chunks", 0) >= 1 and "shard.steals" in c
        assert c.get("engine.refs_processed", 0) > 0
        assert any(k.startswith("shard.device_busy_frac.") for k in g)
    finally:
        obs.configure(None)


def test_stats_renders_the_shard_block(tmp_path, capsys):
    from pluss import cli as jax_cli
    from pluss_torch import cli

    ev = str(tmp_path / "t.jsonl")
    obs.configure(ev)
    try:
        shard_run(carried("gemm", 16), SamplerConfig(cls=8),
                  devices=["cpu"] * 2, dispatch="steal")
    finally:
        obs.configure(None)
    assert cli.main(["stats", ev]) == 0
    got = capsys.readouterr().out
    assert "shard scale-out:" in got and "chunks dispatched" in got
    jax_cli.main(["stats", ev])
    assert capsys.readouterr().out == got


# ---------------------------------------------------------------------------
# the segmented extraction on unsorted streams


@pytest.mark.parametrize("pdt", [np.int32, np.int64])
@pytest.mark.parametrize("seed", [0, 1])
def test_batch_events_unsorted_matches_jax(pdt, seed):
    rng = np.random.default_rng(seed)
    n, L = 6000, 300
    line = rng.integers(0, L, n).astype(np.int32)
    base = (1 << 33) if pdt == np.int64 else 1000
    pos = (base + rng.permutation(n)).astype(pdt)
    valid = rng.random(n) < 0.9
    span = rng.choice([0, 5, 40, 900], n).astype(np.int32)
    carry = np.where(rng.random(L) < 0.5, base - rng.integers(1, 500, L),
                     -1).astype(pdt)
    import jax.numpy as jnp

    ev_j, lp_j = jax_reuse.batch_events(
        jnp.asarray(line), jnp.asarray(pos), jnp.asarray(valid),
        jnp.asarray(carry), span=jnp.asarray(span), pos_sorted=False)
    last_pos = torch.from_numpy(np.concatenate([carry, [-1]]).astype(pdt))
    ev = batch_events(torch.from_numpy(line), torch.from_numpy(pos),
                      torch.from_numpy(valid), last_pos,
                      span=torch.from_numpy(span), pos_sorted=False)
    for k in ("reuse", "is_evt", "share", "cold"):
        np.testing.assert_array_equal(ev[k].numpy(), np.asarray(ev_j[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(ev["key"].numpy(), np.asarray(ev_j["key"]))
    np.testing.assert_array_equal(ev["pos"].numpy(), np.asarray(ev_j["pos"]))
    np.testing.assert_array_equal(last_pos[:-1].numpy(), np.asarray(lp_j))
    assert ev["reuse"].dtype == torch.from_numpy(pos).dtype
    assert int(ev["share"].sum()) > 0 and int(ev["cold"].sum()) > 0


# ---------------------------------------------------------------------------
# the sharded trace replay


def _write_trace(path, lines, shift=6):
    (np.asarray(lines, np.uint64) << np.uint64(shift)).astype(
        "<u8").tofile(path)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("dispatch", ["steal", "static"])
def test_trace_shard_replay_file_matches_jax(tmp_path, D, dispatch):
    rng = np.random.default_rng(11)
    p = str(tmp_path / "t.bin")
    _write_trace(p, rng.integers(0, 5000, 40_000, dtype=np.int64))
    want = jax_trace.replay_file(p, window=1 << 9)
    got = trace.shard_replay_file(p, window=1 << 9, batch_windows=2,
                                  dispatch=dispatch, devices=["cpu"] * D)
    assert got.hist.tolist() == want.hist.tolist()
    assert got.total_count == want.total_count


@pytest.mark.parametrize("dispatch", ["steal", "static"])
def test_trace_steal_sparse_clusters_and_ragged_tail(tmp_path, dispatch):
    rng = np.random.default_rng(12)
    p = str(tmp_path / "t.bin")
    _write_trace(p, np.concatenate([
        rng.integers(0, 4096, 20_000, dtype=np.int64),
        (1 << 40) + rng.integers(0, 4096, 12_345, dtype=np.int64)]))
    want = jax_trace.shard_replay_file(p, window=1 << 9, batch_windows=3,
                                       dispatch=dispatch)
    got = trace.shard_replay_file(p, window=1 << 9, batch_windows=3,
                                  dispatch=dispatch, devices=["cpu"] * 3)
    assert got.hist.tolist() == want.hist.tolist()
    assert got.total_count == want.total_count


def test_trace_shard_replay_in_memory_matches_jax():
    rng = np.random.default_rng(3)
    addrs = rng.integers(0, 1 << 20, 30_000).astype(np.int64) * 64
    want = jax_trace.shard_replay(addrs, window=1 << 10)
    for D in (1, 3):
        got = trace.shard_replay(addrs, window=1 << 10, devices=["cpu"] * D)
        assert got.hist.tolist() == want.hist.tolist()
        assert (got.total_count, got.n_lines) == (want.total_count,
                                                  want.n_lines)


def test_trace_checkpoint_pins_static_dispatch(tmp_path, capsys):
    rng = np.random.default_rng(13)
    p = str(tmp_path / "t.bin")
    _write_trace(p, rng.integers(0, 3000, 20_000, dtype=np.int64))
    ck = str(tmp_path / "ck")
    want = jax_trace.replay_file(p, window=1 << 9)
    got = trace.shard_replay_file(p, window=1 << 9, batch_windows=2,
                                  dispatch="steal", checkpoint_path=ck,
                                  devices=["cpu"] * 2)
    assert got.hist.tolist() == want.hist.tolist()
    assert "static" in capsys.readouterr().err


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_trace_shard_checkpoint_resumes_across_packages(tmp_path, writer):
    from pluss.resilience import faults as jax_faults
    from pluss_torch.resilience import faults

    rng = np.random.default_rng(14)
    p = str(tmp_path / "t.bin")
    _write_trace(p, np.concatenate([
        rng.integers(0, 4096, 20_000, dtype=np.int64),
        (1 << 40) + rng.integers(0, 4096, 12_345, dtype=np.int64)]))
    want = jax_trace.replay_file(p, window=1 << 9)
    ck = str(tmp_path / "ck")
    kw = dict(window=1 << 9, batch_windows=1, checkpoint_path=ck,
              dispatch="static")
    # 8 devices, 8 steps of one window each: a read fault in step 2
    # leaves the checkpoint written after steps 1 and 2... of the writer
    if writer == "jax":
        jax_faults.install(jax_faults.FaultPlan.parse("trace_loss@20"))
        with pytest.raises(Exception, match="lost"):
            jax_trace.shard_replay_file(p, checkpoint_every=1, **kw)
        jax_faults.install(None)
        got = trace.shard_replay_file(p, resume=True, devices=["cpu"] * 8,
                                      **kw)
    else:
        faults.install(faults.FaultPlan.parse("trace_loss@20"))
        try:
            with pytest.raises(Exception, match="lost"):
                trace.shard_replay_file(p, checkpoint_every=1,
                                        devices=["cpu"] * 8, **kw)
        finally:
            faults.install(None)
        got = jax_trace.shard_replay_file(p, resume=True, **kw)
    assert got.hist.tolist() == want.hist.tolist()
    assert not (tmp_path / "ck").exists()   # a finished run retires it


def test_trace_shard_resident_cache_hits_the_grouped_entry(tmp_path):
    from pluss_torch import residency

    rng = np.random.default_rng(15)
    p = str(tmp_path / "t.bin")
    _write_trace(p, rng.integers(0, 5000, 30_000, dtype=np.int64))
    want = jax_trace.replay_file(p, window=1 << 9)
    residency.reset()
    obs.configure(str(tmp_path / "ev.jsonl"))
    try:
        kw = dict(window=1 << 9, batch_windows=2, dispatch="steal",
                  devices=["cpu"] * 2, resident_cache=True)
        cold = trace.shard_replay_file(p, **kw)
        warm = trace.shard_replay_file(p, **kw)
        c = obs.counters()
    finally:
        obs.configure(None)
        residency.reset()
    assert cold.hist.tolist() == warm.hist.tolist() == want.hist.tolist()
    assert c.get("residency.stage_through") == 1
    assert c.get("residency.hit") == 1


# ---------------------------------------------------------------------------
# sweep groups of several devices, the elastic requeue


def test_sweep_groups_of_two_equal_the_serial_sweep():
    from pluss_torch import sweep

    spec = carried("gemm", 12)
    kw = dict(thread_nums=(1, 2, 4), chunk_sizes=(4,), device="cpu")
    grouped = sweep.sweep(spec, device_groups=2, devices=["cpu"] * 4, **kw)
    for a, b in zip(grouped, sweep.sweep(spec, **kw)):
        assert a.cfg == b.cfg and a.total_refs == b.total_refs
        np.testing.assert_array_equal(a.curve, b.curve)


def test_sweep_elastic_requeue_on_worker_death(tmp_path, monkeypatch):
    import pluss_torch.resilience as res_mod
    from pluss_torch import sweep
    from pluss_torch.resilience.errors import PlussError

    real = res_mod.run_resilient
    died = {"n": 0, "backends": set()}

    def flaky(spec, cfg, **kw):
        died["backends"].add(kw.get("backend", "vmap"))
        if cfg.thread_num == 2 and died["n"] == 0:
            died["n"] += 1
            raise PlussError("injected worker death", site="test.sweep")
        return real(spec, cfg, **kw)

    monkeypatch.setattr(res_mod, "run_resilient", flaky)
    obs.configure(str(tmp_path / "t.jsonl"))
    try:
        spec = carried("gemm", 16)
        pts = sweep.sweep(spec, (1, 2, 4), (2,), SamplerConfig(),
                          journal=str(tmp_path / "j.jsonl"),
                          device_groups=2, device="cpu",
                          devices=["cpu"] * 4)
        c = obs.counters()
    finally:
        obs.configure(None)
    assert died["n"] == 1 and died["backends"] == {"shard"}
    assert c.get("sweep.elastic_requeues", 0) >= 1
    clean = sweep.sweep(spec, (1, 2, 4), (2,), SamplerConfig(), device="cpu")
    for a, b in zip(clean, pts):
        np.testing.assert_array_equal(a.curve, b.curve)


# ---------------------------------------------------------------------------
# the kernel launch counters under concurrent launches


def test_launch_counter_counts_every_launch_from_eight_threads():
    """A fake launch from 8 threads x 1000 calls, the interpreter switching
    threads as often as it can: every launch counts."""
    import sys

    class Fake:
        launches = 0

    def launch_many():
        for _ in range(1000):
            build.count_launch(Fake)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch_many) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert Fake.launches == 8000


def test_wrappers_count_through_the_lock(monkeypatch):
    """The three kernel wrappers count their launches through
    ``build.count_launch``, not an unlocked ``+= 1``."""
    import inspect

    from pluss_torch.ops import decode, event_hist

    for src in (inspect.getsource(event_hist._launch),
                inspect.getsource(event_hist._launch_masked),
                inspect.getsource(decode._launch)):
        assert "build.count_launch(" in src and "launches +=" not in src
