"""The port's multi-process layer on gloo CPU processes.

Mirrors tests/test_multihost.py: D processes bring up one
``torch.distributed`` process group (gloo, a ``file://`` rendezvous in
the test's temp dir), each runs ``shard_run`` in the static dispatch on
its own CPU segment, and rank 0's result must equal ``pluss.engine.run``
bit for bit.  Each test has its own time limit; ranks that outlive it
are killed.  Then: ``watched_shard_run`` salvages a run whose peer was
killed by the ``kill_worker`` fault, ``initialize`` retries through the
``collective`` fault, the shard ladder walks JAX's rungs, and serve's
heartbeat exporter publishes the workers' heartbeat ages.
"""

import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from pluss import engine as jax_engine
from pluss import models as jax_models
from pluss import resilience as jax_res
from pluss.config import SamplerConfig as JaxConfig
from pluss.parallel import default_mesh
from pluss.resilience import faults as jax_faults
from pluss.resilience.ladder import Retry as JaxRetry
from pluss_torch import obs
from pluss_torch.config import SamplerConfig
from pluss_torch.parallel import multihost
from pluss_torch.resilience import (CollectiveError, FaultPlan, Retry,
                                    run_resilient)
from pluss_torch.resilience import faults
from pluss_torch.resilience.ladder import SHARD_LADDER
from tests.test_torch_engine import carried

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: one rank: join the group, run the static shard_run of (model, n) on its
#: CPU segment, write the result (or the salvage's) to out.<rank>
RANK = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
from pluss_torch.config import SamplerConfig
from pluss_torch.models import REGISTRY
from pluss_torch.parallel import multihost
from pluss_torch.parallel.shard import shard_run
rdv, world, rank, model, n, wa, out, mode = sys.argv[2:10]
world, rank, n = int(world), int(rank), int(n)
kw = {"window_accesses": int(wa)} if wa != "-" else {}
multihost.initialize(rdv, world, rank, device="cpu", connect_timeout_s=60)
spec, cfg = REGISTRY[model](n), SamplerConfig(cls=8)
if mode == "watched":
    hb = os.path.join(os.path.dirname(out), "hb")
    multihost.start_heartbeat(hb, rank, interval_s=0.1)
    if rank:
        time.sleep(60)   # killed at its first beat by the fault plan
    res = multihost.watched_shard_run(
        spec, cfg, devices=multihost.global_devices("cpu"), hb_dir=hb,
        num_processes=world, timeout_s=60, stale_s=1.0,
        first_beat_timeout_s=20, dispatch="static", **kw)
else:
    res = shard_run(spec, cfg, devices=multihost.global_devices("cpu"),
                    dispatch="static", **kw)
doc = {"count": res.max_iteration_count, "hist": res.noshare_dense.tolist(),
       "share": [{str(k): v for k, v in d.items()} for d in res.share_raw],
       "degradations": list(res.degradations), "stats": res.dispatch_stats}
json.dump(doc, open(f"{out}.{rank}", "w"))
sys.stdout.flush()
os._exit(0)   # a watched run abandons a broken collective: no teardown
"""


def run_ranks(tmp_path, world: int, model: str, n: int, wa=None,
              mode: str = "plain", env_of=None, limit_s: float = 240.0):
    """Start ``world`` ranks and wait for them within ``limit_s``; returns
    (exit codes, documents by rank)."""
    script = tmp_path / "rank.py"
    script.write_text(RANK)
    out = str(tmp_path / "out")
    rdv = f"file://{tmp_path / 'rendezvous'}"
    logs, procs = [], []
    try:
        for r in range(world):
            env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
            env.pop("PLUSS_FAULT_PLAN", None)
            if env_of is not None:
                env.update(env_of(r))
            logs.append(open(tmp_path / f"rank{r}.log", "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, str(script), REPO, rdv, str(world), str(r),
                 model, str(n), "-" if wa is None else str(wa), out, mode],
                env=env, stdout=logs[r], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + limit_s
        rcs = []
        for p, lg in zip(procs, logs):
            try:
                rcs.append(p.wait(timeout=max(1.0, deadline
                                              - time.monotonic())))
            except subprocess.TimeoutExpired:
                lg.seek(0)
                pytest.fail(f"a rank outlived {limit_s} s:\n"
                            f"{lg.read()[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        texts = []
        for lg in logs:
            lg.seek(0)
            texts.append(lg.read())
            lg.close()
    docs = {r: json.load(open(f"{out}.{r}")) for r in range(world)
            if os.path.exists(f"{out}.{r}")}
    return rcs, docs, texts


def assert_doc_equals_engine(doc, model: str, n: int, wa=None):
    kw = {} if wa is None else {"window_accesses": wa}
    want = jax_engine.run(jax_models.REGISTRY[model](n), JaxConfig(cls=8),
                          **kw)
    assert doc["count"] == want.max_iteration_count
    assert doc["hist"] == want.noshare_dense.tolist()
    assert doc["share"] == [{str(k): v for k, v in d.items()}
                            for d in want.share_raw]


@pytest.mark.parametrize("world,model,n,wa", [
    (2, "gemm", 16, 1),
    (4, "trmm", 16, 1),
    (4, "2mm", 8, None),
])
def test_process_group_static_shard_run_equals_engine(tmp_path, world,
                                                      model, n, wa):
    rcs, docs, logs = run_ranks(tmp_path, world, model, n, wa)
    assert rcs == [0] * world, logs
    for r in range(world):
        assert docs[r]["stats"] == {"dispatch": "static", "devices": world}
        assert_doc_equals_engine(docs[r], model, n, wa)


@pytest.mark.slow   # eight processes: the D = 8 point of the matrix
def test_process_group_of_eight_equals_engine(tmp_path):
    rcs, docs, logs = run_ranks(tmp_path, 8, "cholesky", 16, 1,
                                limit_s=400.0)
    assert rcs == [0] * 8, logs
    assert_doc_equals_engine(docs[0], "cholesky", 16, 1)


def test_watched_shard_run_salvages_a_killed_worker(tmp_path):
    """Rank 1 dies at its first heartbeat (``kill_worker@1``); rank 0's
    watchdog sees its beat go stale, abandons the collective and salvages
    the run in a clean subprocess: stamped, equal to the engine."""
    env_of = lambda r: {"PLUSS_FAULT_PLAN": "kill_worker@1"} if r else {}
    rcs, docs, logs = run_ranks(tmp_path, 2, "gemm", 16, 1, mode="watched",
                                env_of=env_of, limit_s=180.0)
    assert rcs == [0, 43], logs
    doc = docs[0]
    assert doc["degradations"] == ["worker_died:1", "local_salvage"], logs
    assert_doc_equals_engine(doc, "gemm", 16, 1)


def test_watchdog_salvage_in_process(tmp_path, monkeypatch):
    """The watchdog path in one process: a peer's heartbeat that goes
    stale while the sharded call hangs is a death, counted, and the
    salvage subprocess recomputes the run."""
    from pluss_torch.parallel import shard

    hb = str(tmp_path / "hb")
    stop = multihost.start_heartbeat(hb, 0, interval_s=0.05)
    os.makedirs(hb, exist_ok=True)
    with open(os.path.join(hb, "hb.1.json"), "w") as f:
        f.write("{}")
    old = time.time() - 100
    os.utime(os.path.join(hb, "hb.1.json"), (old, old))
    monkeypatch.setattr(shard, "shard_run",
                        lambda *a, **k: time.sleep(30))
    obs.configure(str(tmp_path / "ev.jsonl"))
    try:
        res = multihost.watched_shard_run(
            carried("gemm", 8), SamplerConfig(cls=8), devices=["cpu"],
            hb_dir=hb, num_processes=2, stale_s=0.5, first_beat_timeout_s=5)
        c = obs.counters()
    finally:
        obs.configure(None)
        stop()
    assert res.degradations == ("worker_died:1", "local_salvage")
    assert c["multihost.worker_deaths"] == 1 and c["multihost.salvages"] == 1
    want = jax_engine.run(jax_models.REGISTRY["gemm"](8), JaxConfig(cls=8))
    np.testing.assert_array_equal(res.noshare_dense, want.noshare_dense)
    assert res.share_raw == want.share_raw


def test_dead_workers_and_heartbeat_gauges(tmp_path):
    hb = str(tmp_path / "hb")
    stop = multihost.start_heartbeat(hb, 0, interval_s=0.05)
    try:
        time.sleep(0.2)
        assert multihost.dead_workers(hb, 2, stale_s=5.0) == [1]
        assert multihost.dead_workers(hb, 1, stale_s=5.0) == []
    finally:
        stop()
    time.sleep(0.3)
    assert multihost.dead_workers(hb, 1, stale_s=0.1) == [0]


def test_initialize_retries_through_the_collective_fault(tmp_path, capsys):
    import torch.distributed as dist

    faults.install(FaultPlan.parse("collective"))
    obs.configure(str(tmp_path / "ev.jsonl"))
    try:
        multihost.initialize(f"file://{tmp_path / 'rdv'}", 1, 0,
                             device="cpu", backoff_s=0.0)
        c = obs.counters()
        assert dist.is_initialized() and multihost.process_count() == 1
        assert multihost.is_coordinator()
        from pluss_torch.parallel.shard import shard_run

        # a group of one: the static run exchanges through the group
        got = shard_run(carried("gemm", 16), SamplerConfig(cls=8),
                        devices=["cpu"], dispatch="static",
                        window_accesses=1)
    finally:
        faults.install(None)
        obs.configure(None)
        if dist.is_initialized():
            dist.destroy_process_group()
    assert c["multihost.init_attempts"] == 2
    assert "attempt 1/3 failed" in capsys.readouterr().out
    want = jax_engine.run(jax_models.REGISTRY["gemm"](16), JaxConfig(cls=8))
    np.testing.assert_array_equal(got.noshare_dense, want.noshare_dense)
    assert got.share_raw == want.share_raw


def test_initialize_failure_is_classified(tmp_path):
    import torch.distributed as dist

    faults.install(FaultPlan.parse("collective,collective@2"))
    try:
        with pytest.raises(CollectiveError, match="after 2 attempts") as ei:
            multihost.initialize(f"file://{tmp_path / 'rdv'}", 1, 0,
                                 device="cpu", max_retries=2, backoff_s=0.0)
    finally:
        faults.install(None)
    assert ei.value.site == "multihost.init"
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the shard ladder, against the JAX package's


@pytest.fixture()
def _plans():
    faults.install(None)
    jax_faults.install(None)
    yield
    faults.install(None)
    jax_faults.install(None)


@pytest.mark.parametrize("plan", ["shard_oom", "shard_oom,shard_oom@2",
                                  "shard_oom,shard_oom@2,shard_oom@3"])
def test_shard_ladder_walks_jax_rungs(plan, _plans):
    jax_faults.install(jax_faults.FaultPlan.parse(plan))
    want = jax_res.run_resilient(jax_models.REGISTRY["gemm"](16),
                                 JaxConfig(cls=8), backend="shard",
                                 mesh=default_mesh(2),
                                 retry=JaxRetry(backoff_s=0.0))
    faults.install(FaultPlan.parse(plan))
    got = run_resilient(carried("gemm", 16), SamplerConfig(cls=8),
                        backend="shard", devices=["cpu"] * 2,
                        retry=Retry(backoff_s=0.0))
    assert got.degradations == want.degradations
    # single_device runs engine.run, past the shard.run site: a third
    # shard_oom never fires
    assert got.degradations == SHARD_LADDER[:min(2, len(plan.split(",")))]
    np.testing.assert_array_equal(got.noshare_dense, want.noshare_dense)
    assert got.share_raw == want.share_raw


def test_serve_heartbeat_exporter_gauges(tmp_path):
    from pluss_torch.serve import ServeConfig, Server

    hb = str(tmp_path / "hb")
    stop = multihost.start_heartbeat(hb, 0, interval_s=0.05)
    obs.configure(str(tmp_path / "ev.jsonl"))
    srv = Server(socket_path=str(tmp_path / "s.sock"),
                 config=ServeConfig(heartbeat_dir=hb, num_processes=2,
                                    prom_refresh_s=0.1, device="cpu"))
    try:
        srv.start()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            g = obs.gauges()
            if "multihost.heartbeat_age_s.1" in g:
                break
            time.sleep(0.1)
        srv.shutdown()
        g = obs.gauges()
    finally:
        stop()
        obs.configure(None)
    assert g["multihost.heartbeat_age_s.1"] == -1.0
    assert 0 <= g["multihost.heartbeat_age_s.0"] < 5
    assert srv._hb_stop is not None


# ---------------------------------------------------------------------------
# the sharded trace replay in a process group

#: one rank of a sharded replay in a group: ``mode`` ``replay`` runs
#: ``shard_replay`` (raw and precompacted) and ``shard_replay_file``
#: (precompacted) and records the refusals; ``ckpt`` stops a checkpointed
#: ``shard_replay_file`` with a read fault and resumes it; ``cli`` runs
#: ``cli trace --backends shard`` in a directory of its own
REPLAY_RANK = r"""
import io, json, os, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
from pluss_torch import cli, trace
from pluss_torch.parallel import multihost
from pluss_torch.resilience import FaultPlan, faults
rdv, world, rank, raw_path, ids_path, out, mode, window = sys.argv[2:10]
world, rank, window = int(world), int(rank), int(window)
multihost.initialize(rdv, world, rank, device="cpu", connect_timeout_s=60)
devs = multihost.global_devices("cpu")
doc = {}
if mode == "replay":
    addrs = np.fromfile(raw_path, dtype="<u8").astype(np.int64)
    ids = np.fromfile(ids_path, dtype="<u8").astype(np.int64)
    for key, rep in (
            ("raw", trace.shard_replay(addrs, devices=devs, window=window)),
            ("ids", trace.shard_replay(ids, devices=devs, window=window,
                                       precompacted=True)),
            ("file", trace.shard_replay_file(
                ids_path, devices=devs, window=window, batch_windows=2,
                precompacted=True))):
        doc[key] = [rep.hist.tolist(), rep.total_count, rep.n_lines]
    for key, kw in (("not_precompacted", {}),
                    ("steal", {"precompacted": True, "dispatch": "steal"})):
        try:
            trace.shard_replay_file(ids_path, devices=devs, window=window,
                                    **kw)
            doc[key] = None
        except RuntimeError as e:
            doc[key] = str(e)
elif mode == "ckpt":
    ckpt = os.path.join(os.path.dirname(out), "shard.ckpt")
    kw = dict(devices=devs, window=window, batch_windows=2,
              precompacted=True, checkpoint_path=ckpt, checkpoint_every=4)
    faults.install(FaultPlan.parse(f"trace_loss@{9 * world + 1}"))
    try:
        trace.shard_replay_file(ids_path, **kw)
        doc["stopped"] = False
    except Exception as e:
        doc["stopped"] = type(e).__name__
    faults.install(None)
    # the next run starts once every rank has stopped (the coordinator's
    # last checkpoint written)
    import torch.distributed as dist
    dist.barrier()
    if rank == 0:
        import shutil
        for ext in ("", ".npz"):
            shutil.copy(ckpt + ext, ckpt + ".copy" + ext)
    with np.load(ckpt + ".npz") as z:
        doc["k_next"] = int(z["k_next"])
        doc["ckpt_rows"] = int(z["last_pos"].shape[0])
    rep = trace.shard_replay_file(ids_path, resume=True, **kw)
    doc["resumed"] = [rep.hist.tolist(), rep.total_count, rep.n_lines]
    dist.barrier()   # the coordinator retires the checkpoint after the merge
    doc["retired"] = not os.path.exists(ckpt)
else:
    work = f"{out}.cli{rank}"
    os.makedirs(work, exist_ok=True)
    os.chdir(work)
    so, se = io.StringIO(), io.StringIO()
    saved = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = so, se
    try:
        rc = cli.main(["trace", "--cpu", "--file", raw_path, "--backends",
                       "shard", "--window", str(window), "--journal", "j",
                       "--batch-windows", "2", "--out", "m.csv"])
    finally:
        sys.stdout, sys.stderr = saved
    doc = {"rc": rc, "stdout": so.getvalue(), "stderr": se.getvalue(),
           "csv": open("m.csv").read()}
json.dump(doc, open(f"{out}.{rank}", "w"))
sys.stdout.flush()
import torch.distributed as dist
dist.barrier()
dist.destroy_process_group()
"""

WINDOW = 256


@pytest.fixture()
def replay_trace(tmp_path):
    """A u64 trace of two far regions (the compactor's cluster probe) and
    its line ids as a precompacted trace."""
    from pluss_torch import trace as tt

    rng = np.random.default_rng(7)
    n = 40000
    near = rng.integers(0, 3000, n)
    far = rng.integers(0, 2000, n) + (1 << 40)
    addrs = np.where(rng.random(n) < 0.7, near, far).astype(np.int64) * 64 \
        + rng.integers(0, 64, n)
    raw, ids = tmp_path / "t.bin", tmp_path / "t.ids"
    addrs.astype("<u8").tofile(raw)
    tt.lines_of(addrs, 64).astype("<u8").tofile(ids)
    return addrs, str(raw), str(ids)


def run_replay_ranks(tmp_path, world: int, raw: str, ids: str, mode: str,
                     limit_s: float = 180.0):
    script = tmp_path / "replay_rank.py"
    script.write_text(REPLAY_RANK)
    out = str(tmp_path / f"{mode}_out")
    rdv = f"file://{tmp_path / f'rdv_{mode}'}"
    logs, procs = [], []
    try:
        for r in range(world):
            env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
            env.pop("PLUSS_FAULT_PLAN", None)
            logs.append(open(tmp_path / f"{mode}_rank{r}.log", "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, str(script), REPO, rdv, str(world), str(r),
                 raw, ids, out, mode, str(WINDOW)],
                env=env, stdout=logs[r], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + limit_s
        rcs = []
        for p, lg in zip(procs, logs):
            try:
                rcs.append(p.wait(timeout=max(1.0, deadline
                                              - time.monotonic())))
            except subprocess.TimeoutExpired:
                lg.seek(0)
                pytest.fail(f"a rank outlived {limit_s} s:\n"
                            f"{lg.read()[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        texts = []
        for lg in logs:
            lg.seek(0)
            texts.append(lg.read())
            lg.close()
    assert rcs == [0] * world, texts
    return [json.load(open(f"{out}.{r}")) for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_process_group_sharded_replay_equals_jax_replay(tmp_path,
                                                        replay_trace,
                                                        world):
    """``shard_replay`` (raw and precompacted) and ``shard_replay_file``
    (precompacted) on ``world`` gloo ranks: every rank's histogram equals
    ``pluss.trace.replay`` bit for bit, and the single-process port's table
    sizes; without ``precompacted`` the file replay raises JAX's error,
    and steal is refused in the group."""
    from pluss import trace as jax_trace
    from pluss_torch import trace as tt

    addrs, raw, ids = replay_trace
    want = jax_trace.replay(addrs, window=WINDOW)
    one_raw = tt.shard_replay(addrs, devices=["cpu"], window=WINDOW)
    one_file = tt.shard_replay_file(ids, devices=["cpu"] * world,
                                    window=WINDOW, batch_windows=2,
                                    precompacted=True, dispatch="static")
    docs = run_replay_ranks(tmp_path, world, raw, ids, "replay")
    for doc in docs:
        for key in ("raw", "ids", "file"):
            hist, count, _ = doc[key]
            assert hist == want.hist.tolist(), key
            assert count == len(addrs), key
        assert doc["raw"][2] == one_raw.n_lines
        assert doc["file"][2] == one_file.n_lines
        assert doc["not_precompacted"] == (
            "shard_replay_file needs precompacted ids under multi-process "
            "execution (per-process cluster discovery would diverge)")
        assert "dispatch='steal'" in doc["steal"]


def test_process_group_replay_checkpoint_resumes(tmp_path, replay_trace,
                                                 capsys):
    """A checkpointed ``shard_replay_file`` on two ranks, stopped by a read
    fault after its checkpoint at step 8: the coordinator wrote the whole
    group's carries (one row per segment), both ranks resume from it to
    the uninterrupted histogram, the finished run retires it, and the JAX
    package resumes a copy of it in one process."""
    from pluss import trace as jax_trace

    addrs, raw, ids = replay_trace
    want = jax_trace.replay(addrs, window=WINDOW)
    docs = run_replay_ranks(tmp_path, 2, raw, ids, "ckpt")
    for doc in docs:
        assert doc["stopped"] == "DataLoss"
        assert doc["k_next"] == 8 and doc["ckpt_rows"] == 2
        assert doc["resumed"][0] == want.hist.tolist()
        assert doc["resumed"][1] == len(addrs)
        assert doc["retired"]
    # the group's checkpoint is the single-process format: the JAX
    # package's static replay over two devices resumes it
    got = jax_trace.shard_replay_file(
        ids, mesh=default_mesh(2), window=WINDOW, batch_windows=2,
        precompacted=True, dispatch="static",
        checkpoint_path=str(tmp_path / "shard.ckpt.copy"), resume=True)
    assert "resuming sharded replay at call 8/" in capsys.readouterr().err
    np.testing.assert_array_equal(got.hist, want.hist)


def test_process_group_cli_trace_shard_prints_the_single_process_block(
        tmp_path, replay_trace):
    """``cli trace --backends shard`` on two gloo ranks: each rank prints
    the in-memory sharded replay's block (JAX's multi-process route), whose
    histogram and CSV are the single-process block's, and JAX's notices
    for ``--journal`` and ``--batch-windows``."""
    import torch

    from pluss_torch import cli as tcli
    from pluss_torch import trace as tt

    addrs, raw, ids = replay_trace
    single_dir = tmp_path / "single"
    single_dir.mkdir()
    cwd = os.getcwd()
    os.chdir(single_dir)
    try:
        buf = io.StringIO()
        saved = sys.stdout
        sys.stdout = buf
        try:
            assert tcli.main(["trace", "--cpu", "--file", raw, "--backends",
                              "shard", "--window", str(WINDOW), "--out",
                              "m.csv"]) == 0
        finally:
            sys.stdout = saved
        single = buf.getvalue().splitlines()
        single_csv = open("m.csv").read()
        mem = io.StringIO()
        tcli._trace_block(tt.shard_replay(addrs, devices=["cpu"],
                                          window=WINDOW),
                          0.0, SamplerConfig(), torch.device("cpu"), "m.csv",
                          mem)
        in_memory = mem.getvalue().splitlines()
    finally:
        os.chdir(cwd)
    assert in_memory[1:-1] == single[1:-1]
    docs = run_replay_ranks(tmp_path, 2, raw, ids, "cli")
    for doc in docs:
        assert doc["rc"] == 0
        lines = doc["stdout"].splitlines()
        assert lines[0].startswith("TORCH CPU TRACE: ")
        assert lines[1:] == in_memory[1:]
        assert doc["csv"] == single_csv
        assert ("pluss_torch: --resume/--journal have no effect on "
                "multi-process sharded replay") in doc["stderr"]
        assert ("pluss_torch: --batch-windows has no effect on the "
                "in-memory sharded replay") in doc["stderr"]
