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
