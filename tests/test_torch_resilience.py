"""The port's resilience layer against the JAX package's, on the CPU.

``pluss_torch.resilience`` (classify, the fault plans, the degradation
ladders) is held against ``pluss.resilience``: the same raw failures
classify to the same types, the same plans fire in the same sequence, and
the same injected faults walk the same rungs to equal results.  Sizes are
small (n <= 16, traces of a few thousand refs); ``fast_retry`` takes the
backoff out.
"""

import gc
import os
import weakref

import numpy as np
import pytest
import torch

from pluss import engine as jax_engine
from pluss import models as jax_models
from pluss import resilience as jax_res
from pluss import trace as jax_trace
from pluss.config import SamplerConfig as JaxConfig
from pluss.resilience import faults as jax_faults
from pluss.resilience.ladder import Retry as JaxRetry
from pluss_torch import engine, resilience, trace
from pluss_torch.config import SamplerConfig
from pluss_torch.ops import build
from pluss_torch.resilience import (
    LADDER,
    CacheCorrupt,
    CollectiveError,
    CompileError,
    DataLoss,
    FaultPlan,
    PlussError,
    ResourceExhausted,
    Retry,
    classify,
    replay_file_resilient,
    run_resilient,
)
from pluss_torch.resilience import faults
from pluss_torch.resilience.ladder import (TRACE_LADDER, _resilient_loop,
                                           degradation_label)
from tests.test_torch_engine import carried

KW = {"cls": 8}


@pytest.fixture(autouse=True)
def _clean_fault_plans():
    """No test leaks an installed plan, of either package, into the next."""
    faults.install(None)
    jax_faults.install(None)
    yield
    faults.install(None)
    jax_faults.install(None)


@pytest.fixture()
def fast_retry():
    return Retry(backoff_s=0.0)


def same_result(got, want) -> None:
    np.testing.assert_array_equal(got.noshare_dense, want.noshare_dense)
    assert got.share_raw == want.share_raw
    assert got.max_iteration_count == want.max_iteration_count


# ---------------------------------------------------------------------------
# classify


CLASSIFY_CASES = [
    RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating 2.5G"),
    RuntimeError("XlaRuntimeError: RESOURCE_EXHAUSTED while running"),
    RuntimeError("nest 0: the sort window stream needs ~12.00 GiB ... "
                 "beyond the 8.00 GiB device budget."),
    RuntimeError("XLA compilation failed"),
    ConnectionError("refused"),
    TimeoutError("slow"),
    RuntimeError("coordination service went away"),
    MemoryError(),
    EOFError("short read"),
    ValueError("truncated u64 trace"),
    ValueError("no marker at all"),
]


@pytest.mark.parametrize("exc", CLASSIFY_CASES,
                         ids=lambda e: type(e).__name__ + ":" + str(e)[:24])
def test_classify_matches_jax(exc):
    got = classify(exc, site="engine.run")
    want = jax_res.classify(exc, site="engine.run")
    assert type(got).__name__ == type(want).__name__
    assert (got.retryable, got.degradable, got.fatal) \
        == (want.retryable, want.degradable, want.fatal)
    assert got.site == "engine.run" and got.__cause__ is exc \
        and got.cause is exc
    assert str(got) == str(want)


def test_classify_idempotent_on_pluss_errors():
    e = DataLoss("gone", site="trace.load")
    assert classify(e) is e
    e2 = CacheCorrupt("x")
    assert classify(e2, site="s") is e2 and e2.site == "s"
    assert isinstance(CollectiveError("x"), PlussError)


def test_classify_torch_out_of_memory_by_type():
    # by type, before the marker scan: the allocator's text is irrelevant
    e = classify(torch.OutOfMemoryError("allocator gave up"))
    assert isinstance(e, ResourceExhausted) and e.degradable
    assert torch.cuda.OutOfMemoryError is torch.OutOfMemoryError


def test_classify_the_engines_budget_guard():
    pl = engine.plan(carried("cholesky", 16), SamplerConfig(**KW))
    with pytest.raises(RuntimeError, match="device budget") as ei:
        engine.check_sort_budget(pl.nests, pl.spec, pl.cfg, pl.pos_dtype, 1)
    assert isinstance(classify(ei.value), ResourceExhausted)


def test_classify_a_failed_kernel_build(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "nvcc", lambda: str(tmp_path / "no-nvcc"))
    with pytest.raises(build.BuildError, match="native build failed") as ei:
        build.build("masked_hist")
    e = classify(ei.value, site="engine.compile")
    assert isinstance(e, CompileError) and e.degradable


# ---------------------------------------------------------------------------
# fault plans


def test_fault_plan_grammar_matches_jax():
    text = "oom, oom@2 ,corrupt_cache,kill_worker@1,trace_loss@3"
    assert FaultPlan.parse(text).describe() \
        == jax_faults.FaultPlan.parse(text).describe()
    for bad, needle in (("frobnicate", "unknown fault kind"),
                        ("oom@x", "occurrence"), ("oom@0", "occurrence")):
        with pytest.raises(ValueError, match=needle):
            FaultPlan.parse(bad)
        with pytest.raises(ValueError, match=needle):
            jax_faults.FaultPlan.parse(bad)


def test_share_cap_fault_is_refused():
    with pytest.raises(ValueError, match="no share cap"):
        FaultPlan.parse("oom,share_cap@2")


@pytest.mark.parametrize("seed", range(12))
def test_seeded_plans_match_jax(seed):
    want = [e for e in jax_faults.FaultPlan.random(seed, 3).describe()
            .split(",") if not e.startswith("share_cap")]
    got = FaultPlan.random(seed, 3).describe()
    assert got == ",".join(want)
    assert got == FaultPlan.random(seed, 3).describe()


SITES = ["engine.run", "engine.compile", "trace.read_batch", "engine.run",
         "engine.run", "trace.read_batch", "engine.compile", "engine.run",
         "trace.read_batch", "trace.read_batch"]


@pytest.mark.parametrize("text", ["oom@2", "oom,oom@3,compile@2",
                                  "trace_loss@2,oom@4,compile",
                                  "trace_loss,trace_loss@4,oom@2"])
def test_plans_fire_in_the_same_sequence(text):
    def pattern(check_fn):
        out = []
        for site in SITES:
            try:
                check_fn(site)
                out.append(None)
            except Exception as e:  # noqa: BLE001 — the firing pattern
                out.append(site)
        return out

    faults.install(FaultPlan.parse(text))
    jax_faults.install(jax_faults.FaultPlan.parse(text))
    assert pattern(faults.check) == pattern(jax_faults.check)


def test_injected_oom_is_the_cards_error_type():
    faults.install(FaultPlan.parse("oom@2"))
    faults.check("engine.run")
    with pytest.raises(torch.OutOfMemoryError, match="CUDA out of memory"):
        faults.check("engine.run")
    faults.check("engine.run")            # the entry is spent


# ---------------------------------------------------------------------------
# the sampler's ladder, against the JAX package's


@pytest.mark.parametrize("model", ["gemm", "mvt", "cholesky"])
@pytest.mark.parametrize("plan", ["oom", "oom,oom@2", "oom,oom@2,oom@3",
                                  "oom,oom@2,oom@3,oom@4", "compile"])
def test_injected_faults_walk_the_same_ladder(model, plan, fast_retry):
    jax_faults.install(jax_faults.FaultPlan.parse(plan))
    want = jax_res.run_resilient(jax_models.REGISTRY[model](16),
                                 JaxConfig(**KW),
                                 retry=JaxRetry(backoff_s=0.0))
    faults.install(FaultPlan.parse(plan))
    got = run_resilient(carried(model, 16), SamplerConfig(**KW),
                        device="cpu", retry=fast_retry)
    assert got.degradations == want.degradations
    same_result(got, want)
    clean = engine.run(carried(model, 16), SamplerConfig(**KW),
                       device="cpu")
    same_result(got, clean)
    assert clean.degradations == ()


def test_sliced_pipeline_rung_runs_one_thread_at_a_time(monkeypatch,
                                                        fast_retry):
    calls = []
    real = engine.run_sliced

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(engine, "run_sliced", spy)
    faults.install(FaultPlan.parse("oom,oom@2,oom@3"))
    res = run_resilient(carried("gemm", 16), SamplerConfig(**KW),
                        device="cpu", retry=fast_retry)
    assert res.degradations == LADDER[:3]
    assert calls and calls[0]["thread_batch"] == 1
    assert calls[0]["window_accesses"] == max((1 << 23) // 64, 1 << 10)


def test_exhausted_ladder_raises_classified_not_raw(fast_retry):
    faults.install(FaultPlan.parse("oom,oom@2,oom@3,oom@4,oom@5"))
    with pytest.raises(ResourceExhausted) as ei:
        run_resilient(carried("gemm", 16), SamplerConfig(**KW),
                      device="cpu", retry=fast_retry)
    assert isinstance(ei.value.cause, torch.OutOfMemoryError)


def test_fatal_error_is_classified_at_once(monkeypatch, fast_retry):
    calls = []

    def broken(spec, cfg, **kw):
        calls.append(kw)
        raise ValueError("a spec contract violation")

    monkeypatch.setattr(engine, "run", broken)
    with pytest.raises(PlussError, match="contract violation") as ei:
        run_resilient(carried("gemm", 16), SamplerConfig(**KW),
                      device="cpu", retry=fast_retry)
    assert type(ei.value) is PlussError and ei.value.fatal
    assert ei.value.site == "run[gemm16]" and len(calls) == 1


def test_plain_engine_run_still_raises_raw():
    faults.install(FaultPlan.parse("oom"))
    with pytest.raises(torch.OutOfMemoryError, match="CUDA out of memory"):
        engine.run(carried("gemm", 16), SamplerConfig(**KW), device="cpu")
    faults.install(FaultPlan.parse("compile"))
    with pytest.raises(build.BuildError):
        engine.run(carried("gemm", 16), SamplerConfig(**KW), device="cpu")


def test_shard_backend_is_a_classified_error(fast_retry):
    """The shard backend runs under its own ladder (SHARD_LADDER); a
    failure its rungs cannot absorb comes back classified, never raw."""
    faults.install(FaultPlan.parse("shard_oom"))
    with pytest.raises(ResourceExhausted) as ei:
        run_resilient(carried("gemm", 16), SamplerConfig(**KW),
                      backend="shard", device="cpu", rungs=(),
                      retry=fast_retry)
    assert isinstance(ei.value.cause, torch.OutOfMemoryError)
    faults.install(None)
    got = run_resilient(carried("gemm", 16), SamplerConfig(**KW),
                        backend="shard", device="cpu", retry=fast_retry)
    same_result(got, engine.run(carried("gemm", 16), SamplerConfig(**KW),
                                device="cpu"))
    assert got.degradations == ()


def test_describe_path_carries_degradation_stamp():
    spec, cfg = carried("gemm", 16), SamplerConfig(**KW)
    stamp = ("shrink_window", "cpu_fallback")
    label = engine.describe_path(spec, cfg, degradations=stamp,
                                 device="cpu")
    assert label == jax_engine.describe_path(
        jax_models.REGISTRY["gemm"](16), JaxConfig(**KW),
        degradations=stamp)
    assert label.endswith("[degraded: shrink_window,cpu_fallback]")
    assert engine.describe_path(spec, cfg, device="cpu") \
        == label.split(" [")[0]
    assert degradation_label("x", ()) == "x"


def test_cpu_fallback_leaves_later_calls_on_their_device(monkeypatch,
                                                          fast_retry):
    """The rung moves only its own attempt to the CPU: the next call with
    no device asks for the card again, and nothing pins the process."""
    devices = []
    real = engine.run

    def fake_run(spec, cfg, **kw):
        devices.append(kw["device"])
        if kw["device"] != "cpu":
            raise torch.OutOfMemoryError("CUDA out of memory. (test)")
        return real(spec, cfg, **kw)

    def fake_sliced(spec, cfg, **kw):
        devices.append(kw["device"])
        raise torch.OutOfMemoryError("CUDA out of memory. (test)")

    monkeypatch.setattr(engine, "run", fake_run)
    monkeypatch.setattr(engine, "run_sliced", fake_sliced)
    res = run_resilient(carried("gemm", 16), SamplerConfig(**KW),
                        retry=fast_retry)
    assert res.degradations == LADDER
    assert devices == [None, None, None, None, "cpu"]
    assert "cpu_pinned" not in res.degradations
    devices.clear()
    with pytest.raises(ResourceExhausted):
        run_resilient(carried("gemm", 16), SamplerConfig(**KW),
                      retry=fast_retry, rungs=LADDER[:1])
    assert devices == [None, None]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engine.resolve_device()


def test_build_failure_on_the_card_is_raised_not_moved_to_the_cpu(
        monkeypatch, fast_retry):
    """An attempt on the card whose kernel build fails (here the injected
    ``compile`` fault, through the real engine up to its build step) is
    raised classified at once: no rung mends a build, and the CPU rung
    would return a host result for a card request.  On the CPU the same
    fault degrades as in JAX (``test_injected_faults_walk_the_same_ladder``)."""
    calls = []
    real = engine.run

    def spy(spec, cfg, **kw):
        calls.append(kw["device"])
        return real(spec, cfg, **kw)

    monkeypatch.setattr(engine, "run", spy)
    monkeypatch.setattr(engine, "sort_budget",
                        lambda dev: engine.CPU_SORT_BUDGET)
    faults.install(FaultPlan.parse("compile"))
    with pytest.raises(CompileError) as ei:
        run_resilient(carried("gemm", 16), SamplerConfig(**KW),
                      device="cuda", retry=fast_retry)
    assert isinstance(ei.value.cause, build.BuildError)
    assert calls == ["cuda"]


def test_trace_build_failure_on_the_card_is_raised(tmp_path, monkeypatch,
                                                   fast_retry):
    tf, _ = _mk_trace(tmp_path)
    devices = []

    def no_build(path, fmt="u64", **kw):
        devices.append(kw.get("device"))
        if kw.get("device") != "cpu":
            raise build.BuildError("nvcc failed for masked_hist (test)")
        raise AssertionError("the CPU rung ran")

    monkeypatch.setattr(trace, "replay_file", no_build)
    for dev in (None, "cuda"):
        devices.clear()
        with pytest.raises(CompileError):
            replay_file_resilient(tf, window=512, device=dev,
                                  retry=fast_retry)
        assert devices == [dev]


def test_rung_event_names_the_raw_cause(tmp_path, fast_retry):
    from pluss_torch import obs
    from pluss_torch.obs import stats as stats_mod

    ev = str(tmp_path / "ev.jsonl")
    faults.install(FaultPlan.parse("oom"))
    obs.configure(ev)
    try:
        run_resilient(carried("gemm", 16), SamplerConfig(**KW),
                      device="cpu", retry=fast_retry)
    finally:
        obs.shutdown()
    recs, _, _ = stats_mod.load(ev)
    (rung,) = [r for r in recs if r.get("name") == "resilience.rung"]
    a = rung["attrs"]
    assert (a["rung"], a["error"], a["cause"]) == (
        "shrink_window", "ResourceExhausted", "OutOfMemoryError")


def test_failed_attempts_frames_release_their_tensors(fast_retry):
    """A failed attempt's tensors die before the next attempt starts: the
    classified error keeps the message and the chain, not the frames'
    locals (on the card, those would hold the memory the next rung needs)."""
    refs = []

    def make_attempt(state):
        if refs:
            gc.collect()
            assert refs[0]() is None, "the failed attempt's tensor lives on"
            return "done"
        big = torch.zeros(1 << 16)
        refs.append(weakref.ref(big))
        raise torch.OutOfMemoryError("CUDA out of memory. (test)")

    out, stamp = _resilient_loop(make_attempt, lambda s, r: None, LADDER,
                                 fast_retry, label="frames",
                                 on_card=lambda s: False)
    assert out == "done" and stamp == ("shrink_window",)


# ---------------------------------------------------------------------------
# the plan cache under the corrupt_cache fault


@pytest.fixture()
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("PLUSS_NO_PLAN_CACHE", raising=False)
    monkeypatch.setenv("PLUSS_PLAN_CACHE_DIR", str(tmp_path))
    engine._plan_cached.cache_clear()
    yield tmp_path
    engine._plan_cached.cache_clear()


def test_fault_corrupted_plan_cache_is_quarantined(cache_dir, capsys):
    spec, cfg = carried("gemm", 16), SamplerConfig(**KW)
    clean = engine.run(spec, cfg, device="cpu")
    entries = [f for f in os.listdir(cache_dir) if f.endswith(".pkl")]
    assert entries
    engine._plan_cached.cache_clear()
    faults.install(FaultPlan.parse("corrupt_cache"))
    res = engine.run(spec, cfg, device="cpu")
    same_result(res, clean)
    assert sorted(f for f in os.listdir(cache_dir)
                  if f.endswith(".corrupt")) == [entries[0] + ".corrupt"]
    assert entries[0] in os.listdir(cache_dir)   # rebuilt into its slot
    assert "quarantined" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# replay_file_resilient


def _mk_trace(tmp_path, n=5 * 8 * 512 + 77, seed=0):
    rng = np.random.default_rng(seed)
    p = tmp_path / "t.bin"
    (rng.integers(0, 1 << 12, n, dtype=np.int64) << 6).astype(
        "<u8").tofile(p)
    return str(p), n


def test_replay_resilient_classifies_data_loss(tmp_path, fast_retry):
    tf, _ = _mk_trace(tmp_path)
    faults.install(FaultPlan.parse("trace_loss"))
    with pytest.raises(DataLoss):
        replay_file_resilient(tf, window=512, device="cpu",
                              retry=fast_retry)
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"\x01" * 17)
    with pytest.raises(DataLoss, match="offset 16"):
        replay_file_resilient(str(bad), window=512, device="cpu",
                              retry=fast_retry)


def test_replay_resilient_serial_feed_rung(tmp_path, monkeypatch,
                                           fast_retry):
    tf, _ = _mk_trace(tmp_path)
    ref = trace.replay_file(tf, window=512, device="cpu")
    real = trace.replay_file
    calls = []

    def flaky(path, fmt="u64", **kw):
        calls.append(kw)
        if len(calls) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory. (test)")
        return real(path, fmt, **kw)

    monkeypatch.setattr(trace, "replay_file", flaky)
    res = replay_file_resilient(tf, window=512, wire="d24v", feed_workers=3,
                                resident_cache=True, device="cpu",
                                retry=fast_retry)
    assert res.degradations == ("serial_feed",) == TRACE_LADDER[:1]
    assert calls[0]["feed_workers"] == 3 and calls[0]["wire"] == "d24v"
    assert calls[1]["feed_workers"] == 1 and calls[1]["wire"] == "pack"
    assert calls[1]["resident_cache"] is False
    assert calls[1]["window"] == 512
    assert res.wire == "pack" and res.feed_workers == 1
    np.testing.assert_array_equal(res.hist, ref.hist)

    # a checkpointed run keeps its wire (part of the checkpoint identity),
    # and an unset wire is resolved once, up front
    calls.clear()
    ck = str(tmp_path / "rung.ckpt.npz")
    res = replay_file_resilient(tf, window=512, wire="d24v", feed_workers=3,
                                checkpoint_path=ck, device="cpu",
                                retry=fast_retry)
    assert res.degradations == ("serial_feed",)
    assert calls[1]["feed_workers"] == 1 and calls[1]["wire"] == "d24v"
    np.testing.assert_array_equal(res.hist, ref.hist)
    calls.clear()
    res = replay_file_resilient(tf, window=512, checkpoint_path=ck,
                                device="cpu", retry=fast_retry)
    assert calls[0]["wire"] == "pack"   # auto, resolved on the CPU
    np.testing.assert_array_equal(res.hist, ref.hist)


def test_replay_resilient_matches_jax_under_the_same_faults(tmp_path,
                                                             monkeypatch,
                                                             fast_retry):
    """Two degradable failures walk serial_feed then shrink_window in both
    packages; the results equal each other and the clean replay."""
    tf, _ = _mk_trace(tmp_path)
    out = {}
    for name, mod, res_mod, err in (
            ("jax", jax_trace, jax_res, MemoryError),
            ("port", trace, resilience, torch.OutOfMemoryError)):
        real = mod.replay_file
        seen = []

        def flaky(path, fmt="u64", _real=real, _seen=seen, _err=err, **kw):
            _seen.append(kw.get("window"))
            if len(_seen) <= 2:
                raise _err("out of memory (test)")
            return _real(path, fmt, **kw)

        monkeypatch.setattr(mod, "replay_file", flaky)
        kw = {"device": "cpu"} if name == "port" else {}
        retry = fast_retry if name == "port" else JaxRetry(backoff_s=0.0)
        out[name] = (res_mod.replay_file_resilient(
            tf, window=1 << 15, batch_windows=2, retry=retry, **kw), seen)
        monkeypatch.setattr(mod, "replay_file", real)
    (got, seen_p), (want, seen_j) = out["port"], out["jax"]
    assert got.degradations == want.degradations \
        == ("serial_feed", "shrink_window")
    assert seen_p == seen_j == [1 << 15, 1 << 15, 1 << 14]
    np.testing.assert_array_equal(got.hist, want.hist)
    assert got.total_count == want.total_count


def test_replay_resilient_passes_batching_knobs_through(tmp_path,
                                                        fast_retry):
    tf, _ = _mk_trace(tmp_path)
    ref = trace.replay_file(tf, window=512, device="cpu")
    res = replay_file_resilient(tf, window=512, batch_windows=3,
                                queue_depth=1, segmented=False,
                                device="cpu", retry=fast_retry)
    assert res.degradations == ()
    np.testing.assert_array_equal(res.hist, ref.hist)
    cut = replay_file_resilient(tf, window=512, batch_windows=2,
                                deadline_s=0.0, device="cpu",
                                retry=fast_retry)
    assert 0 < cut.total_count <= ref.total_count
    assert cut.total_count % (2 * 512) == 0


def test_plain_replay_file_raises_raw(tmp_path):
    tf, _ = _mk_trace(tmp_path)
    faults.install(FaultPlan.parse("trace_loss@2"))
    with pytest.raises(DataLoss, match="injected trace_loss@2"):
        trace.replay_file(tf, window=512, batch_windows=2, device="cpu")


@pytest.mark.parametrize("feed_workers", [1, 3])
def test_read_fault_fires_on_the_nth_stream_batch(tmp_path, feed_workers):
    """``trace_loss@n`` stops the replay after n-1 batches, with the pool
    as with the single reader (the site runs in stream order)."""
    from pluss_torch import obs

    tf, _ = _mk_trace(tmp_path)
    obs.configure(str(tmp_path / "ev.jsonl"))
    try:
        faults.install(FaultPlan.parse("trace_loss@3"))
        with pytest.raises(DataLoss):
            trace.replay_file(tf, window=512, batch_windows=2,
                              feed_workers=feed_workers, device="cpu")
        assert obs.counters()["trace.batches"] == 2
    finally:
        obs.shutdown()
