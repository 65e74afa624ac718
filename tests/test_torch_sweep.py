"""The port's schedule sweep (``pluss_torch.sweep``) held against the JAX
package's (``pluss.sweep``), on the CPU.

- points (curves, refs, degradations) equal ``pluss.sweep.sweep``'s and a
  solo ``engine.run`` + ``cri.distribute`` + ``mrc.aet_mrc`` per point;
- the journal: a resumed sweep recomputes nothing (stamped ``journal``),
  from a journal either package wrote, and the journal records are the
  JAX package's;
- ``device_groups``: on one device the groups clamp to one and the points
  equal the serial sweep's; a group of more than one device runs its
  point sharded over the group, equal too;
- the precompile thread plans the next point (``sweep.precompiles``);
- ``cli sweep --cpu --model gemm --n 16`` (and with ``--resume``) prints
  what ``pluss.cli sweep --cpu`` prints, byte for byte.
"""

import json

import numpy as np
import pytest
import torch

from pluss import cli as jax_cli
from pluss import sweep as jax_sweep
from pluss.config import SamplerConfig as JaxConfig
from pluss.models import REGISTRY as JAX_REGISTRY
from pluss_torch import cli, cri, engine, mrc, obs, sweep
from pluss_torch.config import SamplerConfig
from pluss_torch.models import REGISTRY

CPU = torch.device("cpu")


def same_points(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.cfg.thread_num, a.cfg.chunk_size) == \
            (b.cfg.thread_num, b.cfg.chunk_size)
        assert np.array_equal(a.curve, b.curve)
        assert a.total_refs == b.total_refs
        assert a.degradations == b.degradations


@pytest.mark.parametrize("model,n,threads,chunks,cls", [
    ("gemm", 16, (1, 4), (2,), 8),
    ("mvt", 12, (2, 3), (1, 4), 64),
    ("syrk_tri", 10, (2,), (2, 3), 32),
])
def test_points_match_jax_and_solo_runs(model, n, threads, chunks, cls):
    got = sweep.sweep(REGISTRY[model](n), thread_nums=threads,
                      chunk_sizes=chunks, base_cfg=SamplerConfig(cls=cls),
                      device=CPU)
    want = jax_sweep.sweep(JAX_REGISTRY[model](n), thread_nums=threads,
                           chunk_sizes=chunks, base_cfg=JaxConfig(cls=cls))
    same_points(got, want)
    for p in got:
        assert p.degradations == ()
        res = engine.run(REGISTRY[model](n), p.cfg, device=CPU)
        ri = cri.distribute(res.noshare_list(), res.share_list(),
                            p.cfg.thread_num)
        assert np.array_equal(p.curve, mrc.aet_mrc(ri, p.cfg))
        assert p.total_refs == res.max_iteration_count
    assert sweep.table(got, [16, 256]) == jax_sweep.table(want, [16, 256])


def _no_runs(monkeypatch):
    from pluss_torch import resilience

    def boom(*a, **k):
        raise AssertionError("a journaled point was recomputed")

    monkeypatch.setattr(resilience, "run_resilient", boom)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_resume_recomputes_nothing(tmp_path, monkeypatch, writer):
    """A sweep resumed from a complete journal (written by either
    package) runs nothing, stamps ``journal``, and equals the clean
    sweep."""
    spec, jspec = REGISTRY["gemm"](12), JAX_REGISTRY["gemm"](12)
    kw = dict(thread_nums=(1, 2), chunk_sizes=(2, 4))
    journal = str(tmp_path / "sweep.jsonl")
    if writer == "port":
        clean = sweep.sweep(spec, journal=journal, device=CPU, **kw)
    else:
        clean = jax_sweep.sweep(jspec, journal=journal, **kw)
    n_lines = len(open(journal).read().splitlines())
    _no_runs(monkeypatch)
    obs.configure(str(tmp_path / "ev.jsonl"))
    try:
        resumed = sweep.sweep(spec, journal=journal, resume=True,
                              device=CPU, **kw)
        assert obs.counters().get("sweep.points_restored") == 4
        assert not obs.counters().get("sweep.points_run")
    finally:
        obs.shutdown()
    assert [p.degradations for p in resumed] == [("journal",)] * 4
    for a, b in zip(resumed, clean):
        assert np.array_equal(a.curve, b.curve)
        assert a.total_refs == b.total_refs
    assert len(open(journal).read().splitlines()) == n_lines
    # and the JAX package resumes it the same way
    jres = jax_sweep.sweep(jspec, journal=journal, resume=True, **kw)
    same_points(resumed, jres)


def test_journal_records_match_jax(tmp_path):
    """The journal either package writes holds the same records (the
    canonical point key, the raw histograms, refs, degradations)."""
    kw = dict(thread_nums=(2,), chunk_sizes=(1, 4))
    a, b = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    sweep.sweep(REGISTRY["mvt"](12), journal=a, device=CPU, **kw)
    jax_sweep.sweep(JAX_REGISTRY["mvt"](12), journal=b, **kw)

    def records(path):
        out = []
        for line in open(path).read().splitlines():
            rec = json.loads(line)
            rec.pop("t", None)
            out.append(rec)
        return out

    assert records(a) == records(b)


def test_partial_journal_resumes_the_rest(tmp_path, monkeypatch):
    """A sweep cut after its first point resumes with that point restored
    and the others run."""
    spec = REGISTRY["gemm"](12)
    journal = str(tmp_path / "sweep.jsonl")
    sweep.sweep(spec, thread_nums=(1,), chunk_sizes=(4,), journal=journal,
                device=CPU)
    pts = sweep.sweep(spec, thread_nums=(1, 2), chunk_sizes=(4,),
                      journal=journal, resume=True, device=CPU)
    assert [p.degradations for p in pts] == [("journal",), ()]
    want = jax_sweep.sweep(JAX_REGISTRY["gemm"](12), thread_nums=(1, 2),
                           chunk_sizes=(4,))
    for a, b in zip(pts, want):
        assert np.array_equal(a.curve, b.curve)


def test_device_groups_clamp_on_one_device():
    spec = REGISTRY["gemm"](12)
    kw = dict(thread_nums=(1, 2, 4), chunk_sizes=(4,), device=CPU)
    same_points(sweep.sweep(spec, device_groups=2, **kw),
                sweep.sweep(spec, **kw))


def test_device_group_of_several_devices_is_refused(monkeypatch):
    """A group of several devices is no longer refused: its point runs
    through the sharded backend over the group, equal to the serial
    sweep."""
    monkeypatch.setattr(sweep, "_devices_like",
                        lambda dev: [torch.device("cpu")] * 4)
    kw = dict(thread_nums=(1, 2), chunk_sizes=(4,), device=CPU)
    same_points(sweep.sweep(REGISTRY["gemm"](8), device_groups=2, **kw),
                sweep.sweep(REGISTRY["gemm"](8), **kw))


def test_precompile_thread_plans_the_next_point(tmp_path, monkeypatch):
    engine._plan_cached.cache_clear()
    monkeypatch.delenv("PLUSS_NO_PRECOMPILE", raising=False)
    obs.configure(str(tmp_path / "ev.jsonl"))
    try:
        threads = []
        real = sweep._spawn_precompile

        def keep(*a, **k):
            t = real(*a, **k)
            threads.append(t)
            return t

        monkeypatch.setattr(sweep, "_spawn_precompile", keep)
        sweep.sweep(REGISTRY["gemm"](12), thread_nums=(1, 2, 4),
                    chunk_sizes=(4,), device=CPU)
        for t in threads:
            t.join(30)
        assert len(threads) == 2
        assert obs.counters().get("sweep.precompiles") == 2
        assert not obs.counters().get("sweep.precompile_fail")
        assert obs.counters().get("sweep.points_run") == 3
    finally:
        obs.shutdown()
        engine._plan_cached.cache_clear()


def test_sweep_on_the_card_never_moves_a_point_to_the_cpu(monkeypatch):
    """A point on the card that runs out of device memory at every
    attempt walks the ladder's card rungs and raises classified: no
    attempt runs on the CPU, so no point comes back stamped
    ``cpu_fallback`` as if it were the card's.  The card is faked: every
    attempt on ``cuda`` raises ``torch.OutOfMemoryError``."""
    from pluss_torch.resilience import ladder
    from pluss_torch.resilience.errors import ResourceExhausted

    devices = []

    def card_oom(real):
        def run(spec, cfg, **kw):
            devices.append(torch.device(kw["device"]).type)
            if devices[-1] == "cuda":
                raise torch.OutOfMemoryError("CUDA out of memory (test)")
            return real(spec, cfg, **kw)
        return run

    monkeypatch.setattr(engine, "run", card_oom(engine.run))
    monkeypatch.setattr(engine, "run_sliced", card_oom(engine.run_sliced))
    monkeypatch.setattr(ladder.Retry, "sleep", lambda self, attempt: None)
    monkeypatch.setenv("PLUSS_NO_PRECOMPILE", "1")
    with pytest.raises(ResourceExhausted):
        sweep.sweep(REGISTRY["gemm"](8), thread_nums=(1,), device="cuda")
    assert len(devices) > 1 and set(devices) == {"cuda"}


def test_sweep_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.sweep(REGISTRY["gemm"](8), thread_nums=(1,))


@pytest.mark.parametrize("extra", [[], ["--sweep-threads", "1,2",
                                        "--sweep-chunks", "4",
                                        "--cache-lines", "64,1024"]])
def test_cli_sweep_matches_jax(capsys, extra):
    argv = ["sweep", "--cpu", "--model", "gemm", "--n", "16", *extra]
    assert cli.main(argv) == 0
    got = capsys.readouterr().out
    jax_cli.main(argv)
    want = capsys.readouterr().out
    assert got == want
    assert "predicted miss ratios" in got and "carried levels" in got


def test_cli_sweep_resume_matches_jax(capsys, tmp_path, monkeypatch):
    """``--resume`` with a journal the JAX CLI wrote: the port recomputes
    nothing and prints the JAX CLI's resumed table (its ``degraded``
    column says ``journal``)."""
    journal = str(tmp_path / "j.jsonl")
    argv = ["sweep", "--cpu", "--model", "mvt", "--n", "12",
            "--sweep-threads", "1,2", "--sweep-chunks", "4",
            "--resume", "--journal", journal]
    jax_cli.main(argv)
    capsys.readouterr()
    jax_cli.main(argv)
    want = capsys.readouterr().out
    _no_runs(monkeypatch)
    assert cli.main(argv) == 0
    got = capsys.readouterr().out
    assert got == want and "journal" in got
