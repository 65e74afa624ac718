"""The port's sliced dispatch, auto-dispatch ladder and disk plan cache vs
the JAX package's, on the CPU.

- ``run_sliced`` equals ``pluss.engine.run`` over the families and
  variants of tests/test_sliced.py: thread batches, one window per slice,
  small windows, a custom assignment and a ``start_point`` resume;
- ``_auto_dispatch`` returns the JAX package's decision for equal budgets
  (the port's budget is an argument, JAX's is
  ``PLUSS_MAX_SORT_WINDOW_BYTES``), and ``run`` reroutes an over-budget
  plan to ``run_sliced`` with the same result;
- the plan cache: miss then hit, a salt change, a corrupt file
  quarantined and rebuilt, the eviction cap, the ``.bench`` default and
  ``PLUSS_NO_PLAN_CACHE``; ``precompile``, ``is_warm`` and
  ``describe_path``.

The test suite sets ``PLUSS_NO_PLAN_CACHE`` for the whole process, so the
cache tests lift it and point ``PLUSS_PLAN_CACHE_DIR`` at a temporary
directory.
"""

import os

import numpy as np
import pytest

from pluss import engine as jax_engine
from pluss import models as jax_models
from pluss.config import DEFAULT as JDEFAULT
from pluss.config import SamplerConfig as JaxConfig
from pluss.spec_codec import spec_to_json as jax_spec_to_json
from pluss_torch import engine
from pluss_torch.config import DEFAULT, SamplerConfig
from pluss_torch.spec_codec import spec_from_json


def carried(js):
    return spec_from_json(jax_spec_to_json(js))


def assert_same(got, want):
    assert got.max_iteration_count == want.max_iteration_count
    np.testing.assert_array_equal(got.noshare_dense, want.noshare_dense)
    assert got.share_raw == want.share_raw
    assert got.share_list() == want.share_list()


@pytest.fixture
def fresh_memo():
    """A plan memo that neither sees nor keeps other tests' plans."""
    engine._plan_cached.cache_clear()
    engine._warm_keys.clear()
    yield
    engine._plan_cached.cache_clear()
    engine._warm_keys.clear()


@pytest.mark.parametrize("model,n", [
    ("gemm", 16),            # template path
    ("gemm", 13),            # partial chunks: mixed ultra/sort segments
    ("syrk", 16),            # overlay path
    ("syrk_tri", 13),        # bounded buckets, clock tables, closed forms
    ("trmm", 12),
    ("mvt", 16),             # two nests: carries cross nests mid-slice
])
def test_run_sliced_matches_jax(model, n):
    js = jax_models.REGISTRY[model](n)
    want = jax_engine.run(js)
    spec = carried(js)
    assert_same(engine.run_sliced(spec, device="cpu"), want)
    assert_same(engine.run_sliced(spec, device="cpu", thread_batch=2,
                                  max_dispatch_entries=1), want)


@pytest.mark.parametrize("model,n,kw,win,entries", [
    ("syrk_tri", 12, {}, None, 1),        # every window its own slice
    ("syrk_tri", 16, {"cls": 8}, 1, 500),  # many tiny windows per slice
    ("cholesky", 13, {}, 1, 1),
    ("syrk", 32, {}, 1, 1),
])
@pytest.mark.parametrize("tb", [None, 1, 2, 3])
def test_thread_batches_and_slices_match_jax(model, n, kw, win, entries,
                                             tb):
    want = jax_engine.run(jax_models.REGISTRY[model](n), JaxConfig(**kw),
                          window_accesses=win)
    got = engine.run_sliced(carried(jax_models.REGISTRY[model](n)),
                            SamplerConfig(**kw), device="cpu",
                            window_accesses=win, thread_batch=tb,
                            max_dispatch_entries=entries)
    assert_same(got, want)


def test_assignment_and_resume_match_jax():
    js = jax_models.REGISTRY["gemm"](16)
    asg = ((0, 2, 1, 3),)
    assert_same(engine.run_sliced(carried(js), device="cpu", assignment=asg,
                                  thread_batch=1),
                jax_engine.run(js, assignment=asg))
    assert_same(engine.run_sliced(carried(js), device="cpu", start_point=8,
                                  thread_batch=3, max_dispatch_entries=1),
                jax_engine.run(js, start_point=8))


def test_slice_schedule_matches_jax():
    js = jax_models.REGISTRY["cholesky"](16)
    jp = jax_engine.plan(js, window_accesses=1)
    tp = engine.plan(carried(js), window_accesses=1)
    for tb, budget in ((None, 1), (2, 3000), (1, 1 << 28)):
        assert engine._slice_schedule(tp, DEFAULT, tb, budget) == \
            jax_engine._slice_schedule(jp, JDEFAULT, tb, budget)


def test_bad_thread_batch_raises():
    with pytest.raises(ValueError, match="thread_batch"):
        engine.run_sliced(carried(jax_models.REGISTRY["gemm"](8)),
                          device="cpu", thread_batch=0)


@pytest.mark.parametrize("model,n,win", [("cholesky", 16, None),
                                         ("trmm", 24, 1), ("mvt", 32, 1),
                                         ("gemm", 16, None)])
def test_auto_dispatch_matches_jax(model, n, win, monkeypatch):
    js = jax_models.REGISTRY[model](n)
    jp = jax_engine.plan(js, window_accesses=win)
    tp = engine.plan(carried(js), window_accesses=win)
    need = max(engine.sort_window_bytes(np_, DEFAULT, tp.pos_dtype,
                                        tp.spec.total_lines(), refs)
               for np_ in tp.nests for refs in [np_.refs] if refs)
    for limit in (need // 2, need, 2 * need - 1, 3 * need, 4 * need,
                  1 << 40):
        monkeypatch.setenv("PLUSS_MAX_SORT_WINDOW_BYTES", str(limit))
        for tb in (None, 3, 1):
            assert engine._auto_dispatch(tp, DEFAULT, tb, limit) == \
                jax_engine._auto_dispatch(jp, JDEFAULT, tb)
    # the time ceiling, for both packages from the same environment
    monkeypatch.setenv("PLUSS_DISPATCH_ENTRY_RATE", "1")
    monkeypatch.setenv("PLUSS_MAX_DISPATCH_S", "1")
    got = engine._auto_dispatch(tp, DEFAULT, None, 1 << 40)
    monkeypatch.setenv("PLUSS_MAX_SORT_WINDOW_BYTES", str(1 << 40))
    assert got == jax_engine._auto_dispatch(jp, JDEFAULT, None)
    assert "dispatch ceiling" in got[1]


def test_run_reroutes_an_over_budget_plan(monkeypatch, capsys, fresh_memo):
    """``run`` on a budget a quarter of the plan's need goes sliced, one
    thread at a time, and equals the JAX package; a budget below one
    window still raises before any window runs."""
    js = jax_models.REGISTRY["cholesky"](16)
    spec = carried(js)
    pl = engine._plan_cached(spec, DEFAULT, None, None, None)
    need = max(engine.sort_window_bytes(np_, DEFAULT, pl.pos_dtype,
                                        spec.total_lines())
               for np_ in pl.nests) * DEFAULT.thread_num
    monkeypatch.setattr(engine, "sort_budget", lambda dev: need // 4)
    assert engine._auto_dispatch(pl, DEFAULT, None, need // 4)[0] == 1
    assert_same(engine.run(spec, device="cpu"), jax_engine.run(js))
    assert "auto-sliced dispatch (thread_batch=1)" in capsys.readouterr().err
    assert engine.describe_path(spec, device="cpu") == "sliced:sort"
    assert engine.precompile(spec, device="cpu") == "sliced"
    monkeypatch.setenv("PLUSS_NO_AUTO_DISPATCH", "1")
    with pytest.raises(RuntimeError, match="device budget"):
        engine.run(spec, device="cpu")
    monkeypatch.delenv("PLUSS_NO_AUTO_DISPATCH")
    monkeypatch.setattr(engine, "sort_budget", lambda dev: need // 8)
    with pytest.raises(RuntimeError, match="device budget"):
        engine.run(spec, device="cpu")


@pytest.mark.parametrize("entry", ["precompile", "describe_path",
                                   "warm_run", "run_sliced"])
def test_no_auto_dispatch_holds_every_entry_point(entry, monkeypatch,
                                                  fresh_memo):
    """The over-budget cholesky-16 plan above, with
    ``PLUSS_NO_AUTO_DISPATCH=1``: every entry point sees one dispatch, as
    ``run`` does.  ``precompile`` says ``full``, ``describe_path`` has no
    ``sliced:`` prefix, ``warm_run`` raises the budget error, and
    ``run_sliced`` still slices, one thread at a time, equal to the JAX
    package."""
    js = jax_models.REGISTRY["cholesky"](16)
    spec = carried(js)
    pl = engine._plan_cached(spec, DEFAULT, None, None, None)
    need = max(engine.sort_window_bytes(np_, DEFAULT, pl.pos_dtype,
                                        spec.total_lines())
               for np_ in pl.nests) * DEFAULT.thread_num
    monkeypatch.setattr(engine, "sort_budget", lambda dev: need // 4)
    assert engine.describe_path(spec, device="cpu") == "sliced:sort"
    monkeypatch.setenv("PLUSS_NO_AUTO_DISPATCH", "1")
    if entry == "precompile":
        assert engine.precompile(spec, device="cpu") == "full"
    elif entry == "describe_path":
        assert engine.describe_path(spec, device="cpu") == "sort"
    elif entry == "warm_run":
        with pytest.raises(RuntimeError, match="device budget"):
            engine.warm_run(spec, device="cpu")
    else:
        calls, execute = [], engine._execute

        def spy(pl, dev, **kw):
            calls.append(kw)
            return execute(pl, dev, **kw)

        monkeypatch.setattr(engine, "_execute", spy)
        assert_same(engine.run_sliced(spec, device="cpu", thread_batch=1),
                    jax_engine.run(js))
        assert [(kw["thread_batch"], bool(kw["dispatch_entries"]))
                for kw in calls] == [(1, True)]


def test_run_thread_batch_matches_run(fresh_memo):
    spec = carried(jax_models.REGISTRY["syr2k"](16))
    want = engine.run(spec, SamplerConfig(cls=8), device="cpu")
    for tb in (1, 2, 3, 4, 9):
        assert_same(engine.run(spec, SamplerConfig(cls=8), device="cpu",
                               thread_batch=tb), want)


def test_precompile_is_warm_and_describe_path(fresh_memo):
    spec = carried(jax_models.REGISTRY["syrk"](16))
    assert not engine.is_warm(spec, DEFAULT)
    assert engine.precompile(spec, device="cpu") == "full"
    assert engine.is_warm(spec, DEFAULT)
    assert not engine.is_warm(spec, DEFAULT, window_accesses=1)
    assert engine.describe_path(spec, device="cpu") == "template+overlay"
    js = jax_models.REGISTRY["syrk_tri"](16)
    assert engine.describe_path(carried(js), device="cpu") == \
        jax_engine.describe_path(js) == "closed_form"
    engine.run(carried(js), device="cpu")
    assert engine.is_warm(carried(js), DEFAULT)


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("PLUSS_NO_PLAN_CACHE", raising=False)
    monkeypatch.setenv("PLUSS_PLAN_CACHE_DIR", str(tmp_path))
    return tmp_path


def jax_run_uncached(js, cfg=JDEFAULT):
    """``pluss.engine.run`` with its own plan cache off, so it writes
    nothing into the port's cache directory."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PLUSS_NO_PLAN_CACHE", "1")
        return jax_engine.run(js, cfg)


def entries(path):
    return sorted(p.name for p in path.iterdir() if p.suffix == ".pkl")


def assert_same_plan(a, b):
    for x, y in zip(a.nests, b.nests):
        for f in ("local_hist", "head_line", "head_pos", "tail_line",
                  "tail_pos", "share_vals", "share_cnts"):
            np.testing.assert_array_equal(getattr(x.tpl, f),
                                          getattr(y.tpl, f))
        assert [ov.array for ov in x.overlays] == \
            [ov.array for ov in y.overlays]
        for p, q in zip(x.overlays, y.overlays):
            np.testing.assert_array_equal(p.s_hist_prefix, q.s_hist_prefix)
            assert p.d_ref == q.d_ref and p.pos_shift == q.pos_shift


def test_plan_cache_miss_then_hit(cache_dir, monkeypatch):
    js = jax_models.REGISTRY["syrk"](16)
    spec, cfg = carried(js), SamplerConfig(cls=8)
    cold = engine.plan(spec, cfg)
    assert len(entries(cache_dir)) == 1      # one nest, one entry

    def no_build(*a, **k):
        raise AssertionError("rebuilt on a cache hit")

    monkeypatch.setattr(engine, "_build_template", no_build)
    monkeypatch.setattr(engine, "_build_overlays", no_build)
    warm = engine.plan(spec, cfg)
    assert_same_plan(warm, cold)
    assert_same(engine._execute(warm, engine.resolve_device("cpu")),
                jax_run_uncached(js, JaxConfig(cls=8)))
    # without overlays the template alone is read from the same entry
    assert not engine.plan(spec, cfg, build_overlays=False).nests[0].overlays
    # a resume plan neither reads nor writes the cache
    monkeypatch.undo()
    monkeypatch.delenv("PLUSS_NO_PLAN_CACHE", raising=False)
    monkeypatch.setenv("PLUSS_PLAN_CACHE_DIR", str(cache_dir))
    engine.plan(spec, cfg, start_point=8)
    assert len(entries(cache_dir)) == 1


def test_plan_cache_template_only_entry_gains_overlays(cache_dir):
    spec, cfg = carried(jax_models.REGISTRY["syrk"](16)), SamplerConfig()
    engine.plan(spec, cfg, build_overlays=False)
    (name,) = entries(cache_dir)
    assert engine._plan_cache_get(name[:-4])["overlays"] is None
    pl = engine.plan(spec, cfg)
    assert pl.nests[0].overlays
    assert engine._plan_cache_get(name[:-4])["overlays"]


def test_plan_cache_salt_change_misses(cache_dir, monkeypatch):
    spec = carried(jax_models.REGISTRY["gemm"](16))
    engine.plan(spec)
    first = entries(cache_dir)
    monkeypatch.setattr(engine, "_plan_cache_salt", lambda: "edited-source")
    engine.plan(spec)
    assert len(entries(cache_dir)) == 2 and first[0] in entries(cache_dir)
    # the salt hashes the port's own plan-analysis sources
    assert len(engine._plan_cache_salt()) > 0


def test_plan_cache_corrupt_file_is_quarantined(cache_dir, capsys):
    js = jax_models.REGISTRY["syrk"](16)
    spec = carried(js)
    engine.plan(spec)
    (name,) = entries(cache_dir)
    (cache_dir / name).write_bytes(b"not a pickle")
    pl = engine.plan(spec)
    assert "corrupt artifact" in capsys.readouterr().err
    assert (cache_dir / (name + ".corrupt")).read_bytes() == b"not a pickle"
    assert entries(cache_dir) == [name]      # rebuilt into the freed slot
    assert pl.nests[0].overlays
    assert_same(engine._execute(pl, engine.resolve_device("cpu")),
                jax_run_uncached(js))


def test_plan_cache_eviction_cap(cache_dir, monkeypatch):
    monkeypatch.setenv("PLUSS_PLAN_CACHE_MAX", "2")
    specs = [carried(jax_models.REGISTRY["gemm"](n)) for n in (8, 12, 16)]
    engine.plan(specs[0])
    engine.plan(specs[1])
    old, new = sorted(entries(cache_dir),
                      key=lambda n: os.path.getmtime(cache_dir / n))
    os.utime(cache_dir / old, (1, 1))
    os.utime(cache_dir / new, (2, 2))
    engine.plan(specs[0])                    # a hit refreshes its recency
    engine.plan(specs[2])
    assert len(entries(cache_dir)) == 2 and new not in entries(cache_dir)
    monkeypatch.setenv("PLUSS_PLAN_CACHE_MAX", "0")   # 0: no eviction
    engine.plan(specs[1])
    assert len(entries(cache_dir)) == 3
    monkeypatch.setenv("PLUSS_PLAN_CACHE_MAX", "many")
    assert engine.plan_cache_max() == 256


def test_plan_cache_location(tmp_path, monkeypatch):
    spec = carried(jax_models.REGISTRY["gemm"](8))
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("PLUSS_PLAN_CACHE_DIR", raising=False)
    monkeypatch.delenv("PLUSS_NO_PLAN_CACHE", raising=False)
    engine.plan(spec)                        # no .bench: off
    assert not (tmp_path / ".bench").exists()
    (tmp_path / ".bench").mkdir()
    engine.plan(spec)
    assert len(entries(tmp_path / ".bench" / "plan_cache")) == 1
    monkeypatch.setenv("PLUSS_NO_PLAN_CACHE", "1")
    assert engine._plan_cache_root() is None
