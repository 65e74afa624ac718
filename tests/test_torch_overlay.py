"""The port's interleave overlays vs the JAX package's, on the CPU.

- plan parity: every field of every ``OverlayPlan`` (geometry, static
  histograms and share lists, the per-line tables) equals
  ``pluss.overlay``'s for syrk and syr2k;
- end to end: overlay runs equal ``pluss.engine.run`` exactly over the
  (n, threads, chunk, line size) grid of tests/test_overlay.py, a
  two-nest carry and syr2k's double overlay; the same plan with overlays
  off, and with int64 positions, gives the same result;
- the plan-time verifier catches a corrupted table; the finalize drops a
  share value whose net count is exactly 0 and raises on a negative one.

Every spec is built by the JAX package and carried into the port through
its codec JSON.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pluss import engine as jax_engine
from pluss import models as jax_models
from pluss import overlay as jax_overlay
from pluss.config import SamplerConfig as JaxConfig
from pluss.spec import Loop as JLoop
from pluss.spec import LoopNestSpec as JSpec
from pluss.spec import Ref as JRef
from pluss.spec import share_span_formula
from pluss.spec_codec import spec_to_json as jax_spec_to_json
from pluss_torch import engine, overlay
from pluss_torch.config import SamplerConfig
from pluss_torch.ops.event_hist import event_histogram
from pluss_torch.ops.reuse import SHARE_SHIFT
from pluss_torch.spec_codec import spec_from_json

CPU = torch.device("cpu")


def carried(js):
    return spec_from_json(jax_spec_to_json(js))


def overlays_of(pl):
    return [ov for np_ in pl.nests for ov in np_.overlays]


def assert_same_result(got, want):
    assert got.max_iteration_count == want.max_iteration_count
    np.testing.assert_array_equal(got.noshare_dense, want.noshare_dense)
    assert got.share_raw == want.share_raw
    assert got.share_list() == want.share_list()


def run_both(js, kw):
    want = jax_engine.run(js, JaxConfig(**kw))
    got = engine.run(carried(js), SamplerConfig(**kw), device="cpu")
    assert_same_result(got, want)
    return got


@pytest.mark.parametrize("model,n,kw", [
    ("syrk", 32, {}),
    ("syrk", 24, {"thread_num": 3, "chunk_size": 4, "cls": 8}),
    ("syr2k", 32, {}),
])
def test_overlay_plans_match_jax(model, n, kw):
    js = jax_models.REGISTRY[model](n)
    jp = jax_engine.plan(js, JaxConfig(**kw))
    tp = engine.plan(carried(js), SamplerConfig(**kw))
    assert [ov.array for ov in overlays_of(tp)] == \
        [ov.array for ov in overlays_of(jp)] != []
    for a, b in zip(overlays_of(tp), overlays_of(jp)):
        for f in dataclasses.fields(overlay.OverlayPlan):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            elif f.name in ("d_ref", "s_ref"):
                assert dataclasses.asdict(x) == dataclasses.asdict(y)
            else:
                assert x == y, f.name
    for a, b in zip(tp.nests, jp.nests):
        assert [f.ref.name for f in a.var_refs_novl] == \
            [f.ref.name for f in b.var_refs_novl]
        np.testing.assert_array_equal(a.ultra_windows(), b.ultra_windows())
    assert engine.plan_path(tp) == jax_engine.plan_path(jp) \
        == "template+overlay"


@pytest.mark.parametrize("n,T,CS,cls", [
    (16, 4, 4, 8),
    (24, 3, 4, 8),
    (32, 2, 8, 16),
    (48, 4, 2, 8),
    (64, 8, 2, 64),
    (40, 5, 4, 8),
])
def test_overlay_grid_matches_jax(n, T, CS, cls):
    """tests/test_overlay.py's overlay-eligible grid: the overlay engages
    and the run equals the JAX package's."""
    kw = {"thread_num": T, "chunk_size": CS, "cls": cls}
    js = jax_models.REGISTRY["syrk"](n)
    assert [ov.array for ov in overlays_of(
        engine.plan(carried(js), SamplerConfig(**kw)))] == ["A"]
    run_both(js, kw)


def test_overlay_two_nest_carry():
    """A second nest re-touching the overlaid array reads absolute carried
    positions (the nest-base offset of ``device_window``)."""
    n = 16
    span = share_span_formula(n)

    def a_nest():
        inner = JLoop(trip=n, body=(
            JRef("A0", "A", addr_terms=((0, n), (2, 1))),
            JRef("A1", "A", addr_terms=((1, n), (2, 1)), share_span=span),
        ))
        return JLoop(trip=n, body=(JLoop(trip=n, body=(inner,)),))

    js = JSpec(name="twice", arrays=(("A", n * n),),
               nests=(a_nest(), a_nest()))
    pl = engine.plan(carried(js), SamplerConfig(cls=8))
    assert [ov.array for ov in overlays_of(pl)] == ["A", "A"]
    run_both(js, {"cls": 8})


def test_syr2k_double_overlay():
    js = jax_models.REGISTRY["syr2k"](32)
    pl = engine.plan(carried(js), SamplerConfig())
    assert sorted(ov.array for ov in overlays_of(pl)) == ["A", "B"]
    assert pl.nests[0].var_refs_novl == ()
    run_both(js, {})


@pytest.mark.parametrize("model,n,kw", [
    ("syrk", 32, {}),
    ("syr2k", 16, {"cls": 8}),
])
def test_overlay_off_and_int64_positions_match(model, n, kw):
    """The same workload with the overlays off (their arrays sort in
    every window) and with int64 positions gives the same result."""
    spec, cfg = carried(jax_models.REGISTRY[model](n)), SamplerConfig(**kw)
    on = engine.plan(spec, cfg)
    off = engine.plan(spec, cfg, build_overlays=False)
    assert overlays_of(on) and not overlays_of(off)
    assert engine.plan_path(off) == "template+sort"
    want = engine._execute(on, CPU)
    assert_same_result(engine._execute(off, CPU), want)
    wide = dataclasses.replace(on, pos_dtype=np.dtype(np.int64))
    assert_same_result(engine._execute(wide, CPU), want)


def test_verifier_catches_corruption(capsys):
    cfg = SamplerConfig()
    pl = engine.plan(carried(jax_models.REGISTRY["syrk"](32)), cfg,
                     window_accesses=1)
    np_, ov = pl.nests[0], overlays_of(pl)[0]
    assert np_.n_windows == 2
    assert overlay.verify_overlay(ov, cfg, np_.sched, np_.n_windows,
                                  {(0, 0), (3, 1)})
    bad = dataclasses.replace(ov, d_off=ov.d_off + 1)   # shift D's clock
    assert not overlay.verify_overlay(bad, cfg, np_.sched, 1, {(0, 0)})
    assert "verification FAILED" in capsys.readouterr().err
    table = ov.s_hist_prefix.copy()
    table[1:, 3] += 1               # line 0's static events, one too many
    bad = dataclasses.replace(ov, s_hist_prefix=table)
    assert not overlay.verify_overlay(bad, cfg, np_.sched, np_.n_windows,
                                      {(0, 0)})
    last = ov.s_last0.copy()
    last[-1] += 1                   # S's last access on the last line
    bad = dataclasses.replace(ov, s_last0=last)
    assert not overlay.verify_overlay(bad, cfg, np_.sched, np_.n_windows,
                                      {(0, 0)})


def test_verifier_agrees_with_jax_on_every_window():
    """The numpy prediction and brute replay of both packages agree on
    every (thread, window) of a multi-window plan."""
    cfg_t, cfg_j = SamplerConfig(thread_num=3, chunk_size=2), \
        JaxConfig(thread_num=3, chunk_size=2)
    js = jax_models.REGISTRY["syrk"](24)
    ov_t = overlays_of(engine.plan(carried(js), cfg_t))[0]
    jp = jax_engine.plan(js, cfg_j)
    ov_j = overlays_of(jp)[0]
    sched = jp.nests[0].sched
    carried_t = np.full(ov_t.n_lines, -1, np.int64)
    for w in range(jp.nests[0].n_windows):
        for t in range(3):
            pt = overlay.np_window_prediction(ov_t, cfg_t, w, t, carried_t)
            pj = jax_overlay.np_window_prediction(ov_j, cfg_j, w, t,
                                                  carried_t)
            np.testing.assert_array_equal(pt[0], pj[0])
            assert pt[1] == pj[1]
            np.testing.assert_array_equal(pt[2], pj[2])
        *_, carried_t = overlay.np_window_brute(ov_t, cfg_t, sched, w, 0,
                                                carried_t)


def test_ineligible_shape_falls_back():
    """syrk-20's rows end mid-line: no overlay, the sort path, and the
    JAX package's result."""
    js = jax_models.REGISTRY["syrk"](20)
    assert overlays_of(engine.plan(carried(js), SamplerConfig())) == []
    run_both(js, {})


def test_finalize_drops_net_zero_and_refuses_negative():
    """The overlays' subtractions merge separately; a share value whose
    net count is exactly 0 disappears (the JAX package's rule), one that
    goes negative raises."""
    spec, cfg = carried(jax_models.REGISTRY["syrk"](16)), SamplerConfig(cls=8)
    pl = engine.plan(spec, cfg)
    base = engine._execute(pl, CPU)
    v = 1 << 40   # a reuse no real window produces

    def finalize_with(t, plus, minus):
        walk = engine._Walk(pl, CPU, event_histogram)
        for ni, np_ in enumerate(pl.nests):
            for si, (_, w_list, _) in enumerate(engine._segments_of(np_)):
                for w in w_list:
                    walk.window(ni, si, w, slice(None))
        key = torch.tensor([(t << SHARE_SHIFT) | v])
        walk.plus.append((key, torch.tensor([plus])))
        walk.minus.append((key, torch.tensor([minus])))
        return engine._finalize(pl, walk.hist.cpu().numpy(), walk.plus,
                                walk.minus)

    res = finalize_with(1, 3, 3)
    assert v not in res.share_raw[1]
    assert_same_result(res, base)
    assert finalize_with(2, 3, 1).share_raw[2][v] == 2
    with pytest.raises(RuntimeError, match="went negative"):
        finalize_with(0, 1, 2)
