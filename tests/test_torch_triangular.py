"""The port's bounded (triangular), varying-start and quad nests vs the JAX
package's, on the CPU.

- plan parity: owned chunks, the clock table, the size buckets and their
  per-bucket ``FlatRef`` trips, the closed-form tables (row-private and
  sweep-group ``rpg_hist``, ``static_share``), per-thread iterations, nest
  bases, access totals and the position dtype equal ``pluss.engine.plan``
  (JAX side without overlays, which the port does not build);
- end to end: ``pluss_torch.engine.run(device="cpu")`` equals
  ``pluss.engine.run`` exactly across window sizes, custom chunk
  assignments and ``start_point`` resumes (thread counts and line sizes:
  tests/test_torch_tri_variants.py; every bounded family, CRI and MRC:
  tests/test_torch_models_bounded.py);
- the spec contract errors, the sort-window budget guard and the chunk
  dispatcher's closed forms.

Every spec is built by the JAX package and carried into the port through
its codec JSON.
"""

import dataclasses

import numpy as np
import pytest

from pluss import engine as jax_engine
from pluss import models as jax_models
from pluss import sched as jax_sched
from pluss import spec as jax_spec
from pluss.config import SamplerConfig as JaxConfig
from pluss.spec_codec import spec_to_json as jax_spec_to_json
from pluss_torch import engine, sched, spec
from pluss_torch.config import SamplerConfig
from pluss_torch.spec_codec import spec_from_json

TRI_MODELS = ["cholesky", "lu", "ludcmp", "trmm", "symm", "durbin",
              "syrk_tri", "correlation", "gramschmidt"]


def carried(model: str, n: int):
    return spec_from_json(jax_spec_to_json(jax_models.REGISTRY[model](n)))


def flat_dict(fr) -> dict:
    """A FlatRef of either package as plain data."""
    return dataclasses.asdict(fr)


def assert_same_result(got, want):
    assert got.max_iteration_count == want.max_iteration_count
    np.testing.assert_array_equal(got.noshare_dense, want.noshare_dense)
    assert got.share_raw == want.share_raw
    assert got.noshare_list() == want.noshare_list()
    assert got.share_list() == want.share_list()


def run_both(model, n, kw=None, **run_kw):
    kw = kw or {}
    want = jax_engine.run(jax_models.REGISTRY[model](n), JaxConfig(**kw),
                          **run_kw)
    got = engine.run(carried(model, n), SamplerConfig(**kw), device="cpu",
                     **run_kw)
    assert_same_result(got, want)
    return got, want


@pytest.mark.parametrize("win", [None, 1])
@pytest.mark.parametrize("n", [13, 16, 40])   # 40: several windows
@pytest.mark.parametrize("model", TRI_MODELS)
def test_plan_matches_jax(model, n, win):
    jp = jax_engine.plan(jax_models.REGISTRY[model](n), JaxConfig(),
                         window_accesses=win, build_overlays=False)
    tp = engine.plan(carried(model, n), SamplerConfig(), window_accesses=win)
    assert tp.pos_dtype == jp.pos_dtype
    assert tp.total_count == jp.total_count
    np.testing.assert_array_equal(tp.iters_per_thread, jp.iters_per_thread)
    np.testing.assert_array_equal(tp.nest_base, jp.nest_base)
    assert len(tp.nests) == len(jp.nests)
    for a, b in zip(tp.nests, jp.nests):
        assert (a.window_rounds, a.n_windows, a.body) == \
            (b.window_rounds, b.n_windows, b.body)
        np.testing.assert_array_equal(a.owned, b.owned)
        assert (a.clock is None) == (b.clock is None)
        if a.clock is not None:
            np.testing.assert_array_equal(a.clock, b.clock)
        assert [flat_dict(f) for f in a.refs] == [flat_dict(f) for f in b.refs]
        assert (a.tri_buckets is None) == (b.tri_buckets is None)
        for (wa, ra), (wb, rb) in zip(a.tri_buckets or (),
                                      b.tri_buckets or ()):
            assert wa == wb
            assert [flat_dict(f) for f in ra] == [flat_dict(f) for f in rb]
        assert (a.rpg_hist is None) == (b.rpg_hist is None)
        if a.rpg_hist is not None:
            np.testing.assert_array_equal(a.rpg_hist, b.rpg_hist)
        assert a.static_share == b.static_share
        assert (a.tpl is None) == (b.tpl is None)
        np.testing.assert_array_equal(a.ultra_windows(), b.ultra_windows())
        assert [f.ref.name for f in a.var_refs] == \
            [f.ref.name for f in b.var_refs]


def test_plan_cases_reach_every_triangular_part():
    """The parity matrix reaches size buckets, quad refs, row-private and
    sweep-group tables, and a nest whose every array is closed-form."""
    seen = set()
    for model in TRI_MODELS:
        for np_ in engine.plan(carried(model, 40),
                               window_accesses=1).nests:
            seen.add(("buckets", np_.tri_buckets is not None))
            seen.add(("quad", any(f.offset_g2 or any(f.pos_quads)
                                  for f in np_.refs)))
            seen.add(("rpg", np_.rpg_hist is not None))
            seen.add(("static_share", np_.static_share is not None))
            seen.add(("no_sort", np_.clock is not None and not np_.refs))
    assert {("buckets", True), ("quad", True), ("rpg", True),
            ("static_share", True), ("no_sort", True)} <= seen


@pytest.mark.parametrize("model,n,kw,win", [
    ("syrk_tri", 24, {}, 1),          # buckets; closed-form C and A
    ("trmm", 24, {"cls": 8}, 1),      # varying starts in every bucket
    ("cholesky", 24, {}, 1),          # quad refs, transitive bucket clamp
    ("symm", 16, {"cls": 8}, 64),     # empty bounded loop at i = 0
    ("covariance", 13, {"thread_num": 3, "chunk_size": 5, "cls": 16}, None),
])
def test_run_matches_jax_windowed(model, n, kw, win):
    run_both(model, n, kw, window_accesses=win)


def shifted_assignment(js, cfg: JaxConfig):
    """Per nest, the FIFO grant order where thread (c+1)%T asks first
    each round (tests/test_engine.py's dynamic assignment)."""
    out = []
    for nest in js.nests:
        sc = jax_sched.ChunkSchedule(cfg.chunk_size, nest.trip, nest.start,
                                     nest.step, cfg.thread_num)
        out.append(tuple((c + 1) % cfg.thread_num
                         for c in range(sc.n_chunks)))
    return tuple(out)


@pytest.mark.parametrize("model", ["gemm", "trmm", "cholesky", "syrk_tri",
                                   "durbin"])
def test_assignment_matches_jax(model):
    js = jax_models.REGISTRY[model](16)
    asg = shifted_assignment(js, JaxConfig(cls=8))
    run_both(model, 16, {"cls": 8}, assignment=asg)
    assert engine.plan(carried(model, 16), SamplerConfig(cls=8),
                       assignment=asg).nests[0].tpl is None


@pytest.mark.parametrize("model", ["gemm", "trmm", "cholesky", "syrk_tri",
                                   "durbin"])
def test_start_point_matches_jax(model):
    nest = jax_models.REGISTRY[model](16).nests[0]
    # resume at the value of parallel index 8 (durbin's loop starts at 1)
    run_both(model, 16, {"cls": 8}, start_point=nest.start + 8 * nest.step)


def test_bad_assignment_raises():
    spec_ = carried("trmm", 16)
    with pytest.raises(ValueError, match="covers"):
        engine.plan(spec_, assignment=((0, 1),))
    with pytest.raises(ValueError, match="out of range"):
        engine.plan(spec_, assignment=((0, 1, 2, 9),))


def test_buckets_shrink_the_bounded_trips():
    """cholesky's size buckets cut its bounded levels (the quad level
    transitively) to each bucket's own parallel-index range."""
    np_ = engine.plan(carried("cholesky", 64), window_accesses=1).nests[0]
    buckets = np_.tri_buckets
    assert len(buckets) == 4
    full = {f.ref.name: f.trips for f in np_.refs}
    first = {f.ref.name: f.trips for f in buckets[0][1]}
    last = {f.ref.name: f.trips for f in buckets[-1][1]}
    assert first["A0"] < last["A0"] <= full["A0"]
    assert all(a <= b for n in first for a, b in zip(first[n], last[n]))


def both_raise(build, match):
    """The same nest, built with each package's classes, is refused by
    both flattens with the same message."""
    for mod in (jax_spec, spec):
        with pytest.raises(ValueError, match=match) as e:
            mod.flatten_nest(build(mod))
        yield e.value


def test_validation_errors():
    """tests/test_triangular.py::test_validation_errors, for the port."""
    L, R = spec.Loop, spec.Ref
    outer = lambda m: m.Loop(trip=4, bound_coef=(1, 1), body=(
        m.Ref("X0", "X", addr_terms=((0, 4),)),))
    codes = [e.code for e in both_raise(outer, "outermost")]
    assert codes == ["PL401", "PL401"]
    leaves = lambda m: m.Loop(trip=4, body=(
        m.Loop(trip=2, bound_coef=(1, 1), body=(
            m.Ref("X0", "X", addr_terms=((0, 4),)),)),))
    assert [e.code for e in both_raise(leaves, "leaves")] == ["PL402"] * 2
    deep = lambda m: m.Loop(trip=4, body=(
        m.Ref("X0", "X", addr_terms=((1, 4),)),))
    assert [e.code for e in both_raise(deep, "exceeds")] == ["PL403"] * 2
    # bounded-inside-bounded dispatches to the quad flatten; the affine
    # accounting alone still refuses it
    nested = L(trip=4, body=(
        L(trip=4, bound_coef=(1, 1), body=(
            L(trip=4, bound_coef=(1, 1), body=(
                R("X0", "X", addr_terms=((0, 4),)),)),)),))
    assert spec.nest_is_quad(nested)
    assert len(spec.flatten_nest(nested)) == 1
    with pytest.raises(ValueError, match="nest inside|quad"):
        spec.loop_size_affine(nested.body[0])
    # a bound naming the referenced level itself is outside the contract
    self_ref = lambda m: m.Loop(trip=4, body=(
        m.Loop(trip=4, body=(
            m.Loop(trip=4, bound_coef=(0, 1), bound_level=2, body=(
                m.Ref("X0", "X", addr_terms=((0, 4),)),)),)),))
    assert [e.code for e in both_raise(self_ref, "bound_level")] == \
        ["PL404"] * 2


def test_quad_sizes_match_jax():
    """Exact per-iteration sizes and the per-slot size rule of the quad
    and affine accountings."""
    for model in ("cholesky", "lu", "ludcmp", "trmm", "durbin"):
        for jn, tn in zip(jax_models.REGISTRY[model](13).nests,
                          carried(model, 13).nests):
            gs = np.arange(jn.trip)
            np.testing.assert_array_equal(spec.nest_iteration_sizes(tn, gs),
                                          jax_spec.nest_iteration_sizes(jn,
                                                                        gs))
            owned = engine._owned_matrix(
                sched.ChunkSchedule(4, tn.trip, tn.start, tn.step), 4)
            for a, b in zip(spec.slot_sizes(tn, owned, tn.trip, 4),
                            jax_spec.slot_sizes(jn, owned, jn.trip, 4)):
                np.testing.assert_array_equal(a, b)


def test_sort_budget_guard(monkeypatch):
    """A window stream beyond the device budget raises before any window
    runs; the estimate is the JAX package's."""
    sp = carried("cholesky", 64)
    pl = engine.plan(sp)
    jp = jax_engine.plan(jax_models.REGISTRY["cholesky"](64),
                         build_overlays=False)
    n_lines = sp.total_lines()
    assert engine.sort_window_bytes(pl.nests[0], pl.cfg, pl.pos_dtype,
                                    n_lines) == jax_engine.sort_window_bytes(
        jp.nests[0], jp.cfg, jp.pos_dtype, n_lines)
    with pytest.raises(RuntimeError, match="device budget"):
        engine.check_sort_budget(pl.nests, sp, pl.cfg, pl.pos_dtype, 1 << 20)
    engine.check_sort_budget(pl.nests, sp, pl.cfg, pl.pos_dtype,
                             engine.CPU_SORT_BUDGET)
    monkeypatch.setattr(engine, "CPU_SORT_BUDGET", 1 << 20)
    assert engine.sort_budget(engine.resolve_device("cpu")) == 1 << 20
    with pytest.raises(RuntimeError, match="device budget"):
        engine.run(sp, device="cpu")


@pytest.mark.parametrize("trip,cs,start,step,T", [
    (16, 4, 0, 1, 4), (13, 4, 0, 1, 3), (10, 3, 5, -1, 2), (7, 2, 1, 2, 4)])
def test_chunk_schedule_matches_jax(trip, cs, start, step, T):
    a = sched.ChunkSchedule(cs, trip, start, step, T)
    b = jax_sched.ChunkSchedule(cs, trip, start, step, T)
    assert a.last == b.last
    for cid in range(a.n_chunks):
        assert a.chunk_bounds(cid) == b.chunk_bounds(cid)
        assert a.chunk_owner(cid) == b.chunk_owner(cid)
        assert a.next_k_chunks(2, cid) == b.next_k_chunks(2, cid)
        assert a.prev_k_chunks(2, cid) == b.prev_k_chunks(2, cid)
    for i in (start + k * step for k in range(trip)):
        assert a.static_tid(i) == b.static_tid(i)
        assert a.static_chunk_id(i) == b.static_chunk_id(i)
        assert a.static_thread_local_pos(i) == b.static_thread_local_pos(i)
        assert a.start_chunk_of(i) == b.start_chunk_of(i)
        for t in range(T):
            assert a.chunks_of_thread_from(t, i) == \
                b.chunks_of_thread_from(t, i)
            assert a.static_start_chunk(i, t) == b.static_start_chunk(i, t)
    for t in range(T):
        want = jax_engine._owned_matrix(b, T, None, start + 4 * step)
        np.testing.assert_array_equal(
            engine._owned_matrix(a, T, None, start + 4 * step), want)
        assert [c for c in want[t] if c >= 0] == \
            a.chunks_of_thread_from(t, start + 4 * step)
