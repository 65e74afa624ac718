"""The port's sampled iteration points (``pluss_torch.iteration``) vs the
JAX package's (``pluss.iteration``): the cases of
``tests/test_iteration.py`` on the port, and every vectorized function
equal to JAX's on the same seeded inputs.

The scalar :func:`compare` is the executable specification; the key
matrix must sort any batch identically.
"""

from __future__ import annotations

import functools
import random

import numpy as np
import pytest

from pluss import iteration as jit
from pluss.sched import ChunkSchedule as JaxSchedule
from pluss_torch.iteration import (HASH_IV_BITS, HASH_IV_SLOTS,
                                   IterationPoint, compare, dedup,
                                   interleaved_argsort, iv_bitmap,
                                   order_keys, point_hash)
from pluss_torch.sched import ChunkSchedule


def _sched(trip=32, cs=4, T=4):
    return ChunkSchedule(cs, trip, 0, 1, T)


def _random_points(rng, n, trip, depth, n_refs=4):
    """Random fixed-depth points; priority = ref id (distinct per ref)."""
    pts = []
    for _ in range(n):
        ref = rng.randrange(n_refs)
        ivs = tuple(rng.randrange(trip) for _ in range(depth))
        pts.append(IterationPoint(f"R{ref}", ivs, priority=n_refs - ref))
    return pts


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_lexsort_matches_scalar_comparator(depth):
    rng = random.Random(20260730 + depth)
    sched = _sched()
    pts = _random_points(rng, 200, sched.trip, depth)
    ivs = np.array([p.ivs for p in pts])
    prios = np.array([p.priority for p in pts])
    idx = interleaved_argsort(ivs, prios, sched)
    got = [pts[i] for i in idx]
    want = sorted(pts, key=functools.cmp_to_key(
        lambda a, b: compare(a, b, sched)))
    key = lambda p: (p.ivs, p.priority)  # noqa: E731
    assert [key(p) for p in got] == [key(p) for p in want]


def test_comparator_orders_by_round_pos_then_tid():
    sched = _sched(trip=32, cs=4, T=4)
    c = IterationPoint("A", (1, 0))      # cid 0, tid 0, pos 1
    d = IterationPoint("A", (16, 0))     # cid 1, tid 0, pos 0
    assert compare(IterationPoint("A", (0, 5)),
                   IterationPoint("A", (4, 0)), sched) == 1
    a2 = IterationPoint("A", (0, 7))
    b2 = IterationPoint("A", (4, 7))
    assert compare(a2, b2, sched) == -1
    assert compare(b2, c, sched) == -1
    assert compare(c, d, sched) == -1
    hi = IterationPoint("A", (0, 7), priority=2)
    lo = IterationPoint("B", (0, 7), priority=1)
    assert compare(hi, lo, sched) == -1
    assert compare(hi, hi, sched) == 0
    # outside a parallel region the schedule plays no part
    assert IterationPoint("A", (5,), parallel=False).decompose(sched) \
        == (0, 0, 0)


def test_single_thread_order_is_program_order():
    sched = _sched(trip=8, cs=2, T=2)
    walk = []
    for tid in range(2):
        per = []
        for cid in sched.chunks_of_thread(tid):
            b, e = sched.chunk_index_range(cid)
            for i in range(b, e):
                for j in range(4):
                    per.append(("R0", (i, j)))
                    per.append(("R1", (i, j)))
        walk.append(per)
    for tid in range(2):
        pts = [IterationPoint(nm, iv, priority=2 if nm == "R0" else 1)
               for nm, iv in walk[tid]]
        shuf = pts[:]
        random.Random(tid).shuffle(shuf)
        idx = interleaved_argsort(np.array([p.ivs for p in shuf]),
                                  np.array([p.priority for p in shuf]),
                                  sched)
        assert [(shuf[i].name, shuf[i].ivs) for i in idx] == walk[tid]


def test_mixed_depth_prefix_points():
    sched = _sched(trip=8, cs=4, T=2)
    pts = [
        IterationPoint("A0", (0, 1, 0), priority=2),
        IterationPoint("C0", (0, 1), priority=3),
        IterationPoint("B0", (0, 1, 0), priority=1),
        IterationPoint("C0", (0, 2), priority=3),
        IterationPoint("A0", (0, 1, 1), priority=2),
    ]
    want = sorted(pts, key=functools.cmp_to_key(
        lambda a, b: compare(a, b, sched)))
    ivs = np.zeros((len(pts), 3), np.int64)
    lens = np.array([len(p.ivs) for p in pts])
    for i, p in enumerate(pts):
        ivs[i, : len(p.ivs)] = p.ivs
    idx = interleaved_argsort(ivs, np.array([p.priority for p in pts]),
                              sched, lengths=lens)
    assert [(pts[i].name, pts[i].ivs) for i in idx] == \
        [(p.name, p.ivs) for p in want]
    assert [p.name for p in want] == ["C0", "A0", "B0", "A0", "C0"]


def test_iv_bitmap_packing_and_truncation():
    assert (HASH_IV_BITS, HASH_IV_SLOTS) == (jit.HASH_IV_BITS,
                                             jit.HASH_IV_SLOTS)
    bm = iv_bitmap(np.array([[1, 2, 3], [1, 2, 4]]))
    assert bm[0] == (1 << 2 * HASH_IV_BITS) | (2 << HASH_IV_BITS) | 3
    assert bm[0] != bm[1]
    assert iv_bitmap(np.array([[1, 2, 3, 7]]))[0] == \
        iv_bitmap(np.array([[1, 2, 3, 9]]))[0]


def test_point_hash_and_dedup():
    names = np.array([0, 0, 1, 0])
    ivs = np.array([[1, 2], [1, 2], [1, 2], [3, 4]])
    h = point_hash(names, ivs)
    assert h[0] == h[1] and h[0] != h[2]
    assert dedup(names, ivs).tolist() == [0, 2, 3]
    names4 = np.array([0, 0])
    ivs4 = np.array([[1, 2, 3, 7], [1, 2, 3, 9]])
    assert dedup(names4, ivs4).tolist() == [0, 1]
    assert point_hash(names4, ivs4)[0] == point_hash(names4, ivs4)[1]


def test_decompose_matches_schedule():
    sched = _sched(trip=64, cs=4, T=4)
    for v in range(0, 64, 7):
        cid, tid, pos = IterationPoint("X", (v, 0)).decompose(sched)
        assert cid == sched.static_chunk_id(v)
        assert tid == sched.static_tid(v)
        assert pos == sched.static_thread_local_pos(v)
        assert sched.chunk_owner(sched.start_chunk_of(v)) == tid


# --- equal to the JAX package's on seeded inputs ---------------------------

SCHEDULES = [(32, 4, 4, 0, 1), (40, 3, 3, 5, 2), (17, 1, 2, 0, 1),
             (24, 8, 4, 100, -1)]


def _batch(seed, trip, start, step, depth, ragged):
    rng = np.random.default_rng(seed)
    n = 300
    ivs = rng.integers(0, 50, (n, depth))
    ivs[:, 0] = start + step * rng.integers(0, trip, n)
    ivs[rng.random(n) < 0.2] = ivs[0]          # duplicates for dedup
    prios = rng.integers(1, 5, n)
    names = rng.integers(0, 3, n)
    lens = rng.integers(1, depth + 1, n) if ragged else None
    return ivs, prios, names, lens


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("depth", [1, 3, 4])
@pytest.mark.parametrize("geo", range(len(SCHEDULES)))
def test_vectorized_functions_match_jax(geo, depth, ragged):
    trip, cs, T, start, step = SCHEDULES[geo]
    sched = ChunkSchedule(cs, trip, start, step, T)
    jsched = JaxSchedule(cs, trip, start, step, T)
    ivs, prios, names, lens = _batch(geo * 10 + depth, trip, start, step,
                                     depth, ragged)
    got = order_keys(ivs, prios, sched, lengths=lens)
    want = jit.order_keys(ivs, prios, jsched, lengths=lens)
    assert len(got) == len(want)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert np.array_equal(
        interleaved_argsort(ivs, prios, sched, lengths=lens),
        jit.interleaved_argsort(ivs, prios, jsched, lengths=lens))
    assert np.array_equal(iv_bitmap(ivs, lens), jit.iv_bitmap(ivs, lens))
    assert np.array_equal(point_hash(names, ivs, lens),
                          jit.point_hash(names, ivs, lens))
    assert np.array_equal(dedup(names, ivs, lens),
                          jit.dedup(names, ivs, lens))


@pytest.mark.parametrize("geo", range(len(SCHEDULES)))
def test_scalar_compare_matches_jax(geo):
    trip, cs, T, start, step = SCHEDULES[geo]
    sched = ChunkSchedule(cs, trip, start, step, T)
    jsched = JaxSchedule(cs, trip, start, step, T)
    rng = random.Random(geo)
    vals = [start + step * i for i in range(trip)]
    pts = [(rng.choice(vals), rng.randrange(6), rng.randrange(1, 4))
           for _ in range(60)]
    for (v1, j1, p1), (v2, j2, p2) in nearby_pairs(pts):
        a, b = IterationPoint("A", (v1, j1), p1), \
            IterationPoint("B", (v2, j2), p2)
        ja, jb = jit.IterationPoint("A", (v1, j1), p1), \
            jit.IterationPoint("B", (v2, j2), p2)
        assert compare(a, b, sched) == jit.compare(ja, jb, jsched)
        assert a.decompose(sched) == ja.decompose(jsched)


def nearby_pairs(pts):
    return [(pts[i], pts[j]) for i in range(len(pts))
            for j in range(i + 1, min(len(pts), i + 8))]
