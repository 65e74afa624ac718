"""Property tests of the port: random specs, schedules and traces through
the port and the JAX package, equal to each other and to the oracle.

The port's twin of tests/test_property.py and tests/test_trace_property.py.
The loop nests come from the port's own strategies
(:func:`pluss_torch.soak.specs`, :func:`~pluss_torch.soak.configs`,
:func:`~pluss_torch.soak.schedules`), drawn derandomized so every run of
the suite draws the same examples; each drawn spec crosses into the JAX
package through the spec codec.  ``pluss_torch.engine.run`` on the CPU
must equal ``pluss.engine.run`` and the oracle thread by thread (under
windows, dynamic assignments and start points), and ``shard_run`` over 1,
2 and 8 CPU workers in both dispatch modes must equal ``pluss.engine.run``.
A spec that both packages refuse counts as equal only when both raise the
same exception type.  The trace half holds the port's segmented batch
against its legacy scan and the JAX package's step across the wires, and
``trace.replay_file`` (segmented and legacy, pack and d24v, one and three
feed workers, the line table grown from 8 entries, a ``trace_loss``
checkpoint/resume split) against ``pluss.trace.replay_file``.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="hypothesis not installed")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from pluss import engine as jax_engine  # noqa: E402
from pluss import spec_codec as jax_codec  # noqa: E402
from pluss import trace as jt  # noqa: E402
from pluss.config import NBINS  # noqa: E402
from pluss.config import SamplerConfig as JaxConfig  # noqa: E402
from pluss_torch import engine, soak  # noqa: E402
from pluss_torch import trace as tt  # noqa: E402
from pluss_torch.ops import wirecodec  # noqa: E402
from pluss_torch.parallel.shard import shard_run  # noqa: E402
from pluss_torch.resilience import faults  # noqa: E402
from pluss_torch.resilience.errors import DataLoss  # noqa: E402
from pluss_torch.spec_codec import spec_to_json  # noqa: E402
from tests.oracle import OracleSampler  # noqa: E402

#: the same examples on every run (the JAX files draw unseeded)
DRAWN = dict(deadline=None, database=None, derandomize=True)


def jax_twin(spec, cfg):
    """The JAX package's spec and config of a port draw."""
    return (jax_codec.spec_from_json(spec_to_json(spec)),
            JaxConfig(thread_num=cfg.thread_num, chunk_size=cfg.chunk_size,
                      ds=cfg.ds, cls=cfg.cls))


def outcome(fn):
    """``(result, None)``, or ``(None, exception type)`` when ``fn``
    refuses."""
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001 — compared by type below
        return None, type(e)


def assert_threadwise(got, want, cfg) -> None:
    """The port's result equals the JAX package's, thread by thread."""
    assert got.max_iteration_count == want.max_iteration_count
    for t in range(cfg.thread_num):
        assert got.noshare_dict(t) == want.noshare_dict(t), f"tid {t}"
        assert got.share_dict(t) == want.share_dict(t), f"tid {t}"


def assert_oracle(r, o, cfg) -> None:
    assert r.max_iteration_count == o.max_iteration_count
    for t in range(cfg.thread_num):
        assert r.noshare_dict(t) == o.noshare[t], f"tid {t} noshare"
        want = {k: dict(v) for k, v in o.share[t].items() if v}
        assert r.share_dict(t) == want, f"tid {t} share"


def check_run(spec, cfg, **kw) -> None:
    """Port == JAX == oracle, or both packages refuse alike."""
    jspec, jcfg = jax_twin(spec, cfg)
    want, want_err = outcome(lambda: jax_engine.run(jspec, jcfg, **kw))
    got, got_err = outcome(lambda: engine.run(spec, cfg, device="cpu",
                                              **kw))
    assert got_err == want_err
    if want_err is not None:
        return
    assert_threadwise(got, want, cfg)
    o = OracleSampler(jspec, jcfg).run(
        assignment=kw.get("assignment"), start_point=kw.get("start_point"))
    assert_oracle(got, o, cfg)


@settings(max_examples=25, **DRAWN)
@given(spec=soak.specs(), cfg=soak.configs(),
       window=st.sampled_from([None, 64, 256]))
def test_random_specs_match_jax_and_oracle(spec, cfg, window):
    check_run(spec, cfg, window_accesses=window)


@settings(max_examples=15, **DRAWN)
@given(args=soak.schedules())
def test_random_schedules_match_jax_and_oracle(args):
    spec, cfg, asg, sp = args
    check_run(spec, cfg, assignment=asg, start_point=sp)


@settings(max_examples=10, **DRAWN)
@given(spec=soak.specs(), cfg=soak.configs())
def test_random_specs_shard_match_jax(spec, cfg):
    jspec, jcfg = jax_twin(spec, cfg)
    want, want_err = outcome(lambda: jax_engine.run(jspec, jcfg))
    for D in (1, 2, 8):
        for dispatch in ("steal", "static"):
            got, got_err = outcome(lambda: shard_run(
                spec, cfg, devices=["cpu"] * D, dispatch=dispatch))
            assert got_err == want_err, (D, dispatch)
            if want_err is None:
                assert_threadwise(got, want, cfg)


def test_strategies_draw_the_jax_shapes():
    """The port's draws cover what the JAX file's do: bounded, quad
    (``bound_level``), varying-start and multi-nest specs, and schedules
    with assignments and with start points."""
    seen = set()

    @settings(max_examples=60, **DRAWN)
    @given(args=soak.schedules())
    def collect(args):
        spec, cfg, asg, sp = args

        def loops(items):
            for it in items:
                if hasattr(it, "trip"):
                    yield it
                    yield from loops(it.body)

        every = list(loops(spec.nests))
        seen.update(k for k, v in (
            ("bounded", any(lp.bound_coef for lp in every)),
            ("quad", any(lp.bound_level for lp in every)),
            ("start", any(lp.start_coef for lp in every)),
            ("nests", len(spec.nests) > 1),
            ("assignment", asg is not None),
            ("start_point", sp is not None)) if v)

    collect()
    assert seen == {"bounded", "quad", "start", "nests", "assignment",
                    "start_point"}


# --- the trace half ----------------------------------------------------------

WINDOW = 64
BW = 4
BATCH = WINDOW * BW
WIRE_FORMATS = ("u16", "u24", "i32wire", "i32", "d24v")


def _wire(ids: np.ndarray, fmt: str):
    """A dense-id batch on one of the port's wires."""
    if fmt == "u16":
        return tt._pack16(ids)
    if fmt == "u24":
        return tt._pack24(ids)
    if fmt == "i32wire":   # the >2^24-line pack: LE int32 bytes
        return np.ascontiguousarray(
            ids.astype("<i4").view(np.uint8).reshape(-1, 4))
    if fmt == "d24v":
        return tt._encode_wire(ids, 1 << 20, "d24v")
    return ids.astype(np.int32)


def _jax_wire(ids: np.ndarray, fmt: str) -> np.ndarray:
    if fmt == "u16":
        return ids.astype(np.uint16)
    if fmt == "u24":
        return jt._pack24(ids)
    if fmt == "i32wire":
        return np.ascontiguousarray(
            ids.astype("<i4").view(np.uint8).reshape(-1, 4))
    return ids.astype(np.int32)


def _port_batches(ids, n_lines, n_valid, segmented, fmt):
    """The port's batch step chained over the batches, as
    ``trace._replay_ids`` chains it."""
    pdt = torch.int32
    step = tt._batch_fn(segmented, WINDOW)
    last = torch.full((n_lines + 1,), -1, dtype=pdt)
    hist = torch.zeros(NBINS, dtype=torch.int64)
    for b in range(len(ids) // BATCH):
        t = tt._to_device_ids(_wire(ids[b * BATCH:(b + 1) * BATCH], fmt),
                              torch.device("cpu"), BATCH,
                              wirecodec.decode_d24v_plain)
        step(last, hist, b * BATCH, t, n_valid, pdt, None)
    return last[:n_lines].numpy(), hist.numpy()


def _jax_batches(ids, n_lines, n_valid, fmt):
    pdt = np.dtype("int32")
    fn = jt._replay_fn(WINDOW, "int32", segmented=True)
    last = jnp.full((n_lines,), -1, pdt)
    hist = jnp.zeros((NBINS,), pdt)
    for b in range(len(ids) // BATCH):
        w = _jax_wire(ids[b * BATCH:(b + 1) * BATCH],
                      "i32" if fmt == "d24v" else fmt)
        shaped = w.reshape((BW, WINDOW) + w.shape[1:])
        last, hist = fn(last, hist, pdt.type(b * BATCH),
                        jnp.asarray(shaped), pdt.type(n_valid))
    return np.asarray(last), np.asarray(hist)


@settings(max_examples=25, **DRAWN)
@given(seed=st.integers(0, 2**32 - 1), n_lines=st.sampled_from([8, 64]),
       fmt=st.sampled_from(WIRE_FORMATS), tail=st.integers(0, BATCH))
def test_batch_step_matches_legacy_and_jax_across_wires(seed, n_lines, fmt,
                                                        tail):
    """Two chained batches (the carried last_pos crosses them), a ragged
    valid tail: segmented == legacy scan == the JAX package's step, and
    every valid access lands in the histogram once."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_lines, 2 * BATCH, dtype=np.int32)
    n_valid = BATCH + tail
    seg_last, seg_hist = _port_batches(ids, n_lines, n_valid, True, fmt)
    leg_last, leg_hist = _port_batches(ids, n_lines, n_valid, False, fmt)
    jax_last, jax_hist = _jax_batches(ids, n_lines, n_valid, fmt)
    np.testing.assert_array_equal(seg_hist, leg_hist)
    np.testing.assert_array_equal(seg_last, leg_last)
    np.testing.assert_array_equal(seg_hist, jax_hist)
    np.testing.assert_array_equal(seg_last, jax_last)
    assert int(seg_hist.sum()) == n_valid


def check_replay_file(seed: int, sparse: bool, bw: int, fault_at: int,
                      wire: str, feed_workers: int) -> None:
    """The port's ``replay_file`` segmented and legacy, with the line table
    grown from 8 entries, equal to ``pluss.trace.replay_file``; a
    ``trace_loss`` fault mid-stream, then a resume from the checkpoint,
    equal to the uninterrupted replay."""
    window = 1 << 8
    rng = np.random.default_rng(seed)
    n = bw * window * 8 - int(rng.integers(0, window))
    if sparse:
        base = rng.integers(0, 1 << 40, 30, dtype=np.int64) * 64
        addrs = base[rng.integers(0, 30, n)]
    else:
        addrs = rng.integers(0, 1 << 10, n, dtype=np.int64) * 64
    geo = dict(window=window, batch_windows=bw, initial_capacity=8)
    feed = dict(wire=wire, feed_workers=feed_workers)
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "t.bin")
        addrs.astype("<u8").tofile(p)
        want = jt.replay_file(p, segmented=True, wire="pack",
                              feed_workers=1, **geo)
        seg = tt.replay_file(p, device="cpu", segmented=True, **feed, **geo)
        leg = tt.replay_file(p, device="cpu", segmented=False, **feed,
                             **geo)
        for got in (seg, leg):
            np.testing.assert_array_equal(got.hist, want.hist)
            assert got.total_count == want.total_count == n
            assert got.n_lines == want.n_lines

        ckpt = os.path.join(td, "t.ckpt.npz")
        faults.install(faults.FaultPlan.parse(f"trace_loss@{fault_at}"))
        try:
            with pytest.raises(DataLoss):
                tt.replay_file(p, device="cpu", segmented=True,
                               checkpoint_path=ckpt, checkpoint_every=1,
                               **feed, **geo)
        finally:
            faults.install(None)
        # an early fault may beat the first checkpoint write (the reader
        # runs ahead of the consumer): the resume then starts fresh
        res = tt.replay_file(p, device="cpu", segmented=True,
                             checkpoint_path=ckpt, resume=True, **feed,
                             **geo)
        np.testing.assert_array_equal(res.hist, want.hist)
        assert res.total_count == n


@settings(max_examples=8, **DRAWN)
@given(seed=st.integers(0, 2**32 - 1), sparse=st.booleans(),
       bw=st.sampled_from([2, 3]), fault_at=st.integers(2, 6))
def test_replay_file_growth_and_resume_match_jax(seed, sparse, bw, fault_at):
    check_replay_file(seed, sparse, bw, fault_at, "pack", 1)


@settings(max_examples=8, **DRAWN)
@given(seed=st.integers(0, 2**32 - 1), sparse=st.booleans(),
       bw=st.sampled_from([2, 3]), fault_at=st.integers(2, 6),
       feed_workers=st.sampled_from([1, 3]))
def test_replay_file_d24v_feed_matches_jax(seed, sparse, bw, fault_at,
                                           feed_workers):
    check_replay_file(seed, sparse, bw, fault_at, "d24v", feed_workers)
