"""The port's carried-event histogram vs the JAX package's fused kernel.

Inputs are ghost-merged, (line, pos)-sorted ``[T, L]`` windows made with
numpy from a seed: real accesses at distinct positions from each row's own
``win_start``, one ghost per line (some never touched, pos -1; the rest
carried from before the window), share spans on a share of the accesses,
and an invalid tail.  The JAX side runs ``pallas_events.
event_histogram_fused`` row by row (the Pallas interpreter on the CPU, as
tests/test_pallas_events.py runs it); the port runs
``event_histogram_plain`` on the whole batch.  Histograms are integers:
the comparison is exact.
"""

import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pluss.ops import pallas_events
from pluss.ops.reuse import carried_events as jax_carried_events
from pluss.ops.reuse import event_histogram as jax_event_histogram
from pluss_torch.ops import event_hist
from pluss_torch.ops.event_hist import (event_histogram,
                                        event_histogram_plain)
from pluss_torch.ops.reuse import LINE_SENTINEL


def sorted_windows(seed, T=4, n_real=3000, n_lines=700):
    """numpy ``[T, L]`` (key, pos, span, valid) sorted windows + ``[T]``
    window starts (int64 positions; callers cast)."""
    rng = np.random.default_rng(seed)
    rows, starts = [], []
    for _ in range(T):
        w0 = int(rng.integers(1_000, 100_000))
        line = rng.integers(0, n_lines, n_real)
        pos = w0 + rng.permutation(3 * n_real)[:n_real]
        span = np.where(rng.random(n_real) < 0.3,
                        rng.integers(1, 6 * n_real, n_real), 0)
        valid = rng.random(n_real) < 0.95
        gpos = np.where(rng.random(n_lines) < 0.3, -1,
                        rng.integers(0, w0, n_lines))
        line = np.concatenate([line, np.arange(n_lines)])
        pos = np.concatenate([pos, gpos])
        span = np.concatenate([span, np.zeros(n_lines, np.int64)])
        valid = np.concatenate([valid, np.ones(n_lines, bool)])
        key = np.where(valid, line, LINE_SENTINEL)
        order = np.lexsort((pos, key))
        rows.append((key[order], pos[order], span[order], valid[order]))
        starts.append(w0)
    key, pos, span, valid = (np.stack(a) for a in zip(*rows))
    return (key.astype(np.int32), pos, span.astype(np.int32), valid,
            np.array(starts, np.int64))


def as_torch(key, pos, span, valid, ws, dtype):
    return (torch.from_numpy(key), torch.from_numpy(pos).to(dtype),
            torch.from_numpy(span), torch.from_numpy(valid),
            torch.from_numpy(ws).to(dtype))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_jax_fused_kernel_int32(seed):
    key, pos, span, valid, ws = sorted_windows(seed)
    got = event_histogram_plain(*as_torch(key, pos, span, valid, ws,
                                          torch.int32)).numpy()
    for t in range(key.shape[0]):
        want = np.asarray(pallas_events.event_histogram_fused(
            jnp.asarray(key[t]), jnp.asarray(pos[t].astype(np.int32)),
            jnp.asarray(span[t]), jnp.asarray(valid[t].astype(np.int32)),
            np.int32(ws[t]), jnp.int32))
        np.testing.assert_array_equal(got[t], want)
    assert got[:, 0].sum() > 0 and got[:, 1:].sum() > 0  # cold and events


def test_plain_matches_jax_int64_positions():
    # int64 plans (past 2^31 accesses per thread) bin with the 64-bit clz;
    # positions above 2^31 exercise it.  The JAX side is the XLA
    # composition the fused kernel replaces.
    key, pos, span, valid, ws = sorted_windows(3)
    pos = np.where(pos >= 0, pos + (5 << 31), pos)
    ws = ws + (5 << 31)
    got = event_histogram_plain(*as_torch(key, pos, span, valid, ws,
                                          torch.int64)).numpy()
    for t in range(key.shape[0]):
        ev = jax_carried_events(jnp.asarray(key[t]), jnp.asarray(pos[t]),
                                jnp.asarray(span[t]),
                                jnp.asarray(valid[t].astype(np.int32)),
                                np.int64(ws[t]))
        np.testing.assert_array_equal(got[t],
                                      np.asarray(jax_event_histogram(ev)))


def test_wrapper_takes_plain_version_on_cpu():
    args = as_torch(*sorted_windows(4), torch.int32)
    before = event_histogram.launches
    assert torch.equal(event_histogram(*args), event_histogram_plain(*args))
    assert event_histogram.launches == before   # no kernel launched


def test_wrapper_checks_its_inputs():
    key, pos, span, valid, ws = as_torch(*sorted_windows(5, T=2),
                                         torch.int32)
    bad = [
        (key.to(torch.int64), pos, span, valid, ws),       # key dtype
        (key, pos.to(torch.int16), span, valid, ws),       # pos dtype
        (key, pos, span, valid.to(torch.int32), ws),       # valid dtype
        (key, pos, span, valid, ws.to(torch.int64)),       # ws dtype
        (key, pos, span[:, :-1], valid, ws),               # shape
        (key, pos, span, valid, ws[:1]),                   # ws shape
        (key[0], pos[0], span[0], valid[0], ws[:1]),       # not [T, L]
        (key.t().contiguous().t(), pos, span, valid, ws),  # strides
    ]
    for args in bad:
        with pytest.raises(ValueError):
            event_histogram(*args)


def test_cuda_branch_never_reaches_plain_version(monkeypatch):
    """The plain version is called only under the CPU test of the wrapper;
    the kernel branch (``_launch``) never names it, and a tensor on any
    other device is refused without falling back."""
    tree = ast.parse(inspect.getsource(event_hist.event_histogram))
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", "") == "event_histogram_plain"]
    assert len(calls) == 1
    cpu_if = [n for n in ast.walk(tree) if isinstance(n, ast.If)
              and "'cpu'" in ast.unparse(n.test)]
    assert len(cpu_if) == 1 and calls[0] in list(ast.walk(cpu_if[0]))
    assert "plain" not in inspect.getsource(event_hist._launch)

    def refuse(*a):
        raise AssertionError("plain version reached off the CPU")

    monkeypatch.setattr(event_hist, "event_histogram_plain", refuse)
    monkeypatch.setattr(event_hist, "_launch", refuse)
    args = as_torch(*sorted_windows(6, T=2), torch.int32)
    with pytest.raises(ValueError, match="no event-histogram kernel"):
        event_histogram(*(a.to("meta") for a in args))
