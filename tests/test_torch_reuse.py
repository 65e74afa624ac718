"""The port's reuse primitives vs their JAX counterparts on the same inputs.

Inputs come from numpy seeds.  The port works on ``[T, n]`` batches; the
JAX functions take one window, so each row is compared with the JAX result
on that row.  Everything here is integer-valued: every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pluss.ops import reuse as jr
from pluss_torch.ops import reuse as tr

T = 4


def random_stream(seed, n=2000, n_lines=300, pos_dtype=np.int32):
    """[T, n] (line, pos, span, valid) in stream (not sorted) order, with
    distinct positions per row."""
    rng = np.random.default_rng(seed)
    line = rng.integers(0, n_lines, (T, n)).astype(np.int32)
    pos = np.stack([rng.permutation(4 * n)[:n] for _ in range(T)])
    pos = pos.astype(pos_dtype)
    span = np.where(rng.random((T, n)) < 0.3,
                    rng.integers(1, 3 * n, (T, n)), 0).astype(np.int32)
    valid = rng.random((T, n)) < 0.9
    return line, pos, span, valid


def ghosted(seed, n=2000, n_lines=300, pos_dtype=np.int32):
    """A stream plus one ghost per line (pos -1 or below the window start
    ``4n``), sorted by the JAX sort; returns numpy arrays + ``win_start``."""
    rng = np.random.default_rng(seed + 100)
    line, pos, span, valid = random_stream(seed, n, n_lines, pos_dtype)
    pos = pos + 4 * n
    gpos = np.where(rng.random((T, n_lines)) < 0.4, -1,
                    rng.integers(0, 4 * n, (T, n_lines))).astype(pos_dtype)
    gl = np.broadcast_to(np.arange(n_lines, dtype=np.int32), (T, n_lines))
    cat = lambda a, b: np.concatenate([a, b], axis=1)
    line, pos = cat(line, gl), cat(pos, gpos)
    span = cat(span, np.zeros((T, n_lines), np.int32))
    valid = cat(valid, np.ones((T, n_lines), bool))
    rows = [jr.sort_stream(jnp.asarray(line[t]), jnp.asarray(pos[t]),
                           jnp.asarray(span[t]), jnp.asarray(valid[t]))
            for t in range(T)]
    key_s, pos_s, span_s, valid_s = (np.stack([np.asarray(r[i]) for r in rows])
                                     for i in range(4))
    return key_s, pos_s, span_s, valid_s.astype(bool), 4 * n


@pytest.mark.parametrize("pos_dtype", [np.int32, np.int64])
def test_sort_stream_matches_jax(pos_dtype):
    line, pos, span, valid = random_stream(0, pos_dtype=pos_dtype)
    if pos_dtype == np.int64:
        pos = pos + (3 << 31)   # positions past the int32 range
    got = tr.sort_stream(*(torch.from_numpy(a) for a in
                           (line, pos, span, valid)))
    for t in range(T):
        want = jr.sort_stream(jnp.asarray(line[t]), jnp.asarray(pos[t]),
                              jnp.asarray(span[t]), jnp.asarray(valid[t]))
        for g, w in zip(got, want):
            w = np.asarray(w)   # JAX's valid_s is int32, the port's bool
            np.testing.assert_array_equal(
                g[t].numpy(), w.astype(bool) if g.dtype == torch.bool else w)
    assert got[0].dtype == torch.int32 and got[3].dtype == torch.bool
    assert got[1].dtype == torch.from_numpy(pos).dtype


def test_sort_stream_keeps_negative_positions_in_order():
    # ghosts carry pos -1: the packed int32 key must order them first
    line = torch.tensor([[3, 3, 1, 3]], dtype=torch.int32)
    pos = torch.tensor([[7, -1, 5, 2]], dtype=torch.int32)
    key_s, pos_s, _, _ = tr.sort_stream(line, pos, torch.zeros_like(line),
                                        torch.ones_like(line, dtype=bool))
    assert key_s.tolist() == [[1, 3, 3, 3]]
    assert pos_s.tolist() == [[5, -1, 2, 7]]


@pytest.mark.parametrize("pos_dtype", [np.int32, np.int64])
def test_carried_events_matches_jax(pos_dtype):
    key_s, pos_s, span_s, valid_s, ws = ghosted(1, pos_dtype=pos_dtype)
    got = tr.carried_events(torch.from_numpy(key_s), torch.from_numpy(pos_s),
                            torch.from_numpy(span_s),
                            torch.from_numpy(valid_s),
                            torch.full((T,), ws, dtype=torch.from_numpy(
                                pos_s).dtype))
    for t in range(T):
        want = jr.carried_events(jnp.asarray(key_s[t]), jnp.asarray(pos_s[t]),
                                 jnp.asarray(span_s[t]),
                                 jnp.asarray(valid_s[t].astype(np.int32)),
                                 pos_dtype(ws))
        for k in ("reuse", "is_evt", "share", "cold"):
            np.testing.assert_array_equal(got[k][t].numpy(),
                                          np.asarray(want[k]), err_msg=k)
    assert got["share"].any() and got["cold"].any()


def test_extract_tails_matches_jax():
    key_s, pos_s, _, valid_s, _ = ghosted(2)
    got = tr.extract_tails(torch.from_numpy(key_s), torch.from_numpy(pos_s),
                           torch.from_numpy(valid_s), 300)
    for t in range(T):
        want = jr.extract_tails(jnp.asarray(key_s[t]), jnp.asarray(pos_s[t]),
                                jnp.asarray(valid_s[t].astype(np.int32)), 300)
        np.testing.assert_array_equal(got[t].numpy(), np.asarray(want))


def test_ghost_entries_match_jax():
    rng = np.random.default_rng(3)
    last = rng.integers(-1, 1000, (T, 50)).astype(np.int32)
    got = tr.ghost_entries(torch.from_numpy(last), 17)
    for t in range(T):
        want = jr.ghost_entries(jnp.asarray(last[t]), 17, jnp.int32)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[t].numpy(), np.asarray(w))


def test_share_unique_matches_jax():
    rng = np.random.default_rng(4)
    reuse = rng.integers(1, 60, (T, 3000)).astype(np.int32)
    share = rng.random((T, 3000)) < 0.4
    keys, cnts = tr.share_unique(tr.share_keys(torch.from_numpy(reuse),
                                               torch.from_numpy(share)))
    keys, cnts = keys.numpy(), cnts.numpy()
    tid = keys >> tr.SHARE_SHIFT
    vals = keys & ((1 << tr.SHARE_SHIFT) - 1)
    for t in range(T):
        sv, sc, nu = jr.share_unique({"reuse": jnp.asarray(reuse[t]),
                                      "share": jnp.asarray(share[t])}, 128)
        sv, sc = np.asarray(sv), np.asarray(sc)
        want = {int(v): int(c) for v, c in zip(sv, sc) if c}
        mine = {int(v): int(c) for v, c in zip(vals[tid == t],
                                               cnts[tid == t])}
        assert mine == want and int(nu) == len(want)


def test_share_unique_sums_weighted_keys():
    keys = torch.tensor([5, 9, 5, 9, 9, 2], dtype=torch.int64)
    u, c = tr.share_unique(keys, torch.tensor([1, 2, 3, 4, 5, 6]))
    assert u.tolist() == [2, 5, 9] and c.tolist() == [6, 4, 11]


def test_bin_histogram_matches_jax():
    rng = np.random.default_rng(5)
    bins = rng.integers(0, 49, (T, 5000)).astype(np.int32)
    wgt = (rng.random((T, 5000)) < 0.6).astype(np.int32)
    got = tr.bin_histogram(torch.from_numpy(bins),
                           torch.from_numpy(wgt)).numpy()
    for t in range(T):
        want = np.asarray(jr.bin_histogram(jnp.asarray(bins[t]),
                                           jnp.asarray(wgt[t])))
        np.testing.assert_array_equal(got[t], want)
    # out-of-range bins weigh nothing, as in the one-hot form
    odd = tr.bin_histogram(torch.tensor([0, 49, 60, -1, 3]),
                           torch.ones(5, dtype=torch.int32))
    assert odd.sum() == 2 and odd[0] == 1 and odd[3] == 1


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_log2_bin_and_share_mask_match_jax(dtype):
    edge = [0, 1, 2, 3, 4, 7, 8, 1023, 1024, 2**31 - 1]
    if dtype == np.int64:
        edge += [2**31, 2**40 + 1, 2**47 - 1, 2**47]
    rng = np.random.default_rng(6)
    reuse = np.concatenate([np.array(edge, dtype),
                            rng.integers(0, 2**31 - 1, 500).astype(dtype)])
    np.testing.assert_array_equal(
        tr.log2_bin(torch.from_numpy(reuse)).numpy(),
        np.asarray(jr.log2_bin(jnp.asarray(reuse))))
    span = rng.integers(-3, 2**31 - 1, reuse.shape).astype(np.int32)
    np.testing.assert_array_equal(
        tr.share_mask(torch.from_numpy(reuse), torch.from_numpy(span)).numpy(),
        np.asarray(jr.share_mask(jnp.asarray(reuse), jnp.asarray(span))))
