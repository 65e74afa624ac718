"""The port's CUDA kernels and trace replay on the card, against their
plain versions and the CPU.

Every test here carries the ``cuda`` marker and takes the ``cuda_device``
fixture, which skips it with a reason where there is no card; whether
there is one is decided when the test runs, never at import.  The file
imports neither jax nor ``pluss``, so it runs on a machine with the card
and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py

Inputs come from numpy seeds; everything is integer, so every comparison
is exact.
"""

import numpy as np
import pytest
import torch

from pluss_torch import trace
from pluss_torch.ops import wirecodec
from pluss_torch.ops.decode import decode_d24v
from pluss_torch.ops.event_hist import (event_histogram,
                                        event_histogram_plain,
                                        masked_histogram,
                                        masked_histogram_plain)
from pluss_torch.ops.reuse import sort_stream

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The CUDA card, or a skip when there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def wires():
    """Encoder outputs of raw, delta, ragged and reset-heavy streams, and
    a random wire no encoder writes (widths 0-7, sums that wrap)."""
    rng = np.random.default_rng(0)
    B = wirecodec.BLOCK
    streams = [
        rng.integers(0, 1 << 24, 5 * B + 3),
        np.arange(3 * B) + (1 << 22),
        ((1 << 24) - 1 - 3 * np.arange(2 * B)),
        np.concatenate([rng.integers(0, 1 << 23, B) if i % 2 else
                        np.arange(B) + (1 << 20) for i in range(8)]),
    ]
    out = [wirecodec.encode_d24v(s.astype(np.int32)) for s in streams]
    k = rng.integers(0, 8, 64)
    wm = (k | np.where(rng.random(64) < 0.3, wirecodec.RAW_MODE, 0)) \
        .astype(np.uint8)
    payload = rng.integers(0, 256, wirecodec.pad_len(
        wirecodec.used_bytes(wm)), dtype=np.uint8)
    return out + [(payload, wm)]


@pytest.mark.parametrize("i", range(5))
def test_decode_kernel_matches_plain(cuda_device, i):
    payload, wm = (torch.from_numpy(a) for a in wires()[i])
    before = decode_d24v.launches
    got = decode_d24v(payload.to(cuda_device), wm.to(cuda_device))
    assert decode_d24v.launches == before + 1
    assert torch.equal(got.cpu(), wirecodec.decode_d24v_plain(payload, wm))


def random_events(seed, n, wide):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, 52 if wide else 31, n)
    reuse = (np.int64(1) << e) + rng.integers(-3, 1000, n)
    reuse = np.where(rng.random(n) < 0.02, -reuse, reuse)
    is_evt = rng.random(n) < 0.8
    return [torch.from_numpy(a) for a in (
        reuse.astype(np.int64 if wide else np.int32), is_evt,
        rng.random(n) < 0.1, ~is_evt & (rng.random(n) < 0.5))]


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("include_cold", [True, False])
def test_masked_hist_kernel_matches_plain(cuda_device, wide, include_cold):
    args = random_events(1, 300_001, wide)
    before = masked_histogram.launches
    got = masked_histogram(*(a.to(cuda_device) for a in args),
                           include_cold=include_cold)
    assert masked_histogram.launches == before + 1
    assert torch.equal(got.cpu(), masked_histogram_plain(
        *args, include_cold=include_cold))


def test_masked_hist_refuses_an_empty_stream(cuda_device):
    args = [a[:0].to(cuda_device) for a in random_events(1, 8, False)]
    before = masked_histogram.launches
    with pytest.raises(ValueError, match="empty event stream"):
        masked_histogram(*args)
    assert masked_histogram.launches == before


@pytest.mark.parametrize("pdt", [torch.int32, torch.int64])
def test_event_hist_kernel_matches_plain(cuda_device, pdt):
    rng = np.random.default_rng(2)
    T, n, n_lines, ws = 3, 20_000, 2_000, 100_000
    line = rng.integers(0, n_lines, (T, n))
    pos = ws + np.stack([rng.permutation(3 * n)[:n] for _ in range(T)])
    gpos = np.where(rng.random((T, n_lines)) < 0.3, -1,
                    rng.integers(0, ws, (T, n_lines)))
    line = np.concatenate([line, np.tile(np.arange(n_lines), (T, 1))], 1)
    pos = np.concatenate([pos, gpos], 1)
    span = np.where(rng.random(line.shape) < 0.3, 5000, 0)
    valid = rng.random(line.shape) < 0.97
    sorted_ = sort_stream(torch.from_numpy(line.astype(np.int32)),
                          torch.from_numpy(pos).to(pdt),
                          torch.from_numpy(span.astype(np.int32)),
                          torch.from_numpy(valid))
    args = (*sorted_, torch.full((T,), ws, dtype=pdt))
    got = event_histogram(*(a.to(cuda_device) for a in args))
    assert torch.equal(got.cpu(), event_histogram_plain(*args))


@pytest.mark.parametrize("wire", ["d24v", "pack"])
def test_replay_on_the_card_matches_the_cpu(tmp_path, cuda_device, wire):
    rng = np.random.default_rng(3)
    n = 5 * 4096 + 99
    lines = np.where(rng.random(n) < 0.5, rng.integers(0, 1 << 8, n),
                     rng.integers(0, 1 << 13, n))
    lines = np.where((np.arange(n) // 700) % 3 == 2,
                     (1 << 30) + (np.arange(n) // 8) % 3000, lines)
    path = str(tmp_path / "t.bin")
    (lines.astype(np.uint64) << np.uint64(6)).astype("<u8").tofile(path)
    kw = dict(window=1024, batch_windows=4, wire=wire,
              initial_capacity=1 << 8)
    card = trace.replay_file(path, device=cuda_device, **kw)
    cpu = trace.replay_file(path, device="cpu", **kw)
    np.testing.assert_array_equal(card.hist, cpu.hist)
    assert (card.total_count, card.n_lines) == (cpu.total_count,
                                                cpu.n_lines)
