"""Synthetic raw-address traces (packed little-endian u64 byte addresses).

    python -m pluss_torch.tracegen OUT --refs 1000000000   # hot/warm mix
    python -m pluss_torch.tracegen OUT --smoke             # chip_smoke's

- :func:`hot_warm`: the port's copy of ``bench.synth_trace`` — a two-tier
  working set (hot 2^16 lines, warm 2^22 lines, shuffled per 2^24-ref
  batch), a two-knee MRC and a realistic reuse mix.
- :func:`sweeps`: sequential sweeps at 8-byte stride over one array; their
  reuse histogram is known by hand (:func:`sweep_histogram`).
- :func:`smoke_trace`: 2^27 hot/warm refs, then 8 sweeps of 2^24 refs over
  a 2^21-line (128 MiB) array far above them, so the replay's compactor
  must discover a second memory region.

Everything is made from a seed in 2^24-ref batches, so memory stays
bounded at any length.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from pluss_torch.config import NBINS

#: refs per generated batch (the replay's default batch, too)
BATCH = 1 << 24

#: first line of :func:`smoke_trace`'s sweep array: byte address 2^40,
#: far past the hot/warm lines
SWEEP_BASE_LINE = 1 << 34


def _write_lines(f, lines: np.ndarray, cls: int = 64) -> None:
    (lines.astype(np.uint64) << np.uint64(cls.bit_length() - 1)) \
        .astype("<u8").tofile(f)


def hot_warm(f, n_refs: int, rng: np.random.Generator) -> None:
    """Append ``n_refs`` refs of the hot/warm mix to the open file ``f``
    (``bench.synth_trace``'s generator)."""
    written = 0
    while written < n_refs:
        m = min(BATCH, n_refs - written)
        hot = rng.integers(0, 1 << 16, m // 2, dtype=np.int64)
        warm = rng.integers(0, 1 << 22, m - m // 2, dtype=np.int64)
        lines = np.concatenate([hot, warm])
        rng.shuffle(lines)
        _write_lines(f, lines)
        written += m


def sweeps(f, n_sweeps: int, n_lines: int, base_line: int) -> None:
    """Append ``n_sweeps`` sequential sweeps over ``n_lines`` 64-byte lines
    from ``base_line`` on, at an 8-byte stride (8 refs per line)."""
    one = (np.uint64(base_line * 64)
           + np.arange(n_lines * 8, dtype=np.uint64) * np.uint64(8))
    for _ in range(n_sweeps):
        one.astype("<u8").tofile(f)


def sweep_histogram(n_sweeps: int, n_lines: int) -> np.ndarray:
    """``[NBINS]`` reuse histogram of :func:`sweeps` alone: each line is
    cold once; within a sweep its 7 later refs reuse at 1; each later
    sweep's first ref reuses at ``8 * n_lines - 7``."""
    hist = np.zeros(NBINS, np.int64)
    hist[0] = n_lines
    hist[1] = 7 * n_lines * n_sweeps
    far = 8 * n_lines - 7
    hist[far.bit_length()] += (n_sweeps - 1) * n_lines
    return hist


def smoke_trace(path: str, seed: int = 0) -> dict:
    """Write chip_smoke's 2^28-ref trace to ``path``: part A (2^27 hot/warm
    refs) then part B (8 sweeps of 2^24 refs over 2^21 lines).  Returns
    the layout, with part B's hand-worked histogram."""
    part_a, n_sweeps, n_lines = 1 << 27, 8, 1 << 21
    rng = np.random.default_rng(seed)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        hot_warm(f, part_a, rng)
        sweeps(f, n_sweeps, n_lines, SWEEP_BASE_LINE)
    os.replace(tmp, path)
    return {"refs": part_a + n_sweeps * n_lines * 8, "part_a_refs": part_a,
            "part_b_hist": sweep_histogram(n_sweeps, n_lines)}


def synth_trace(path: str, n_refs: int, seed: int = 0) -> None:
    """Write ``n_refs`` refs of the hot/warm mix to ``path``."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        hot_warm(f, n_refs, np.random.default_rng(seed))
    os.replace(tmp, path)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="pluss_torch.tracegen",
                                description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("out", help="trace file to write")
    p.add_argument("--refs", type=int, help="hot/warm refs to write")
    p.add_argument("--smoke", action="store_true",
                   help="write chip_smoke's 2^28-ref two-part trace")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.smoke == (args.refs is not None):
        p.error("give exactly one of --refs and --smoke")
    if args.smoke:
        smoke_trace(args.out, args.seed)
    else:
        synth_trace(args.out, args.refs, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
