"""The reuse histogram of a raw address trace, in plain torch.

The benchmark's own reading of what a trace replay counts, from the
semantics alone; it imports nothing of the program and reads only the
trace file.

- A ref touches cache line ``addr >> log2(cls)``.  The trace has one clock:
  a ref's position in the file.
- A ref whose line was touched before has a reuse: its position minus the
  position of the line's previous ref.  A ref with none is cold.
- The histogram has 49 slots: slot 0 the cold refs, slot ``1 + e`` the
  reuses in ``[2**e, 2**(e+1))``.  ``n_lines`` is the number of distinct
  lines, ``total_count`` the number of refs.

One stable sort of the whole trace's lines puts every ref beside its line's
previous ref; the reuses are the differences of their positions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: histogram slots: slot 0 the cold count, slot 1+e the bin 2**e
NBINS = 49


@dataclasses.dataclass
class Counts:
    hist: np.ndarray      # [NBINS] int64
    total_count: int
    n_lines: int


def bit_length(r: torch.Tensor) -> torch.Tensor:
    """``floor(log2(r))`` of positive int64 ``r``, exact: a float estimate
    corrected by integer comparisons."""
    e = torch.floor(torch.log2(r.to(torch.float64))).to(torch.int64)
    one = torch.ones_like(e)
    e += (torch.bitwise_left_shift(one, e + 1) <= r).to(torch.int64)
    e -= (torch.bitwise_left_shift(one, e) > r).to(torch.int64)
    return e


def replay(path: str, cls: int, device) -> Counts:
    """The reuse histogram of the trace at ``path`` with ``cls``-byte
    lines, computed on ``device``."""
    if cls < 1 or cls & (cls - 1):
        raise ValueError(f"cache line size {cls} is not a power of two")
    addrs = np.fromfile(path, dtype="<u8")   # packed little-endian u64
    n = len(addrs)
    if n == 0:
        return Counts(np.zeros(NBINS, np.int64), 0, 0)
    if int(addrs.max()) >= 1 << 63:
        raise ValueError("an address does not fit int64")
    lines = torch.from_numpy(addrs.view(np.int64)).to(device)
    del addrs
    lines >>= cls.bit_length() - 1
    lines, pos = torch.sort(lines, stable=True)
    same = lines[1:] == lines[:-1]
    del lines
    reuse = (pos[1:] - pos[:-1])[same]
    del pos, same
    n_lines = n - int(reuse.numel())
    hist = torch.bincount(1 + bit_length(reuse), minlength=NBINS)
    if hist.numel() > NBINS:
        raise ValueError("a reuse does not fit the histogram")
    hist = hist.cpu().numpy().astype(np.int64)
    hist[0] = n_lines
    return Counts(hist, n, n_lines)


def histogram(c: Counts, dtype=np.float64) -> dict:
    """The reuse histogram keyed as the MRC reads it: the cold count under
    key -1, each nonzero bin ``1 + e`` under ``2**e``, in ``dtype``."""
    out = {-1: dtype(c.hist[0])}
    for e in range(NBINS - 1):
        if c.hist[1 + e]:
            out[1 << e] = dtype(c.hist[1 + e])
    return out
