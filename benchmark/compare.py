"""What decides ``correct``: the timed path's answers against the reference.

Three numbers, each over every checked prediction, each with its limit:

- ``counts_off``: the entries that differ between the program's and the
  reference's per-thread noshare histograms and share dicts, plus 1 when
  the access counts (``max_iteration_count``) differ; for a trace replay,
  the entries of the dense reuse histogram that differ, plus 1 when the
  ref counts differ and 1 when the program's line table holds fewer slots
  than there are distinct lines.  Slot 0, the cold refs, is the number of
  distinct lines, so it is the exact check of them; the program's
  ``n_lines`` is its compactor's id slots (the distinct lines plus each
  memory region's slack), which only a table too small can give away.
  Exact: limit 0.
- ``cri_gap``: the largest relative gap ``|program - reference| /
  |reference|`` over the keys of the CRI reuse histogram (a trace's reuse
  histogram itself: a replay has one clock, so no CRI); 1 when the key
  sets differ.
- ``mrc_gap``: the largest absolute gap between the two miss-ratio curves;
  1 when their lengths differ.  A served response carries its curve as
  ``[c, m]`` points (:func:`mrc_points_gap`): each point is held against
  the reference's curve at ``c``.

The limits of the last two were set from chip readings of the program
(the lower reading) and of the float32 control (the upper one); PERF.md
gives both.
"""

from __future__ import annotations

import numpy as np

LIMITS = {"counts_off": 0, "cri_gap": 1e-7, "mrc_gap": 1e-10}


def counts_off(noshare: list, share: list, accesses: int, ref) -> int:
    off = int(accesses != ref.accesses)
    if len(noshare) != len(ref.noshare) or len(share) != len(ref.share):
        return off + 1 + max(len(noshare), len(ref.noshare))
    for mine, theirs in list(zip(noshare, ref.noshare)) + \
            list(zip(share, ref.share)):
        for k in set(mine) | set(theirs):
            off += int(mine.get(k) != theirs.get(k))
    return off


def trace_counts_off(hist: np.ndarray, total_count: int, n_lines: int,
                     ref) -> int:
    off = int(total_count != ref.total_count) + int(n_lines < ref.n_lines)
    mine, theirs = np.asarray(hist), np.asarray(ref.hist)
    if mine.shape != theirs.shape:
        return off + 1 + max(mine.size, theirs.size)
    return off + int(np.count_nonzero(mine != theirs))


def cri_gap(rihist: dict, ref: dict) -> float:
    if set(rihist) != set(ref):
        return 1.0
    return max((abs(float(rihist[k]) - float(v)) / abs(float(v))
                for k, v in ref.items() if v), default=0.0)


def mrc_gap(curve: np.ndarray, ref: np.ndarray) -> float:
    if len(curve) != len(ref):
        return 1.0
    return float(np.max(np.abs(np.asarray(curve, np.float64)
                               - np.asarray(ref, np.float64))))


def mrc_points_gap(points: list, ref: np.ndarray) -> float:
    """``mrc_gap`` of a curve sent as ``[c, m]`` points: the largest
    ``|m - ref[c]|``; 1 when the points do not start at ``c = 0`` and end
    at the curve's last index, or a ``c`` lies outside it."""
    cs = [int(c) for c, _ in points]
    if not cs or cs[0] != 0 or cs[-1] != len(ref) - 1 or \
            min(cs) < 0 or max(cs) >= len(ref):
        return 1.0
    return max(abs(float(m) - float(ref[int(c)])) for c, m in points)


def judge(numbers: dict) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)
