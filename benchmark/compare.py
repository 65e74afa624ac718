"""What decides ``correct``: the timed path's answers against the reference.

Three numbers, each over every checked prediction, each with its limit:

- ``counts_off``: the entries that differ between the program's and the
  reference's per-thread noshare histograms and share dicts, plus 1 when
  the access counts (``max_iteration_count``) differ.  Exact: limit 0.
- ``cri_gap``: the largest relative gap ``|program - reference| /
  |reference|`` over the keys of the CRI reuse histogram; 1 when the key
  sets differ.
- ``mrc_gap``: the largest absolute gap between the two miss-ratio curves;
  1 when their lengths differ.

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


def judge(numbers: dict) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)
