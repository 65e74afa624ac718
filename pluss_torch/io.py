"""Output formatting with reference parity (the port's copy of ``pluss/io.py``).

- ``_pluss_histogram_print`` (``pluss_utils.h:690-702``): title line, then one
  ``key,count,count/sum`` line per key in ascending key order.
- Doubles print like ``std::cout`` defaults (6 significant digits) — Python's
  ``%g`` is the same algorithm.
- Timing banner ``<NAME>: <seconds>`` with ``%0.6f`` seconds.
- The `acc` block tail ``max iteration traversed\\n<count>\\n\\n``.
"""

from __future__ import annotations

from typing import IO, Iterable

from pluss_torch.cri import Histogram, merge

NOSHARE_TITLE = "Start to dump noshare private reuse time"
SHARE_TITLE = "Start to dump share private reuse time"
RI_TITLE = "Start to dump reuse time"


def fmt_double(v: float) -> str:
    """``std::cout << double`` default formatting (6 significant digits)."""
    return f"{v:g}"


def histogram_lines(title: str, hist: Histogram) -> Iterable[str]:
    total = sum(hist.values())
    yield title
    for k in sorted(hist):
        v = hist[k]
        yield f"{k},{fmt_double(v)},{fmt_double(v / total if total else 0.0)}"


def print_histogram(title: str, hist: Histogram, out: IO[str]) -> None:
    for line in histogram_lines(title, hist):
        out.write(line + "\n")


def merge_share(share: list[Histogram]) -> Histogram:
    """Per-thread share merge for printing: raw (unbinned) reuse keys,
    summed across the share-ratio groups (pluss_utils.h:949-960)."""
    out: Histogram = {}
    for per_thread in share:
        for group in per_thread.values():
            for k, v in group.items():
                out[k] = out.get(k, 0.0) + v
    return out


def acc_block(banner: str, seconds: float, noshare: list[Histogram],
              share: list[Histogram], rihist: Histogram,
              max_iteration_count: int, out: IO[str]) -> None:
    """One full `acc` output block in the C++ main's order (…omp.cpp:337-348).
    No-share keys are already log2-binned, so their merge does not re-bin."""
    out.write(f"{banner}: {seconds:0.6f}\n")
    print_histogram(NOSHARE_TITLE, merge(noshare), out)
    print_histogram(SHARE_TITLE, merge_share(share), out)
    print_histogram(RI_TITLE, rihist, out)
    out.write("max iteration traversed\n")
    out.write(f"{max_iteration_count}\n")
    out.write("\n")


def speed_block(banner: str, seconds_per_rep: list[float], out: IO[str]) -> None:
    """One `speed` output block: a banner+time line per rep."""
    for s in seconds_per_rep:
        out.write(f"{banner}: {s:0.6f}\n")
    out.write("\n")
