"""Trace-replay measurements on the CUDA card, one JSON line per run.

    python -m pluss_torch.tracebench resident FILE [--reps 3]
    python -m pluss_torch.tracebench grid FILE [--reps 2]
    python -m pluss_torch.tracebench trees FILE --trees A B B A
    python -m pluss_torch.tracebench compact FILE

- ``resident``: ``pack_cached`` on the d24v wire (the pack is written
  next to FILE, or reused when its sidecar matches), then ``--reps``
  calls of ``replay_resident``, each staging the pack and replaying it
  from device memory: pack s, upload s and bytes, resident GiB, replay s
  and refs/s per call.
- ``grid``: the streamed ``replay_file`` on both wires at ``stage_depth``
  and ``queue_depth`` 1, 2 and 3, ``--reps`` times, in turns (each round
  walks the grid, every other round backwards), after one untimed replay
  of the first batch that builds the kernels and the mapper: wall s, the
  feed's stage seconds and the main thread's split.
- ``trees``: one streamed ``replay_file`` (the defaults) per named source
  tree, in the order given, each in a fresh interpreter that imports
  ``pluss_torch`` from that tree and first replays one untimed batch
  (``git archive`` a parent commit into a directory to compare it with
  this one on the same card).
- ``compact``: the feed's compact stage alone, batch by batch in one
  thread: the native mapper (``_Compactor.map_raw``) and the numpy path
  (``map`` of the shifted lines, the parent's only path) on the same
  compactor state, their ids held equal; seconds of each per batch and
  the table's cluster count.

Every run's histogram must equal the first run's; the card's name and
power limit lead the output.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

#: one streamed replay with the defaults, run in the tree under test
_TREE_RUN = """
import json, sys, time
from pluss_torch import trace
trace.replay_file(sys.argv[1], limit_refs=1 << 24)   # builds, untimed
t0 = time.perf_counter()
r = trace.replay_file(sys.argv[1])
wall = time.perf_counter() - t0
print(json.dumps({"total_s": wall, "refs": r.total_count,
                  "n_lines": r.n_lines, "hist": r.hist.tolist(),
                  "wire": r.wire, "feed_workers": r.feed_workers,
                  **r.timing}))
"""


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


class _Same:
    """Holds every run's histogram to the first one's."""

    def __init__(self):
        self.first = None

    def __call__(self, hist, n_lines) -> None:
        key = (list(map(int, hist)), int(n_lines))
        if self.first is None:
            self.first = key
        elif key != self.first:
            raise RuntimeError("a run's histogram differs from the first")


def resident(args) -> None:
    import torch

    from pluss_torch import trace

    t0 = time.perf_counter()
    meta, cached, packed = trace.pack_cached(args.file, wire="d24v")
    _emit({"run": "pack", "pack_s": time.perf_counter() - t0,
           "cached": cached, "refs": meta["n"], "n_lines": meta["n_lines"],
           "pack_bytes": os.path.getsize(packed)})
    same = _Same()
    for i in range(args.reps):
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        t0 = time.perf_counter()
        rep = trace.replay_resident(packed, meta, stats=stats)
        wall = time.perf_counter() - t0
        same(rep.hist, rep.n_lines)
        batch = trace.WINDOWS_PER_BATCH * trace.TRACE_WINDOW
        _emit({"run": "replay_resident", "rep": i, "total_s": wall,
               **stats, "refs_per_s": stats["refs"] / stats["replay_s"],
               "resident_gib": -(-meta["n"] // batch) * batch * 3 / 2**30,
               "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
               "n_lines": rep.n_lines})


def grid(args) -> None:
    from pluss_torch import trace

    points = [(w, d) for w in ("pack", "d24v") for d in (1, 2, 3)]
    same = _Same()
    trace.replay_file(args.file, limit_refs=1 << 24)   # builds, untimed
    for r in range(args.reps):
        for wire, depth in points if r % 2 == 0 else points[::-1]:
            t0 = time.perf_counter()
            rep = trace.replay_file(args.file, wire=wire, stage_depth=depth,
                                    queue_depth=depth)
            wall = time.perf_counter() - t0
            same(rep.hist, rep.n_lines)
            _emit({"run": "stream", "rep": r, "wire": wire, "depth": depth,
                   "total_s": wall, "refs_per_s": rep.total_count / wall,
                   **rep.timing})


def trees(args) -> None:
    same = _Same()
    for tree in args.trees:
        root = os.path.abspath(tree)
        out = subprocess.run(
            [sys.executable, "-c", _TREE_RUN, os.path.abspath(args.file)],
            cwd=root, env={**os.environ, "PYTHONPATH": root},
            capture_output=True, text=True, check=True)
        res = json.loads(out.stdout.strip().splitlines()[-1])
        same(res.pop("hist"), res["n_lines"])
        _emit({"run": "tree", "tree": tree, **res})


def compact(args) -> None:
    import numpy as np

    from pluss_torch import native, trace

    native.line_mapper()   # the build, untimed
    n = os.path.getsize(args.file) // 8
    batch = trace.WINDOWS_PER_BATCH * trace.TRACE_WINDOW
    read = trace._extent_reader(args.file, batch, n)
    comp = trace._Compactor()
    for b in range(-(-n // batch)):
        raw = read(b)
        numpy_comp = trace._Compactor.restore(comp.snapshot())
        clusters = len(comp.starts)
        t0 = time.perf_counter()
        ids = comp.map_raw(raw, 6)
        t1 = time.perf_counter()
        want = numpy_comp.map(raw.astype(np.int64) >> 6)
        t2 = time.perf_counter()
        if ids is not None and not np.array_equal(ids, want):
            raise RuntimeError(f"batch {b}: map_raw != map")
        comp = numpy_comp   # the state after this batch, grown or not
        _emit({"run": "compact", "batch": b, "clusters": clusters,
               "mapper": ids is not None, "map_raw_s": t1 - t0,
               "map_s": t2 - t1})


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="pluss_torch.tracebench",
                                description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("mode", choices=("resident", "grid", "trees", "compact"))
    p.add_argument("file", help="a raw u64 trace")
    p.add_argument("--reps", type=int, default=None)
    p.add_argument("--trees", nargs="+", default=["."],
                   help="trees mode: source trees, in run order")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("tracebench: no CUDA device is available", file=sys.stderr)
        return 1
    print(_card(), flush=True)
    if args.mode == "resident":
        args.reps = args.reps or 3
        resident(args)
    elif args.mode == "grid":
        args.reps = args.reps or 2
        grid(args)
    elif args.mode == "trees":
        trees(args)
    else:
        compact(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
