"""Run one benchmark cell of the port and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout that holds ``pluss_torch``; the cells are
those of ``BENCHMARK.json``.  Needs the CUDA card(s) the cell asks for, and
exits non-zero with no result line without them.  The last line on
standard output is the result (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``); the last
lines on standard error are the numbers ``correct`` was decided by, each
beside its limit.

Every run takes the same host allocator settings (:data:`ALLOCATOR`): the
script starts itself again under them when the environment lacks them.
glibc's malloc otherwise moves its mmap and trim thresholds with what the
process freed before, so a run whose set-up planned cold and one that
loaded the plan from the disk cache would time the same window apart.
"""

import time

T_START = time.monotonic()

import os  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402

#: glibc malloc's thresholds, fixed (a fixed value also turns off their
#: moving with the process's history)
ALLOCATOR = {"MALLOC_MMAP_THRESHOLD_": str(1 << 30),
             "MALLOC_TRIM_THRESHOLD_": str(4 << 30),
             "MALLOC_TOP_PAD_": str(256 << 20)}

if __name__ == "__main__" and any(os.environ.get(k) != v
                                  for k, v in ALLOCATOR.items()):
    os.environ.update(ALLOCATOR, BENCHMARK_T_START=repr(T_START))
    os.execv(sys.executable, [sys.executable] + sys.argv)

# the clock is the system's monotonic one, so it runs on across the exec
T_START = float(os.environ.pop("BENCHMARK_T_START", T_START))

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    # a run ended from outside still leaves through its clean-up (the
    # trace file a trace cell writes)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    sys.exit(harness.main(t_start=T_START))
