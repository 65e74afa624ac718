"""``window_sort_ms``: device time of the window sort per traced
prediction, in milliseconds: every device operation launched inside the
program's ``pluss::window_sort`` ranges (``ops/window_sort.py``: the pack
kernels, CUB's radix sort and the unpack kernel of each sort window,
tied to the range by the launcher's function-scope profiler range).  A
program without the range reads None."""


def read(run):
    s = run.device_s_under({"pluss::window_sort"})
    return None if s is None else s / len(run.traced_preds) * 1e3
