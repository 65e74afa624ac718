"""``sort_window_ms``: device time of the sort windows per traced
prediction, in milliseconds: every device operation launched inside the
program's ``engine.sort_window`` range (the packing of the window, its
sort, the tails, kernel 1 and the carried events), whoever called the
window (the engine or the sampler)."""


def read(run):
    s = run.device_s_under({"engine.sort_window"})
    return None if s is None else s / len(run.traced_preds) * 1e3
