"""``dispatch_s``: seconds of the program's ``engine.dispatch`` spans per
prediction: the window loop, from the first window to the histogram's copy
to the host, so it covers the device's work."""


def read(run):
    s = run.span_s("engine.dispatch")
    return None if s is None or not run.n_preds else s / run.n_preds
