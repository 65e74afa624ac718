"""``template_window_s``: seconds of the program's
``engine.template_window`` spans per prediction: the host's time in the
template windows (head gather, local histogram, tail scatter), launches
included; the device's work runs on after the span ends."""


def read(run):
    s = run.span_s("engine.template_window")
    return None if s is None or not run.n_preds else s / run.n_preds
