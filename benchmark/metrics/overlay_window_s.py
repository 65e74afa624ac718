"""``overlay_window_s``: seconds of the program's ``engine.overlay_window``
spans per prediction: the host's time in the interleave overlay windows
(``overlay.device_window``: the arrival lattice, the collision-row gathers
and scatters, the binned histograms), launches included; the device's
work runs on after the span ends."""


def read(run):
    s = run.span_s("engine.overlay_window")
    return None if s is None or not run.n_preds else s / run.n_preds
