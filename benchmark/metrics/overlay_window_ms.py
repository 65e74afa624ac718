"""``overlay_window_ms``: device time of the interleave overlay windows
per traced prediction, in milliseconds: every device operation launched
inside the program's ``engine.overlay_window`` ranges
(``overlay.device_window``)."""


def read(run):
    s = run.device_s_under({"engine.overlay_window"})
    return None if s is None else s / len(run.traced_preds) * 1e3
