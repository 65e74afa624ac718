"""``share_unique_s``: seconds of the program's ``engine.share_unique``
spans per prediction: the per-window share extraction (``share_keys``,
the ``torch.unique`` of each window and the fold), which waits for the
device because ``torch.unique`` sizes its output from the data."""


def read(run):
    s = run.span_s("engine.share_unique")
    return None if s is None or not run.n_preds else s / run.n_preds
