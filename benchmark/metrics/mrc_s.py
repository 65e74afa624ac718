"""``mrc_s``: seconds of the program's ``mrc.aet_mrc`` span per
prediction: the miss-ratio curve on the host."""


def read(run):
    s = run.span_s("mrc.aet_mrc")
    return None if s is None or not run.n_preds else s / run.n_preds
