"""``cri_s``: seconds of the program's ``cri.distribute`` span per
prediction: the CRI model on the host."""


def read(run):
    s = run.span_s("cri.distribute")
    return None if s is None or not run.n_preds else s / run.n_preds
