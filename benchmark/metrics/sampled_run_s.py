"""``sampled_run_s``: seconds of the program's ``sampling.run`` span per
prediction: the subset sampler from the inside (its plan lookup, counted
and context walks, and the share merge)."""


def read(run):
    s = run.span_s("sampling.run")
    return None if s is None or not run.n_preds else s / run.n_preds
