"""``sampler_s``: seconds of the benchmark's span around
``sampling.sampled_run`` per prediction (its counted and context walks)."""


def read(run):
    s = run.span_s("bench.sampler")
    return None if s is None or not run.n_preds else s / run.n_preds
