"""``sampler_context_ms``: device time of the sampler's uncounted context
walks per traced prediction, in milliseconds: every device operation
launched inside the program's ``sampling.context`` range."""


def read(run):
    s = run.device_s_under({"sampling.context"})
    return None if s is None else s / len(run.traced_preds) * 1e3
