"""``post_s``: seconds per prediction of the program's ``engine.finalize``
span (where the run has one) and the benchmark's spans around
``cri.distribute`` and ``mrc.aet_mrc``."""


def read(run):
    s = run.span_s("engine.finalize", "bench.cri", "bench.mrc")
    return None if s is None or not run.n_preds else s / run.n_preds
