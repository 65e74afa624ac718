"""``plan_s``: seconds of the program's ``engine.plan`` spans in the window,
per prediction (the host plan; only where a prediction plans)."""


def read(run):
    s = run.span_s("engine.plan")
    return None if s is None or not run.n_preds else s / run.n_preds
