"""``plan_template_s``: seconds of the program's ``engine.plan.template``
spans in the window, per prediction: the part of the host plan that finds
the clean windows, splits the references and builds (or reads from the
disk cache) the static window template."""


def read(run):
    s = run.span_s("engine.plan.template")
    return None if s is None or not run.n_preds else s / run.n_preds
