"""``demux_s``: seconds per answered request of the program's
``serve.demux`` spans less the ``cri.distribute`` and ``mrc.aet_mrc``
spans inside them (which ``cri_s`` and ``mrc_s`` read): each member's
result view (``tenant_view``) and the shaping of its payload."""


def read(run):
    s = run.span_s("serve.demux")
    if s is None or not run.n_preds:
        return None
    inner = run.span_s("cri.distribute", "mrc.aet_mrc") or 0.0
    return (s - inner) / run.n_preds
