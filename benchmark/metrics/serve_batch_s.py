"""``serve_batch_s``: seconds of the program's ``serve.batch`` spans per
answered request: the daemon's device loop, one span a dispatched batch
(the resilience ladder, the engine, the demux and the replies)."""


def read(run):
    s = run.span_s("serve.batch")
    return None if s is None or not run.n_preds else s / run.n_preds
