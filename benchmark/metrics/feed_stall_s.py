"""``feed_stall_s``: seconds per prediction that the replay's main thread
waited on the trace feed for its next batch: the increase of the
program's ``trace.prefetch_stall_s`` counter over the window."""


def read(run):
    s = run.counter("trace.prefetch_stall_s")
    return None if s is None or not run.n_preds else s / run.n_preds
