"""``trace_batch_ms``: device time of the replay's batches per traced
prediction, in milliseconds: every device operation launched inside the
program's ``trace.batch`` ranges (a streamed replay's batches) or its
``trace.replay_staged`` range (a resident replay): the segmented
extraction (``ops/reuse.batch_events``) and kernel 2."""


def read(run):
    s = run.device_s_under({"trace.batch", "trace.replay_staged"})
    return None if s is None else s / len(run.traced_preds) * 1e3
