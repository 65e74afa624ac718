"""``replay_s``: seconds per prediction of the program's replay spans:
``trace.replay_file`` (a streamed replay, its feed included) and
``trace.replay_staged`` (a replay of the resident copy; a hit opens no
``trace.replay_file``)."""


def read(run):
    s = run.span_s("trace.replay_file", "trace.replay_staged")
    return None if s is None or not run.n_preds else s / run.n_preds
