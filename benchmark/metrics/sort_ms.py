"""``sort_ms``: device time of the window sort per traced prediction, in
milliseconds: every kernel launched inside ``aten::sort`` or
``aten::gather`` (``ops/reuse.sort_columns``' sorts and the gathers that
apply their order; on the full and sampled paths the program calls
neither elsewhere), leaving out those inside ``torch.unique``
(``share_unique``'s sorts, another layer's)."""

SORT = {"aten::sort", "aten::gather"}
UNIQUE = {"aten::_unique2", "aten::_unique", "aten::unique_dim",
          "aten::unique_consecutive"}


def read(run):
    s = run.device_s_under(SORT, outside=UNIQUE)
    return None if s is None else s / len(run.traced_preds) * 1e3
