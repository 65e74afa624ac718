"""``d24v_decode_ms``: device time of kernel 3 per traced prediction, in
milliseconds: the ``d24v_decode`` kernels and the memsets of their
scratch.  The decode's wrapper launches both itself, outside any
operator: the memsets counted are those launched inside the program's
``trace.replay_file`` range, outside its ``trace.batch`` ranges and
outside every ``aten::`` operator.  A time, not a roofline: the wire's
size depends on the data."""


def _own_memset(name: str, host) -> bool:
    return "Memset" in name and "trace.replay_file" in host \
        and "trace.batch" not in host \
        and not any(h.startswith("aten::") for h in host)


def read(run):
    k = run.device_s(lambda n: "d24v_decode" in n)
    if k is None:
        return None
    mem = sum(s for n, s, host in run.launched if _own_memset(n, host))
    return (k + mem) / len(run.traced_preds) * 1e3
