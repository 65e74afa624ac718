"""``masked_hist_roofline``: kernel 2's least time over its measured time,
in percent.  The least time is the bytes its inputs need
(``benchmark/kernels.py``: from the trace's ref count, each ref's reuse
and three masks read once, the histogram written once) over the card's
HBM bandwidth; the measured time is the device time of the
``masked_hist`` kernels over the traced predictions."""

from benchmark import kernels


def read(run):
    dev_s = run.device_s(lambda n: "masked_hist" in n)
    if not dev_s:
        return None
    nbytes = len(run.traced_preds) * kernels.masked_hist_replay_bytes(
        run.config["refs"])
    return 100.0 * nbytes / kernels.PEAK_HBM_BPS / dev_s
