"""``event_hist_roofline``: kernel 1's least time over its measured time,
in percent.  The least time is the bytes its inputs need
(``benchmark/kernels.py``: from the plan's window shapes and the spec's
access counts, each needed byte read once, the histogram written once)
over the card's HBM bandwidth; the measured time is the device time of the
``carried_event_hist*`` kernels over the traced predictions (a served
run: the traced requests, each under its tenant's plan)."""

from benchmark import kernels


def read(run):
    dev_s = run.device_s(lambda n: "carried_event_hist" in n)
    if not dev_s:
        return None
    nbytes = sum(kernels.event_hist_need_bytes(*w)
                 for plan, mix, doc, preds in run.planned()
                 for w in kernels.sort_windows(plan, mix, doc, preds))
    return 100.0 * nbytes / kernels.PEAK_HBM_BPS / dev_s if nbytes else None
