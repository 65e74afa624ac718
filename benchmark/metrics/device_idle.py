"""``device_idle``: the share of the traced window in which no device
operation ran: ``1 - busy / traced window`` in percent, busy the sum of
the device operations' times (``benchmark/devtrace.py``)."""


def read(run):
    if not run.busy_s or not run.traced_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.traced_s)
