"""device_idle_pct.prefill: the share of the full traced steps' wall in
which no operation ran on the device.  Device trace."""


def read(run):
    if not run.on_card or run.trace is None or not run.trace.full:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
