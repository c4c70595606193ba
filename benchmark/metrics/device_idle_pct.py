"""The share of the traced window in which no device operation runs (from
the union of their intervals, not their sum)."""


def read(run):
    if run.trace is None or not run.trace.device_ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
