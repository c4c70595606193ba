"""Device kernels, copies and sets per epoch in the traced window: the
host's dispatch, as the device sees it."""


def read(run):
    if run.trace is None or not run.trace.device_ops or not run.trace.epochs:
        return None
    return len(run.trace.device_ops) / run.trace.epochs
