"""device_idle: the share of the traced window in which no kernel ran on
the device (the trace's union of kernel intervals against the window's
span), in %."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
