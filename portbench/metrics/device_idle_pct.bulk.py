"""The device: the share of the traced window in which no device
operation ran (profiler timeline), closed loop.  Nothing without a
device operation in the trace: a CPU run has no device."""


def read(run):
    if run.loop != "closed" or run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
