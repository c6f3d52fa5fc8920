"""The scheduler (``core/serving.py`` ``WaveScheduler``): device-to-host
reads a wave, ``ServeReport.host_syncs`` over ``ServeReport.waves``
summed over the window's calls (program counters).  Each read waits for
the work queued on the device.  Nothing from a program without the
counter, nor from a run whose trace holds no device operation: a read
on the CPU waits for no device."""


def read(run):
    if run.loop != "closed" or run.trace is None or run.trace.busy_s <= 0:
        return None
    calls = run.window.calls
    if not all(hasattr(c.report, "host_syncs") for c in calls):
        return None
    return (sum(c.report.host_syncs for c in calls)
            / sum(c.report.waves for c in calls))
