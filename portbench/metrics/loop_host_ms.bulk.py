"""The scheduler (``core/serving.py`` ``WaveScheduler``): host ms a wave
not spent waiting in a device-to-host read, the Python and the launches
of the wave loop: the window's wall time less the calls' summed
``ServeReport.sync_wait_ms``, over their ``ServeReport.waves`` (host
clock and program counters).  Nothing from a program without the
counter, nor from a run whose trace holds no device operation."""


def read(run):
    if run.loop != "closed" or run.trace is None or run.trace.busy_s <= 0:
        return None
    calls = run.window.calls
    if not all(hasattr(c.report, "sync_wait_ms") for c in calls):
        return None
    return ((1e3 * run.window.seconds
             - sum(c.report.sync_wait_ms for c in calls))
            / sum(c.report.waves for c in calls))
