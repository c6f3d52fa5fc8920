"""The scheduler (``core/serving.py`` ``WaveScheduler``): host ms a wave
spent in device-to-host reads, the wait for the device's queued work
included: ``ServeReport.sync_wait_ms`` over ``ServeReport.waves`` summed
over the window's calls (program counters).  Nothing from a program
without the counter, nor from a run whose trace holds no device
operation."""


def read(run):
    if run.loop != "closed" or run.trace is None or run.trace.busy_s <= 0:
        return None
    calls = run.window.calls
    if not all(hasattr(c.report, "sync_wait_ms") for c in calls):
        return None
    return (sum(c.report.sync_wait_ms for c in calls)
            / sum(c.report.waves for c in calls))
