"""A serving wave of the live cell (the scheduler's loop through the
delta overlay and the tombstone scrub, ``core/serving.py``): the
window's wall ms less the calls' summed ``ServeReport.hook_ms`` (a
program counter), over their ``ServeReport.waves``.  Nothing from a
program without the counter, a window without the stream's records, nor
a run whose trace holds no device operation."""


def read(run):
    if run.loop != "closed" or run.trace is None or run.trace.busy_s <= 0:
        return None
    calls = run.window.calls
    if any(c.mutations is None or not hasattr(c.report, "hook_ms")
           for c in calls):
        return None
    return ((1e3 * run.window.seconds - sum(c.report.hook_ms for c in calls))
            / sum(c.report.waves for c in calls))
