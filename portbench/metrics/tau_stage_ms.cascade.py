"""The cascade stage (``core/serving.py``'s ``serve.tau``: the history
recorded from the chunk's snapshots, the Table-1 matrix and the tree
walk): host ms a wave, the calls' summed ``ServeReport.tau_ms`` over
their ``ServeReport.waves`` (program counters).  Nothing from a program
without the counter, nor from a run whose trace holds no device
operation."""


def read(run):
    if run.loop != "closed" or run.trace is None or run.trace.busy_s <= 0:
        return None
    calls = run.window.calls
    if not all(hasattr(c.report, "tau_ms") for c in calls):
        return None
    return (sum(c.report.tau_ms for c in calls)
            / sum(c.report.waves for c in calls))
