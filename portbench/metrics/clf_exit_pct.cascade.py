"""The cascade stage (``core/serving.py``'s stage at probe tau, over
``core/features.py`` and ``trees/torch_infer.py``): the share of the
window's served queries that the classifier exited at tau, 100 times
the calls' summed ``ServeReport.clf_exits`` (a program counter) over the
queries served.  Nothing from a program without the counter, nor from a
run whose trace holds no device operation."""


def read(run):
    if run.loop != "closed" or run.trace is None or run.trace.busy_s <= 0:
        return None
    calls = run.window.calls
    if not all(hasattr(c.report, "clf_exits") for c in calls):
        return None
    return (100.0 * sum(c.report.clf_exits for c in calls)
            / sum(len(c.report.probes) for c in calls))
