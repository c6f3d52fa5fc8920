"""The live index's write path outside merges (``LiveIndex.add``,
``delete``, ``IndexRegistry.publish``, run by the scheduler's
``on_wave`` hook): the calls' summed ``ServeReport.hook_ms`` (a program
counter) less the stream's summed ``merge_ms``, over their
``ServeReport.waves``.  Nothing from a program without the counter, a
window without the stream's records, nor a run whose trace holds no
device operation."""


def read(run):
    if run.loop != "closed" or run.trace is None or run.trace.busy_s <= 0:
        return None
    calls = run.window.calls
    if any(c.mutations is None or not hasattr(c.report, "hook_ms")
           for c in calls):
        return None
    return ((sum(c.report.hook_ms for c in calls)
             - sum(c.mutations["merge_ms"] for c in calls))
            / sum(c.report.waves for c in calls))
