"""The fused scan-merge kernel (``kernels/ivf_scan_merge.py``,
``csrc/ivf_scan_merge.cu``) at rows wider than a stage: the share of
the window's waves whose fused launch streamed its list rows through a
staged ring, in either of its modes, 100 times the calls' summed
``ServeReport.ring_launches`` (a program counter) over their summed
``waves``.  Nothing from a program without the counter, nor from a run
whose trace holds no device operation."""


def read(run):
    if run.loop != "closed" or run.trace is None or run.trace.busy_s <= 0:
        return None
    calls = run.window.calls
    if not all(hasattr(c.report, "ring_launches") for c in calls):
        return None
    waves = sum(c.report.waves for c in calls)
    if waves <= 0:
        return None
    return 100.0 * sum(c.report.ring_launches for c in calls) / waves
