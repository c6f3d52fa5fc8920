"""The scheduler: the share of the lane-probe slots the waves scanned
that a query needed, its probes C over ``ServeReport.lane_steps`` (a
program counter).  The rest is idle lanes and slots past an exit."""


def read(run):
    if run.loop != "closed":
        return None
    used = sum(sum(c.report.probes.values()) for c in run.window.calls)
    return 100.0 * used / sum(c.report.lane_steps for c in run.window.calls)
