"""The exit policy (patience, ``core/ivf.py``, ``core/policies.py``):
mean probes C a served query took, from ``ServeReport.probes`` (a
program counter)."""


def read(run):
    if run.loop != "closed":
        return None
    n = sum(len(c.report.probes) for c in run.window.calls)
    return sum(sum(c.report.probes.values()) for c in run.window.calls) / n
