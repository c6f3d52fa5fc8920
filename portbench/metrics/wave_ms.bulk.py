"""The scheduler (``core/serving.py`` ``WaveScheduler``): the window's
wall time over the waves all its calls ran (host clock over the
program's ``ServeReport.waves``)."""


def read(run):
    if run.loop != "closed":
        return None
    waves = sum(c.report.waves for c in run.window.calls)
    return 1e3 * run.window.seconds / waves
