"""All kernels of the serving path (the fused scan-merge, the
admission's centroid product and ranking, the lane updates): the least
time for the traced window's needed work (scan bytes, ranking
operations, the centroid table once; ``reference/counts.py``) over all
kernels' summed device time in the trace, in percent."""


def read(run):
    if run.loop != "closed" or run.trace is None or run.trace.kernel_s <= 0:
        return None
    return 100.0 * sum(run.bound_s.values()) / run.trace.kernel_s
