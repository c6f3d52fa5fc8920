"""The admission's centroid sims ranked per row (``kernels/delta_scan.py``,
``csrc/delta_scan.cu``, which a learned policy's admission runs over
every centroid): the least time for the traced window's ranking
operations, 2 d L a query (``reference/counts.py``), over the summed
device time of the kernels named ``delta_scan`` in the trace, in
percent.  Nothing where the trace holds no such kernel."""


def read(run):
    if run.loop != "closed" or run.trace is None:
        return None
    t = sum(s for n, s in run.trace.kernel_by_name.items()
            if "delta_scan" in n)
    if t <= 0:
        return None
    return 100.0 * run.bound_s["rank"] / t
