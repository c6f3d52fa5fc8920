"""The fused scan-merge kernel (``kernels/ivf_scan_merge.py``,
``csrc/ivf_scan_merge.cu``): the least time for the scan bytes the
traced window's queries needed (``reference/counts.py``) over the
kernel's summed device time in the trace, in percent."""


def read(run):
    if run.loop != "closed" or run.trace is None:
        return None
    t = sum(s for n, s in run.trace.kernel_by_name.items()
            if "ivf_scan_merge" in n)
    if t <= 0:
        return None
    return 100.0 * run.bound_s["scan"] / t
