"""The traced window: ``torch.profiler`` over the device and the host,
reduced to what the per-layer metrics and the ``breakdown`` read.

- ``busy_s``: the union of the intervals in which a device operation
  (a kernel, a copy or a set) ran; ``window_s`` the traced window.
- ``kernel_s``: summed kernel time (copies and sets left out), in all
  and by kernel name.
- ``device_ops``: device time by operation name.
- ``idle_gaps``: the device's idle time by what the host was doing
  meanwhile: the innermost host event at the middle of each gap.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import numpy as np

WINDOW_SPAN = "portbench.traced_window"
# host events scanned back from a gap's middle for the innermost one
# that covers it
LOOKBACK = 256
NO_HOST_EVENT = "(no host event: Python between calls)"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: float
    kernel_by_name: Dict[str, float]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    reduce_s: float = 0.0         # host seconds spent reducing the trace


def _events(prof):
    """(name, on_device, start_ns, end_ns) of every profiled event but
    the device's mirrors of ``record_function`` spans."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        on_dev = e.device_type() != DeviceType.CPU
        if on_dev and (e.is_user_annotation() or e.name() == WINDOW_SPAN):
            continue
        start = e.start_ns()
        out.append((e.name(), on_dev, start, start + e.duration_ns()))
    return out


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged, sorted intervals of an (n, 2) array."""
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out, dtype=np.int64)


def reduce(events, top: int = 10) -> Trace:
    win = [(s, e) for n, dev, s, e in events if n == WINDOW_SPAN and not dev]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    w0, w1 = win[0]
    dev = [(n, s, e) for n, on_dev, s, e in events if on_dev and e > s]
    by_name: Dict[str, float] = defaultdict(float)
    kernel_by_name: Dict[str, float] = defaultdict(float)
    for n, s, e in dev:
        by_name[n] += (e - s) / 1e9
        if not _is_copy(n):
            kernel_by_name[n] += (e - s) / 1e9
    busy = _union(np.array([(max(s, w0), min(e, w1)) for _, s, e in dev
                            if e > w0 and s < w1], dtype=np.int64)
                  .reshape(-1, 2))
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) / 1e9 if len(busy) \
        else 0.0
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]) if len(busy) \
        else np.array([w0, w1])
    gaps = edges.reshape(-1, 2)
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    host = sorted((s, e, n) for n, on_dev, s, e in events
                  if not on_dev and n != WINDOW_SPAN)
    h_start = np.array([s for s, _, _ in host], dtype=np.int64)
    idle: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        label = NO_HOST_EVENT
        i = int(np.searchsorted(h_start, mid, side="right")) - 1
        for j in range(i, max(i - LOOKBACK, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        idle[label] += (g1 - g0) / 1e9
    return Trace(
        window_s=(w1 - w0) / 1e9, busy_s=busy_s,
        kernel_s=sum(kernel_by_name.values()),
        kernel_by_name=dict(kernel_by_name),
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        idle_gaps=sorted(idle.items(), key=lambda kv: -kv[1])[:top])


def traced(fn: Callable[[], object], sync: Callable[[], None]
           ) -> Tuple[object, Trace]:
    """Run ``fn`` under the profiler; its result and the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        sync()
        with record_function(WINDOW_SPAN):
            out = fn()
            sync()
    t = time.perf_counter()
    tr = reduce(_events(prof))
    tr.reduce_s = time.perf_counter() - t
    return out, tr
