"""The program's spans in one traced window, by name, and what the
window's idle gaps are put down to.

    python3 portbench/spans.py --workload star-bulk --seed 7 --seconds 20

Run from the root of a checkout on a machine with a card.  It sets the
cell up as ``run.py`` does, serves an untraced window of ``--seconds``,
then traces one window as a ``--trace 1`` run does
(``harness.TRACE_SECONDS``) and prints one JSON line:

- ``spans``: for each span name its ``count``, ``host_s`` (summed
  duration), ``self_s`` (less the part its child spans cover) and
  ``device_s`` (the device time of the operations whose launching
  runtime call starts inside it, counted for the innermost such span
  only; a device operation and its launch share a correlation id);
- ``serve_cover``: the share of the window the ``serve`` spans cover;
- ``waves``, ``host_syncs``: the traced calls' summed ``ServeReport``
  counters (the latter absent from a program without it);
- ``window_s``, ``busy_s``, ``idle_gaps`` as ``trace.reduce`` gives
  them, and ``no_host_event_idle_share``: the idle time it can put
  down to no host event, over all idle time;
- ``idle_by_span``: the idle time by the innermost span at each gap's
  middle (``trace.reduce`` scans back a bounded number of host events
  for the one that holds it, and so misses a span that opened earlier);
- ``joined``: the share of device operations joined to a launch.
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SPAN, LAUNCH, OTHER = "span", "launch", "other"
# host CUDA API calls (cudaLaunchKernel, cudaMemcpyAsync,
# cuLaunchKernel, ...): a device operation shares its launch's
# correlation id
LAUNCH_PREFIX = "cu"
NO_SPAN = "(no span)"


class Event(NamedTuple):
    name: str
    on_dev: bool
    start: int                    # ns
    end: int                      # ns
    kind: str                     # SPAN, LAUNCH or OTHER (host events)
    corr: int                     # correlation id


@dataclasses.dataclass
class Span:
    count: int = 0
    host_s: float = 0.0
    self_s: float = 0.0
    device_s: float = 0.0


def events(prof) -> List[Event]:
    """Every profiled event but the device's mirrors of spans, as
    ``trace._events`` keeps them, with its kind and correlation id."""
    from torch.autograd import DeviceType

    from portbench.trace import WINDOW_SPAN
    out = []
    for e in prof.profiler.kineto_results.events():
        on_dev = e.device_type() != DeviceType.CPU
        if on_dev and (e.is_user_annotation() or e.name() == WINDOW_SPAN):
            continue
        kind = OTHER
        if not on_dev and e.is_user_annotation():
            kind = SPAN
        elif not on_dev and e.name().startswith(LAUNCH_PREFIX):
            kind = LAUNCH
        start = e.start_ns()
        out.append(Event(e.name(), on_dev, start, start + e.duration_ns(),
                         kind, e.correlation_id()))
    return out


class Nest:
    """The host spans (but the traced window's own), which nest on the
    serving thread: a span's parent is the innermost one holding its
    start."""

    def __init__(self, evs: List[Event]):
        from portbench.trace import WINDOW_SPAN
        self.spans = sorted((e.start, e.end, e.name) for e in evs
                            if e.kind == SPAN and e.name != WINDOW_SPAN)
        self.starts = [s for s, _, _ in self.spans]
        self.parent: List[int] = []
        stack: List[int] = []
        for i, (s, _, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] <= s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def innermost(self, t: int) -> int:
        """The index of the innermost span holding ``t``, or -1: the
        last span to start at or before ``t``, or one of its
        ancestors."""
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0 and self.spans[j][1] < t:
            j = self.parent[j]
        return j


def reduce(evs: List[Event]) -> Dict[str, Span]:
    """The spans by name."""
    nest = Nest(evs)
    out: Dict[str, Span] = defaultdict(Span)
    for i, (s, e, n) in enumerate(nest.spans):
        sp = out[n]
        sp.count += 1
        sp.host_s += (e - s) / 1e9
        sp.self_s += (e - s) / 1e9
        p = nest.parent[i]
        if p >= 0:
            _, p_end, p_name = nest.spans[p]
            out[p_name].self_s -= (min(e, p_end) - s) / 1e9
    launch = {e.corr: e.start for e in evs if e.kind == LAUNCH}
    for e in evs:
        if e.on_dev and e.end > e.start and e.corr in launch:
            j = nest.innermost(launch[e.corr])
            if j >= 0:
                out[nest.spans[j][2]].device_s += (e.end - e.start) / 1e9
    return dict(out)


def idle_by_span(evs: List[Event], w0: int, w1: int) -> Dict[str, float]:
    """The device's idle time in ``[w0, w1]`` by the innermost span at
    each gap's middle (``NO_SPAN`` where none holds it)."""
    from portbench.trace import _union
    busy = _union(np.array([(max(e.start, w0), min(e.end, w1)) for e in evs
                            if e.on_dev and e.end > e.start
                            and e.end > w0 and e.start < w1],
                           dtype=np.int64).reshape(-1, 2))
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]])
    nest = Nest(evs)
    out: Dict[str, float] = defaultdict(float)
    for g0, g1 in edges.reshape(-1, 2):
        if g1 > g0:
            j = nest.innermost((g0 + g1) // 2)
            out[nest.spans[j][2] if j >= 0 else NO_SPAN] += (g1 - g0) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def traced_spans(root: Path, workload: str, seed: int, seconds: float,
                 dev) -> dict:
    """Set the cell up, serve an untraced window, trace one; the line."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import harness, trace

    bench = harness.setup(root, workload, seed, dev)
    bench.load.window(seconds)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        bench.sync()
        with record_function(trace.WINDOW_SPAN):
            win = bench.load.window(min(harness.TRACE_SECONDS, seconds))
            bench.sync()
    evs = events(prof)
    tr = trace.reduce([e[:4] for e in evs])
    w0, w1 = next((e.start, e.end) for e in evs
                  if e.name == trace.WINDOW_SPAN and not e.on_dev)
    cover = sum(min(e.end, w1) - max(e.start, w0) for e in evs
                if e.name == "serve" and e.kind == SPAN
                and e.end > w0 and e.start < w1)
    launches = {e.corr for e in evs if e.kind == LAUNCH}
    ops = [e for e in evs if e.on_dev and e.end > e.start]
    reports = [c.report for c in win.calls]
    out = {"workload": workload, "seed": seed,
           "device": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else dev.type,
           "calls": len(reports), "waves": sum(r.waves for r in reports),
           "window_s": tr.window_s, "busy_s": tr.busy_s,
           "serve_cover": cover / (w1 - w0),
           "spans": {n: dataclasses.asdict(s)
                     for n, s in sorted(reduce(evs).items())},
           "idle_gaps": tr.idle_gaps,
           "idle_by_span": idle_by_span(evs, w0, w1),
           "no_host_event_idle_share":
               dict(tr.idle_gaps).get(trace.NO_HOST_EVENT, 0.0)
               / max(tr.window_s - tr.busy_s, 1e-12),
           "joined": sum(e.corr in launches for e in ops) / max(len(ops), 1)}
    if all(hasattr(r, "host_syncs") for r in reports):
        out["host_syncs"] = sum(r.host_syncs for r in reports)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.run import fixed_caches
    fixed_caches(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    _build.library()
    torch.set_num_threads(1)
    print(json.dumps(traced_spans(ROOT, args.workload, args.seed,
                                  args.seconds, torch.device("cuda", 0))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
