"""The traced window's reduction on a synthetic profile: ``trace.reduce``
(busy time, kernel time, device time by name, idle gaps by the
innermost host event) and ``spans.reduce`` (count, host, self and device
time by span name), and the device mirrors of spans left out of both."""
from types import SimpleNamespace as NS

import pytest
from torch.autograd import DeviceType

from portbench import spans, spec, trace

from conftest import REPO

W = trace.WINDOW_SPAN


class FakeEvent:
    """What ``trace._events`` and ``spans.events`` read of a profiler
    event."""

    def __init__(self, name, on_dev, start, end, kind, corr=0):
        self._name, self._start, self._end = name, start, end
        self._dev = DeviceType.CUDA if on_dev else DeviceType.CPU
        self._kind, self._corr = kind, corr

    def name(self):
        return self._name

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._kind in ("user_annotation", "gpu_user_annotation")

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def correlation_id(self):
        return self._corr


class FakeProf:
    def __init__(self, evs):
        class Results:
            def events(self):
                return evs

        class Profiler:
            kineto_results = Results()

        self.profiler = Profiler()


# ns: a window [0, 1000] holding one serve() call [100, 900]
HOST = [
    (W, 0, 1000, "user_annotation", 0),
    ("serve", 100, 900, "user_annotation", 0),
    ("serve.admit", 150, 400, "user_annotation", 0),
    ("aten::sort", 155, 200, "cpu_op", 0),
    ("cudaLaunchKernel", 160, 170, "cuda_runtime", 7),
    ("serve.sync", 300, 380, "user_annotation", 0),
    ("cudaMemcpyAsync", 310, 370, "cuda_runtime", 8),
    ("serve.advance", 450, 800, "user_annotation", 0),
    ("cudaLaunchKernel", 460, 470, "cuda_runtime", 9),
    ("serve.sync", 820, 860, "user_annotation", 0),
]
DEVICE = [
    ("sort_kernel", 180, 280, "kernel", 7),
    ("Memcpy DtoH (Device -> Pageable)", 320, 330, "gpu_memcpy", 8),
    ("scan_kernel", 500, 600, "kernel", 9),
    # an operation with no launch in the trace: in busy time, in no span
    ("orphan_kernel", 610, 640, "kernel", 99),
    # the device's mirrors of the spans: in neither reduction
    ("serve.admit", 180, 330, "gpu_user_annotation", 0),
    (W, 0, 1000, "gpu_user_annotation", 0),
]


@pytest.fixture
def prof():
    return FakeProf([FakeEvent(n, False, *x) for n, *x in HOST]
                    + [FakeEvent(n, True, *x) for n, *x in DEVICE])


def test_trace_reduce_on_a_synthetic_window(prof):
    evs = trace._events(prof)
    assert evs == [e[:4] for e in spans.events(prof)]
    tr = trace.reduce(evs)
    assert tr.window_s == pytest.approx(1000e-9)
    # the mirrors' 150 and 1000 ns are not busy time
    assert tr.busy_s == pytest.approx((100 + 10 + 100 + 30) * 1e-9)
    assert tr.kernel_s == pytest.approx(230e-9)
    assert tr.kernel_by_name == pytest.approx(
        {"sort_kernel": 100e-9, "scan_kernel": 100e-9,
         "orphan_kernel": 30e-9})
    assert [n for n, _ in tr.device_ops] == [
        "sort_kernel", "scan_kernel", "orphan_kernel",
        "Memcpy DtoH (Device -> Pageable)"]
    # gaps: [0, 180] (mid 90, before the call), [280, 320] (mid 300, the
    # read), [330, 500] (mid 415, serve between its phases), [600, 610]
    # (mid 605, advance), [640, 1000] (mid 820, the second read)
    assert dict(tr.idle_gaps) == pytest.approx({
        trace.NO_HOST_EVENT: 180e-9, "serve.sync": (40 + 360) * 1e-9,
        "serve": 170e-9, "serve.advance": 10e-9})


def test_spans_reduce_on_a_synthetic_window(prof):
    got = spans.reduce(spans.events(prof))
    ns = 1e-9
    want = {
        "serve": spans.Span(1, 800 * ns, (800 - 250 - 350 - 40) * ns, 0),
        "serve.admit": spans.Span(1, 250 * ns, 170 * ns, 100 * ns),
        "serve.sync": spans.Span(2, 120 * ns, 120 * ns, 10 * ns),
        "serve.advance": spans.Span(1, 350 * ns, 350 * ns, 100 * ns),
    }
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert g.count == w.count, name
        assert (g.host_s, g.self_s, g.device_s) == pytest.approx(
            (w.host_s, w.self_s, w.device_s), abs=1e-15), name


def test_a_launch_between_spans_goes_to_their_parent():
    """A launch after a child span ended counts for the parent; one
    outside every span for none."""
    S, L, O = spans.SPAN, spans.LAUNCH, spans.OTHER
    evs = [spans.Event(*x) for x in [
        ("serve", False, 0, 100, S, 0),
        ("serve.admit", False, 10, 20, S, 0),
        ("serve.sync", False, 12, 15, S, 0),
        ("cudaLaunchKernel", False, 17, 18, L, 1),
        ("cudaLaunchKernel", False, 30, 31, L, 2),
        ("cuLaunchKernel", False, 120, 121, L, 3),
        ("k1", True, 40, 45, O, 1),
        ("k2", True, 50, 60, O, 2),
        ("k3", True, 130, 160, O, 3),
    ]]
    got = spans.reduce(evs)
    assert got["serve.admit"].device_s == pytest.approx(5e-9)
    assert got["serve"].device_s == pytest.approx(10e-9)
    assert got["serve.sync"].device_s == 0
    assert got["serve.admit"].self_s == pytest.approx(7e-9)


def test_idle_by_span_names_the_phase_behind_each_gap(prof):
    evs = spans.events(prof)
    assert spans.idle_by_span(evs, 0, 1000) == pytest.approx({
        spans.NO_SPAN: 180e-9, "serve.sync": 400e-9, "serve": 170e-9,
        "serve.advance": 10e-9})


def test_idle_by_span_past_many_host_events():
    """A gap deep inside a span with more host events before it than
    ``trace.reduce`` scans back: no host event there, the span here."""
    S, O = spans.SPAN, spans.OTHER
    evs = [spans.Event(W, False, 0, 10_000, S, 0),
           spans.Event("serve.advance", False, 0, 10_000, S, 0)]
    evs += [spans.Event("aten::where", False, 10 + 20 * i, 15 + 20 * i, O, 0)
            for i in range(trace.LOOKBACK + 44)]
    evs += [spans.Event("k", True, 0, 9_000, O, 0),
            spans.Event("k", True, 9_500, 10_000, O, 0)]
    assert dict(trace.reduce([e[:4] for e in evs]).idle_gaps) \
        == pytest.approx({trace.NO_HOST_EVENT: 500e-9})
    assert spans.idle_by_span(evs, 0, 10_000) \
        == pytest.approx({"serve.advance": 500e-9})


@pytest.mark.parametrize("name,want", [
    ("host_syncs_per_wave.bulk", (40 + 23) / (10 + 5)),
    ("sync_wait_ms.bulk", (30.0 + 12.0) / (10 + 5)),
    ("loop_host_ms.bulk", (150.0 - 30.0 - 12.0) / (10 + 5)),
])
def test_host_read_metrics(name, want):
    """Read from the window's reports where the trace saw a device;
    nothing from a program without the counters or from a CPU run."""
    read = spec.reader(REPO, name)
    reports = [NS(waves=10, host_syncs=40, sync_wait_ms=30.0),
               NS(waves=5, host_syncs=23, sync_wait_ms=12.0)]

    def run(reports, busy_s=0.5):
        return NS(loop="closed", trace=NS(busy_s=busy_s),
                  window=NS(seconds=0.150,
                            calls=[NS(report=r) for r in reports]))

    assert read(run(reports)) == pytest.approx(want)
    assert read(run([NS(waves=10), NS(waves=5)])) is None
    assert read(run(reports, busy_s=0.0)) is None
