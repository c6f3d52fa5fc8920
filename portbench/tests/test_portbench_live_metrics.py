"""The live cell's per-layer readers (``merge_ms.live``,
``hook_ms_per_wave.live``, ``serve_wave_ms.live``) on the tiny cells'
windows: numbers on ``t-live``, which add up to the window's wall time,
and nothing on ``t-bulk``, from a program without ``ServeReport.hook_ms``
or from a trace with no device operation."""
import dataclasses
import types

import pytest
import torch

from portbench import harness, spec, trace

LIVE = ("merge_ms.live", "hook_ms_per_wave.live", "serve_wave_ms.live")


def _run(root, workload, busy_s):
    """A window of ``workload`` on the CPU as the readers see it, its
    trace standing in for one whose device was busy ``busy_s``."""
    bench = harness.setup(root, workload, 2**31 + 91, torch.device("cpu"))
    win = bench.load.window(0.5)
    bench.release()
    tr = trace.Trace(window_s=1.0, busy_s=busy_s, kernel_s=busy_s,
                     kernel_by_name={}, device_ops=[], idle_gaps=[])
    return harness.Run("closed", 0.0, win, trace=tr)


def _read(root, run):
    return {m: spec.reader(root, m)(run) for m in LIVE}


@pytest.fixture
def live_run(tiny_root):
    return _run(tiny_root, "t-live", 0.5)


def test_live_readers_add_up_to_the_window(tiny_root, live_run):
    got = _read(tiny_root, live_run)
    assert all(v is not None and v > 0 for v in got.values()), got
    calls = live_run.window.calls
    waves = sum(c.report.waves for c in calls)
    merges = sum(c.mutations["merges"] + c.mutations["forced_merges"]
                 for c in calls)
    assert merges > 0
    whole = (got["serve_wave_ms.live"] * waves
             + got["hook_ms_per_wave.live"] * waves
             + got["merge_ms.live"] * merges)
    assert whole == pytest.approx(1e3 * live_run.window.seconds, rel=1e-9)


@pytest.mark.parametrize("case", ["bulk", "no_device", "no_counter",
                                  "no_merge"])
def test_live_readers_read_nothing_without_their_inputs(tiny_root,
                                                        live_run, case):
    if case == "bulk":
        run = _run(tiny_root, "t-bulk", 0.5)
        assert all(c.report.hook_ms == 0.0 for c in run.window.calls)
    elif case == "no_device":
        run = dataclasses.replace(live_run, trace=dataclasses.replace(
            live_run.trace, busy_s=0.0))
    elif case == "no_counter":
        # a program whose ServeReport has no hook_ms
        calls = [dataclasses.replace(c, report=types.SimpleNamespace(
            **{k: v for k, v in vars(c.report).items() if k != "hook_ms"}))
            for c in live_run.window.calls]
        run = dataclasses.replace(live_run, window=dataclasses.replace(
            live_run.window, calls=calls))
    else:
        calls = [dataclasses.replace(c, mutations=dict(
            c.mutations, merges=0, forced_merges=0, merge_ms=0.0))
            for c in live_run.window.calls]
        run = dataclasses.replace(live_run, window=dataclasses.replace(
            live_run.window, calls=calls))
    got = _read(tiny_root, run)
    if case == "no_counter":
        assert got["hook_ms_per_wave.live"] is None
        assert got["serve_wave_ms.live"] is None
        assert got["merge_ms.live"] is not None
    elif case == "no_merge":
        assert got["merge_ms.live"] is None
        assert got["hook_ms_per_wave.live"] is not None
    else:
        assert all(v is None for v in got.values()), got


def test_star_live_names_the_live_readers():
    from conftest import REPO
    cell = spec.cell(REPO, "star-live")
    assert [m["name"] for m in cell.end_to_end] == ["qps", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == list(LIVE)
    assert cell.traffic["mutations"]["adds_per_wave"] == 64
    assert cell.config["live"] == {"delta_cap": 32768, "merge_every": 128}
    assert spec.problems(REPO) == []
