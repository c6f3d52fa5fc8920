"""``BENCHMARK.json`` against the harness's rules, and a configuration,
a traffic mix and a metric added as files only."""
import json
import time

import torch

from portbench import harness, spec

from conftest import REPO


def test_benchmark_json_keeps_the_rules():
    assert spec.problems(REPO) == []


def test_names_units_and_moves():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics:
        assert spec.NAME.match(m["name"]) and spec.UNIT.match(m["unit"])
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for c in m.get("workloads", cells):
            assert c in moved.get("workloads", cells), (m["name"], c)
    for w in bench["workloads"]:
        assert w["chips"] == 1


def test_problems_are_found(tmp_path):
    from conftest import make_root
    root = make_root(tmp_path / "r")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    # an end-to-end metric that t-bulk does not report
    bench["end_to_end"].append({"name": "p95_ms", "unit": "ms",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock", "workloads": []})
    bench["per_layer"][0]["moves"] = "p95_ms"
    bench["end_to_end"][0]["unit"] = "queries per s"
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    found = " ".join(spec.problems(root))
    assert "does not report p95_ms" in found and "bad unit" in found


def test_files_added_are_found_by_name(tiny_root, tmp_path):
    """A new configuration, traffic mix and per-layer metric are three
    new files and entries in BENCHMARK.json; no other file changes."""
    before = {p: p.read_bytes() for p in (tiny_root / "portbench").rglob("*")
              if p.is_file()}
    cfg = json.loads((tiny_root / "portbench" / "configs"
                      / "tiny.json").read_text())
    (tiny_root / "portbench" / "configs" / "tiny-wide.json").write_text(
        json.dumps(dict(cfg, name="tiny-wide", dim=48)))
    (tiny_root / "portbench" / "traffic" / "t-small.json").write_text(
        json.dumps({"loop": "closed", "call_queries": 32, "pool": 128,
                    "warmup": [32]}))
    (tiny_root / "portbench" / "metrics" / "calls.bulk.py").write_text(
        '"""Serve calls in the window."""\n\n\n'
        "def read(run):\n    return float(len(run.window.calls))\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-wide", "source": "a test",
                             "file": "portbench/configs/tiny-wide.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "t-wide", "config": "tiny-wide",
                               "traffic": "t-small", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "qps":
            m["workloads"].append("t-wide")
    bench["per_layer"].append({
        "name": "calls.bulk", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "front end", "moves": "qps",
        "workloads": ["t-wide"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert spec.problems(tiny_root) == []
    out = harness.run(tiny_root, "t-wide", 31, 0.3, True,
                      torch.device("cpu"), time.perf_counter())
    assert out["correct"] is True
    assert out["metrics"]["calls.bulk"]["value"] >= 1
    for p, data in before.items():
        assert p.read_bytes() == data
