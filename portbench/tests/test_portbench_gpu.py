"""On the card: every cell of ``BENCHMARK.json`` runs a short window
with ``correct`` true, and the control (the reference in TF32) fails the
limits at the cell's own size on three seeds while the program passes;
and the cascade reference against the program's fused ``search`` under
``cascade_patience``, with the benchmark's trees, at a mid size.

    python -m pytest -m gpu portbench/tests/test_portbench_gpu.py
"""
import json
import subprocess
import sys

import pytest

from conftest import REPO

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def cells():
    return [w["name"] for w in
            json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("workload", cells())
def test_cell_runs_correct(card, workload):
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(2**31 + 3), "--seconds", "3", "--trace", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] < line["device"]["window_s"]


@pytest.mark.parametrize("workload", cells())
def test_control_fails_at_the_cell_size(card, workload):
    from portbench import spec
    limits = spec.cell(REPO, workload).config["check"]["limits"]
    p = subprocess.run(
        [sys.executable, "portbench/readings.py", "--workload", workload,
         "--seconds", "2", "--seeds", "11", "12", "13"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    rows = [json.loads(x) for x in p.stdout.splitlines() if x.startswith("{")]
    assert len(rows) == 3
    for r in rows:
        lims = {n: v for n, v in limits.items() if n in r["control"]}
        assert any(r["control"][n] > v for n, v in lims.items()), r
        assert all(r["program"][n] <= v for n, v in limits.items()), r


# msmarco-star's layout and exits at 500,000 x 128 in 4,096 lists, with
# the cascade of a policy block
MID_CASCADE = {
    "name": "mid-cascade", "n_docs": 500000, "dim": 128,
    "metric": "inner_product", "n_lists": 4096, "list_pad": 256,
    "align": 64, "n_probe": 40, "k": 100, "patience_delta": 7,
    "patience_phi": 95.0, "wave_size": 1024, "chunk": 8,
    "corpus": {"spread_at_64": 0.25, "scale_range": [0.5, 1.5],
               "list_size_sigma": 0.35, "list_size_min": 1},
    "queries": {"hard_frac": 0.35, "easy_noise": 0.15},
    "reference": "portbench/reference/ivf_cascade.py",
    "policy": {"kind": "cascade_patience", "tau": 10, "clf_threshold": 0.5,
               "exit_weight": 3.0,
               "train": {"queries": 2048, "valid": 512, "n_trees": 100,
                         "max_depth": 6, "n_bins": 64}},
    "check": {"sample": 4096, "longest": 256, "gap_tol": 1e-05,
              "tie_tol": 1e-06, "tree_tol": 1e-05,
              "limits": {"missing": 0, "inputs_changed": 0, "invalid": 0,
                         "exit_mismatch_pct": 0.2, "gap_share_pct": 0.45}}}


def test_cascade_search_matches_reference(card, tmp_path):
    cfg = tmp_path / "mid-cascade.json"
    cfg.write_text(json.dumps(MID_CASCADE))
    p = subprocess.run(
        [sys.executable, "portbench/cascade_readings.py", "--config",
         str(cfg), "--traffic", "msmarco-dev-small", "--queries", "4096",
         "--seeds", str(2**31 + 5)],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.splitlines()[0])
    assert r["queries"] == 4096
    assert r["program"]["invalid"] == 0
    assert r["program"]["exit_mismatch_pct"] == 0.0, r
    assert r["program"]["gap_share_pct"] <= 0.45, r
    assert 0 < r["program"]["clf_exit_pct"] < 100, r
