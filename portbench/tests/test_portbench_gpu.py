"""On the card: every cell of ``BENCHMARK.json`` runs a short window
with ``correct`` true, and the control (the reference in TF32) fails the
limits at the cell's own size on three seeds while the program passes.

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
