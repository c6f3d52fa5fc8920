"""A tiny benchmark root for the CPU tests: ``BENCHMARK.json`` with a
closed-loop cell over a tiny configuration and a live cell (the same
corpus under a mutation stream), beside the repository's own metric
readers."""
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (REPO, REPO / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

TINY = {
    "name": "tiny", "n_docs": 3000, "dim": 32, "metric": "inner_product",
    "n_lists": 64, "list_pad": 64, "align": 64, "n_probe": 16, "k": 10,
    "patience_delta": 3, "patience_phi": 90.0, "wave_size": 16, "chunk": 4,
    "corpus": {"spread_at_64": 0.08, "scale_range": [0.5, 1.5],
               "list_size_sigma": 0.35, "list_size_min": 1},
    "queries": {"hard_frac": 0.35, "easy_noise": 0.15},
    "reference": "portbench/reference/ivf_patience.py",
    "check": {"sample": 4096, "longest": 32, "gap_tol": 1e-5,
              "tie_tol": 1e-6,
              "limits": {"missing": 0, "inputs_changed": 0, "invalid": 0,
                         "exit_mismatch_pct": 0.25,
                         "gap_share_pct": 0.2}}}
TINY_LIVE = dict(
    TINY, name="tiny-live", chunk=1,
    live={"delta_cap": 256, "merge_every": 8},
    reference="portbench/reference/ivf_live.py",
    check=dict(TINY["check"], limits=dict(
        TINY["check"]["limits"], deleted_returned=0, acked_add_missed=0,
        schedule_mismatch=0)))
TRAFFIC = {
    "t-closed": {"loop": "closed", "call_queries": 64, "pool": 256,
                 "warmup": [64]},
    "t-live": {"loop": "closed", "call_queries": 64, "pool": 256,
               "warmup": [64],
               "mutations": {"adds_per_wave": 3, "deletes_per_wave": 4,
                             "plants_per_wave": 1, "source": "a test"}}}


def make_root(root: Path) -> Path:
    """A benchmark root at ``root`` with the tiny cells ``t-bulk`` and
    ``t-live`` and the repository's metric readers."""
    (root / "portbench" / "configs").mkdir(parents=True)
    (root / "portbench" / "traffic").mkdir()
    shutil.copytree(REPO / "portbench" / "metrics",
                    root / "portbench" / "metrics")
    for cfg in (TINY, TINY_LIVE):
        (root / "portbench" / "configs" / f"{cfg['name']}.json").write_text(
            json.dumps(cfg))
    for name, mix in TRAFFIC.items():
        (root / "portbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": cfg["name"], "source": "a test",
                         "file": f"portbench/configs/{cfg['name']}.json",
                         "reduced": [], "why": "a test"}
                        for cfg in (TINY, TINY_LIVE)]
    bench["workloads"] = [
        {"name": "t-bulk", "config": "tiny", "traffic": "t-closed",
         "chips": 1, "why": "closed loop"},
        {"name": "t-live", "config": "tiny-live", "traffic": "t-live",
         "chips": 1, "why": "closed loop under a mutation stream"}]
    cells = ["t-bulk", "t-live"]
    bench["end_to_end"] = [m for m in bench["end_to_end"]
                           if m["name"] == "setup_s"] + [
        {"name": "qps", "unit": "queries/s", "better": "higher",
         "bound": 0.25, "source": "host_clock", "workloads": cells}]
    bench["per_layer"] = [dict(m, workloads=cells)
                          for m in bench["per_layer"] if m["moves"] == "qps"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture
def one_thread():
    """Torch on one intra-op thread, as ``run.py`` sets it: beside other
    test processes the default pool's spin-waits slow a window's serve
    calls many times over."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_root(tmp_path, one_thread) -> Path:
    return make_root(tmp_path / "root")
