"""A tiny cell end to end on the CPU: the harness's whole run but the
look for a card, and the contract's last line."""
import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness

from conftest import REPO

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload,traced,want", [
    ("t-bulk", False, {"qps", "setup_s"}),
    ("t-bulk", True, {"wave_ms.bulk", "slot_use_pct.bulk",
                      "probes_per_query.bulk"}),
    ("t-live", False, {"qps", "setup_s"}),
    ("t-live", True, {"wave_ms.bulk", "slot_use_pct.bulk",
                      "probes_per_query.bulk"}),
])
def test_tiny_cell_prints_the_result_line(tiny_root, capsys, workload,
                                          traced, want):
    out = harness.run(tiny_root, workload, 2**31 + 77, 0.5, traced,
                      torch.device("cpu"), time.perf_counter())
    print(json.dumps(out))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    # a CPU run writes no device metric (no roofline, no idle share)
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert ("breakdown" in line) == traced
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_same_seed_same_inputs(tiny_root):
    from portbench import corpus, spec
    cfg = spec.cell(tiny_root, "t-bulk").config
    a = corpus.checksum(corpus.make(cfg, 256, 2**31 + 5, "cpu"))
    b = corpus.checksum(corpus.make(cfg, 256, 2**31 + 5, "cpu"))
    c = corpus.checksum(corpus.make(cfg, 256, 2**31 + 6, "cpu"))
    assert a == b and a != c


def test_layout_is_build_index_s(tiny_root):
    """Lists start at multiples of align, hold at most list_pad live
    rows, sizes sum to n_docs, ids are a permutation, gap rows -1."""
    from portbench import corpus, spec
    cfg = spec.cell(tiny_root, "t-bulk").config
    c = corpus.make(cfg, 64, 3, "cpu")
    offs, sizes = c.offsets.long(), c.sizes.long()
    assert (offs % cfg["align"] == 0).all()
    assert int(sizes.sum()) == cfg["n_docs"] and int(sizes.max()) <= 64
    assert sorted(c.doc_ids[c.doc_ids >= 0].tolist()) \
        == list(range(cfg["n_docs"]))
    assert (c.doc_ids[c.id_rows] == torch.arange(cfg["n_docs"])).all()
    norms = c.docs[c.id_rows].norm(dim=1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)
    assert int(offs[-1]) + cfg["list_pad"] <= c.docs.shape[0]


def test_run_exits_without_a_card_and_prints_nothing(tmp_path):
    """Without CUDA (this machine) run.py exits non-zero with no result;
    so does a directory holding only BENCHMARK.json and portbench/."""
    import shutil
    bare = tmp_path / "bare"
    shutil.copytree(REPO / "portbench", bare / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", bare / "BENCHMARK.json")
    for root in (REPO, bare):
        p = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", "star-bulk",
             "--seed", "1", "--seconds", "1", "--trace", "0"],
            cwd=root, capture_output=True, text=True, timeout=300)
        assert p.returncode != 0 and p.stdout == ""


def test_live_setup_leaves_the_documents_to_the_program(tiny_root):
    """A live cell's harness keeps no handle on the documents once the
    program holds them; its check makes them again from the seed."""
    bench = harness.setup(tiny_root, "t-live", 2**31 + 78,
                          torch.device("cpu"))
    kept = bench.corpus
    assert kept.docs is None and kept.doc_ids is None \
        and kept.id_rows is None
    assert bench.stream.merges() >= 1          # warm-up merged once
    win = bench.load.window(0.2)
    assert all(c.mutations["waves"] == c.report.waves for c in win.calls)
    bench.release()
    assert bench.stream.live is None
    res = harness.check(bench, win.calls, 2**31 + 78)["program"]
    assert res["inputs_changed"] == 0 and bench.corpus.docs is not None
