"""The 4,096-d deployment ``nq-e5-mistral`` and its cell ``nq-bulk``:
the configuration and ``BENCHMARK.json`` under the harness's rules, the
corpus's size at this configuration, and the reader of
``staged_scan_pct.wide``."""
import json
import types

import pytest
import torch

from portbench import corpus, spec

from conftest import REPO

CONFIG = REPO / "portbench" / "configs" / "nq-e5-mistral.json"
# 64-row aligned rows of the lognormal list sizes, the reckoning that
# the configuration's ``assumed`` gives (51.6 GB of rows and ids)
ROWS = 3.15e6


def test_config_keeps_the_rules():
    cfg = json.loads(CONFIG.read_text())
    assert spec.config_problems(cfg) == []
    assert (cfg["n_docs"], cfg["dim"], cfg["n_lists"], cfg["k"],
            cfg["n_probe"]) == (2_681_468, 4096, 16_384, 100, 80)
    star = json.loads((REPO / "portbench" / "configs"
                       / "msmarco-star.json").read_text())
    for key in ("corpus", "queries", "wave_size", "chunk", "list_pad",
                "align", "patience_delta", "patience_phi", "reference"):
        assert cfg[key] == star[key], key


def test_benchmark_json_holds_the_cell():
    assert spec.problems(REPO) == []
    cell = spec.cell(REPO, "nq-bulk")
    assert cell.chips == 1 and cell.config["name"] == "nq-e5-mistral"
    assert cell.traffic["call_queries"] == cell.traffic["pool"] == 3452
    ends = {m["name"] for m in cell.end_to_end}
    layers = {m["name"] for m in cell.per_layer}
    assert ends == {"qps", "setup_s"}
    assert {m for m in layers if m.endswith(".bulk")} == {
        "wave_ms.bulk", "slot_use_pct.bulk", "probes_per_query.bulk",
        "ivf_scan_merge_roofline.bulk", "kernels_roofline.bulk",
        "device_idle_pct.bulk", "host_syncs_per_wave.bulk",
        "sync_wait_ms.bulk", "loop_host_ms.bulk"}
    assert "staged_scan_pct.wide" in layers
    for other in ("star-bulk", "deep-bulk", "star-live", "star-cascade"):
        assert "staged_scan_pct.wide" not in {
            m["name"] for m in spec.cell(REPO, other).per_layer}


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 3537000101])
def test_list_sizes_fill_the_reckoned_rows(seed):
    """The seeded sizes sum to the documents, lie in [1, 256], and their
    64-row aligned layout is within 2% of the reckoned rows."""
    cfg = json.loads(CONFIG.read_text())
    g = torch.Generator()
    g.manual_seed(seed)
    sizes = corpus.list_sizes(cfg, g, "cpu")
    assert int(sizes.sum()) == cfg["n_docs"]
    assert int(sizes.min()) >= 1 and int(sizes.max()) <= cfg["list_pad"]
    align = cfg["align"]
    rows = int(((sizes + align - 1) // align * align).sum()) \
        + cfg["list_pad"]
    assert abs(rows - ROWS) / ROWS < 0.02
    assert rows * (4 * cfg["dim"] + 4) < 60e9


def _run(reports, busy_s=1.0, traced=True):
    calls = [types.SimpleNamespace(report=r) for r in reports]
    return types.SimpleNamespace(
        loop="closed", window=types.SimpleNamespace(calls=calls),
        trace=types.SimpleNamespace(busy_s=busy_s) if traced else None)


def test_staged_scan_reader():
    """100 x ring launches over waves; nothing from reports without the
    counter (a program that predates it), without a device trace, or
    from a trace that saw no device."""
    read = spec.reader(REPO, "staged_scan_pct.wide")
    rep = types.SimpleNamespace
    assert read(_run([rep(waves=4, ring_launches=4),
                      rep(waves=6, ring_launches=3)])) == 70.0
    assert read(_run([rep(waves=4), rep(waves=6)])) is None
    assert read(_run([rep(waves=4, ring_launches=4),
                      rep(waves=6)])) is None
    assert read(_run([rep(waves=4, ring_launches=4)], traced=False)) is None
    assert read(_run([rep(waves=4, ring_launches=4)], busy_s=0.0)) is None
